"""Kernel dispatch policy — the single source of truth.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain PyTorch version in `ref`.  There is no switch that sends a CUDA
tensor to the plain version and no fallback when a kernel fails: a kernel
that does not build or launch raises.
"""
from __future__ import annotations

import torch


def use_kernel(x: torch.Tensor) -> bool:
    """Route through the CUDA kernel (vs the plain version)?"""
    return x.is_cuda
