"""CUDA kernel: RACE histogram (``csrc/race_hist.cu``).

Replaces the reference's Pallas ``race_hist`` (``kernels/race_update.py``),
a one-hot compare-reduce over a revisited row block.  See the source note in
``csrc/race_hist.cu`` for the bound and the design.
"""
from __future__ import annotations

import torch

from . import _build


def race_hist(codes: torch.Tensor, W: int) -> torch.Tensor:
    """Histogram of ``codes (B, L) int32`` per row → ``(L, W) int32``,
    ``out[l, w] = #{b : codes[b, l] = w}`` (codes outside [0, W) ignored).
    The output is zero-filled here and the kernel adds into it."""
    _build.check("race_hist codes", codes, torch.int32, (None, None))
    B, L = codes.shape
    out = torch.zeros((L, W), dtype=torch.int32, device=codes.device)
    if B and L and W:
        _build.launch("race_hist", "race_hist_launch", codes, out, B, L, W)
    return out
