"""CUDA kernel: fused masked squared-L2 top-k (``csrc/batch_score_topk.cu``).

Replaces the reference's Pallas ``batch_score_topk``
(``kernels/batch_score.py``), which used the MXU matmul identity with a
running top-k across M tiles.  Each query has its own candidates, so there
is no operand reuse for tensor cores; the kernel is diff-based like the
plain version.  See the source note for the bound and the design.
"""
from __future__ import annotations

import torch

from . import _build

MAX_K = 64


def batch_score_topk(qs: torch.Tensor, cands: torch.Tensor, ok: torch.Tensor,
                     k: int):
    """``qs (B, d) f32``, ``cands (B, M, d) f32``, ``ok (B, M) bool`` →
    ``(d2 (B, k) f32 ascending, idx (B, k) int32)``; masked entries score
    inf, ties go to the lowest index, a fully masked row gives inf with idx
    ``0..k-1``.  Needs ``1 <= k <= min(M, 64)``."""
    B, M, d = cands.shape
    _build.check("batch_score_topk qs", qs, torch.float32, (B, d))
    _build.check("batch_score_topk cands", cands, torch.float32, (B, M, d))
    _build.check("batch_score_topk ok", ok, torch.bool, (B, M))
    if not 1 <= k <= min(M, MAX_K):
        raise ValueError(f"batch_score_topk: need 1 <= k <= min(M={M}, "
                         f"{MAX_K}), got k={k}")
    out_d = torch.empty((B, k), dtype=torch.float32, device=qs.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=qs.device)
    if B:
        _build.launch("batch_score_topk", "batch_score_topk_launch",
                      qs, cands, ok, out_d, out_i, B, M, d, k)
    return out_d, out_i
