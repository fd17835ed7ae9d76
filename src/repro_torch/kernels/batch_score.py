"""CUDA kernel: fused masked squared-L2 top-k (``csrc/batch_score_topk.cu``).

Replaces the reference's Pallas ``batch_score_topk``
(``kernels/batch_score.py``), which used the MXU matmul identity with a
running top-k across M tiles.  Each query has its own candidates, so there
is no operand reuse for tensor cores; the kernel is diff-based like the
plain version.  Two entries run the same kernel body:
`batch_score_topk` takes the candidates as a ``(B, M, d)`` tensor (the
reference kernel's signature), `batch_score_topk_gather` takes the point
store and ``(B, M)`` slot ids and reads the rows itself, so the S-ANN
queries never build the ``(B, M, d)`` gather.  Both count their launches
under ``batch_score_topk``.  See the source note for the bound and the
design.
"""
from __future__ import annotations

import torch

from . import _build

MAX_K = 64


def _check_k(name: str, M: int, k: int) -> None:
    if not 1 <= k <= min(M, MAX_K):
        raise ValueError(f"{name}: need 1 <= k <= min(M={M}, {MAX_K}), "
                         f"got k={k}")


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
    _check_k("batch_score_topk", M, k)
    out_d = torch.empty((B, k), dtype=torch.float32, device=qs.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=qs.device)
    if B:
        _build.launch("batch_score_topk", "batch_score_topk_launch",
                      qs, cands, ok, out_d, out_i, B, M, d, k)
    return out_d, out_i


def batch_score_topk_gather(qs: torch.Tensor, points: torch.Tensor,
                            cand: torch.Tensor, ok: torch.Tensor, k: int):
    """``qs (B, d) f32``, ``points (N, d) f32``, ``cand (B, M) int32`` slot
    ids in ``[-1, N)``, ``ok (B, M) bool`` → what
    ``batch_score_topk(qs, points[cand.clamp(min=0)], ok, k)`` returns,
    without building that ``(B, M, d)`` tensor.  Needs
    ``1 <= k <= min(M, 64)`` and ``N >= 1``."""
    B, M = cand.shape
    N, d = points.shape
    _build.check("batch_score_topk_gather qs", qs, torch.float32, (B, d))
    _build.check("batch_score_topk_gather points", points, torch.float32,
                 (N, d))
    _build.check("batch_score_topk_gather cand", cand, torch.int32, (B, M))
    _build.check("batch_score_topk_gather ok", ok, torch.bool, (B, M))
    _check_k("batch_score_topk_gather", M, k)
    if N < 1:
        raise ValueError("batch_score_topk_gather: the point store is empty")
    out_d = torch.empty((B, k), dtype=torch.float32, device=qs.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=qs.device)
    if B:
        _build.launch("batch_score_topk", "batch_score_topk_gather_launch",
                      qs, points, cand, ok, out_d, out_i, B, M, d, k, N)
    return out_d, out_i
