"""CUDA kernel: one query's squared L2 to its candidates (``csrc/cand_score.cu``).

Replaces the reference's Pallas ``cand_score`` (``kernels/cand_score.py``),
which the per-query S-ANN oracles call.  See the source note for the bound
and the design.
"""
from __future__ import annotations

import torch

from . import _build


def cand_score(q: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """``q (d,) f32``, ``cands (M, d) f32`` → squared L2 distances
    ``(M,) f32``, diff-based."""
    M, d = cands.shape
    _build.check("cand_score q", q, torch.float32, (d,))
    _build.check("cand_score cands", cands, torch.float32, (M, d))
    out = torch.empty((M,), dtype=torch.float32, device=cands.device)
    if M:
        _build.launch("cand_score", "cand_score_launch", q, cands, out, M, d)
    return out
