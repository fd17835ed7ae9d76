"""CUDA kernel: SRP hashing, projection to codes in one launch
(``csrc/srp_hash.cu``).

Replaces the reference's Pallas ``srp_hash`` (``kernels/srp_hash.py``): a
3xTF32 tensor-core GEMM whose epilogue takes the sign bits and the uint32
fold.
See the source note for the bound and the design.
"""
from __future__ import annotations

import torch

from . import _build

MAX_K = 96              # kTileN in csrc/srp_hash.cu: whole hash rows per block


def srp_hash(x: torch.Tensor, proj: torch.Tensor, mix: torch.Tensor,
             n_buckets: int) -> torch.Tensor:
    """``x (B, d) f32``, ``proj (d, L*k) f32``, ``mix (L, k) int64`` holding
    uint32 values → codes ``(B, L) int32`` in [0, n_buckets)."""
    B, d = x.shape
    L, k = mix.shape
    _build.check("srp_hash x", x, torch.float32, (B, d))
    _build.check("srp_hash proj", proj, torch.float32, (d, L * k),
                 device=x.device)
    _build.check("srp_hash mix", mix, torch.int64, (L, k), device=x.device)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"srp_hash: need 1 <= k <= {MAX_K}, got k={k}")
    if not 1 <= n_buckets < 2**31:
        raise ValueError(f"srp_hash: n_buckets {n_buckets} out of range")
    out = torch.empty((B, L), dtype=torch.int32, device=x.device)
    if B and L:
        _build.launch("srp_hash", "srp_hash_launch", x, proj, mix, out,
                      B, d, L, k, n_buckets)
    return out
