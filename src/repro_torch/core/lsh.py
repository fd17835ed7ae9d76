"""Locality-sensitive hash families (paper §2.1) on PyTorch tensors.

The two families of the reference: SRP (angular) [Cha02] and p-stable
Euclidean [DIIM04], each a concatenation of k hashes folded to
``n_buckets`` by a multiply-shift universal hash.

Numerics (kept equal to the reference):

* the fold wraps mod 2^32 in the reference's uint32 arithmetic; here it
  runs in int64, split into 16-bit halves so no product overflows, and is
  masked to 32 bits after every multiply and after the sum
  (`kernels.ref.fold`);
* SRP hashing is the `srp_hash` kernel on the card (projection, sign and
  fold in one launch) and its plain version (one fp32 matmul) on the CPU;
* the p-stable code is ``floor((x @ proj + bias) * (1/w))`` with ``1/w``
  the fp32 reciprocal (`fp32_reciprocal`), one multiply on every device:
  the reference writes ``/ w`` with ``w`` static, and under ``jit`` (how
  its services and tests run it) XLA computes exactly that product.  A code can then differ from
  the reference's only where the two frameworks' fp32 ``x @ proj`` sums
  differ.  Matmuls must run in full fp32: callers on the card keep
  ``torch.backends.cuda.matmul.allow_tf32`` False.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .util import resolve_device
from ..kernels import ops as kernel_ops
from ..kernels.ref import fold


class SRPParams(NamedTuple):
    """L independent concatenations of k signed-random-projection bits."""
    proj: torch.Tensor   # (d, L*k) float32 — N(0,1) projections
    mix: torch.Tensor    # (L, k) int64 holding the reference's odd uint32s
    L: int
    k: int
    n_buckets: int


class PStableParams(NamedTuple):
    """L independent concatenations of k p-stable (Euclidean) hashes."""
    proj: torch.Tensor   # (d, L*k) float32 — N(0,1)
    bias: torch.Tensor   # (L*k,) float32 — U[0, w)
    mix: torch.Tensor    # (L, k) int64 holding odd uint32 values
    w: float
    L: int
    k: int
    n_buckets: int


def _draw_mix(generator: torch.Generator, L: int, k: int) -> torch.Tensor:
    mix = torch.randint(1, 2**31 - 1, (L, k), generator=generator,
                        device=generator.device, dtype=torch.int64)
    return mix * 2 + 1                                  # odd multipliers


def init_srp(generator: torch.Generator, dim: int, L: int, k: int,
             n_buckets: int, device="cuda") -> SRPParams:
    """Draw SRP params from ``generator`` (on its own device), then place
    them on ``device``.  The numbers differ from the reference's threefry
    draws; parity tests carry the reference's params across instead."""
    device = resolve_device(device)
    proj = torch.randn((dim, L * k), generator=generator,
                       device=generator.device, dtype=torch.float32)
    mix = _draw_mix(generator, L, k)
    return SRPParams(proj=proj.to(device), mix=mix.to(device), L=L, k=k,
                     n_buckets=n_buckets)


def init_pstable(generator: torch.Generator, dim: int, L: int, k: int,
                 w: float, n_buckets: int, device="cuda") -> PStableParams:
    """Draw p-stable params from ``generator``; see `init_srp`."""
    device = resolve_device(device)
    proj = torch.randn((dim, L * k), generator=generator,
                       device=generator.device, dtype=torch.float32)
    bias = torch.rand((L * k,), generator=generator, device=generator.device,
                      dtype=torch.float32) * w
    mix = _draw_mix(generator, L, k)
    return PStableParams(proj=proj.to(device), bias=bias.to(device),
                         mix=mix.to(device), w=w, L=L, k=k,
                         n_buckets=n_buckets)


def srp_hash(params: SRPParams, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) → bucket ids (..., L) in [0, n_buckets), through
    `kernels.ops.srp_hash` (the CUDA kernel for a CUDA tensor)."""
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    codes = kernel_ops.srp_hash(flat, params.proj, params.mix,
                                params.n_buckets)
    return codes.reshape(*x.shape[:-1], params.L)


def fp32_reciprocal(w: float) -> float:
    """``float32(1) / float32(w)``, as a Python float.  The value is exact in
    fp32, so a float32 tensor times it is one fp32 multiply on every device,
    and as a scalar operand it costs the card no host-to-device copy."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one / torch.tensor(w, dtype=torch.float32))


def pstable_hash(params: PStableParams, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) → bucket ids (..., L) via floor((a.x+b)/w), k per row."""
    y = (x @ params.proj + params.bias) * fp32_reciprocal(params.w)
    h = torch.floor(y).to(torch.int32)
    h = h.reshape(*x.shape[:-1], params.L, params.k)
    return fold(h, params.mix, params.n_buckets)


def hash_points(params, x: torch.Tensor) -> torch.Tensor:
    if isinstance(params, SRPParams):
        return srp_hash(params, x)
    if isinstance(params, PStableParams):
        return pstable_hash(params, x)
    raise TypeError(type(params))


# ---------------------------------------------------------------------------
# Collision probabilities (analysis-side; used by tests and the smoke run)
# ---------------------------------------------------------------------------

def srp_collision_prob(x: torch.Tensor, y: torch.Tensor, p: int = 1):
    """k(x,y)^p for SRP: (1 - theta/pi)^p  [Cha02]."""
    nx = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)
    ny = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True), min=1e-12)
    cos = torch.clamp((nx * ny).sum(-1), -1.0, 1.0)
    theta = torch.arccos(cos)
    return (1.0 - theta / math.pi) ** p


def pstable_collision_prob(dist, w: float, p: int = 1):
    """k(x,y)^p for 2-stable LSH at Euclidean distance ``dist`` [DIIM04]:

        p(s) = 1 - 2*Phi(-w/s) - (2s/(sqrt(2*pi)*w)) * (1 - exp(-w^2/(2 s^2)))
    """
    dist = torch.as_tensor(dist, dtype=torch.float32)
    s = torch.clamp(dist, min=1e-12)
    t = w / s
    phi = 0.5 * (1.0 + torch.erf(-t / math.sqrt(2.0)))
    prob = 1.0 - 2.0 * phi - (2.0 / (math.sqrt(2.0 * math.pi) * t)) * (
        1.0 - torch.exp(-(t**2) / 2.0))
    prob = torch.where(dist <= 0.0, torch.ones_like(prob), prob)
    return torch.clamp(prob, 0.0, 1.0) ** p
