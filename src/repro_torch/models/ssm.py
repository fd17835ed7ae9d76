"""Mamba2 (SSD) blocks: the zamba2 hybrid backbone.

Counterpart of the reference's ``models/ssm.py`` for decode: the weights,
the decode cache and the single-token step, an O(1) update of the
``(H, N, P)`` state per request.  Single group (B and C shared across
heads), a per-head scalar decay A, as in the reference.  The full-sequence
``mamba2`` (the chunked SSD and the causal conv) serves the forward and is
not ported yet (``ROADMAP.md``, queue 1).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import layers


def init_mamba2(gen, d_model: int, state: int, conv: int, expand: int,
                head_dim: int, dtype, device, lead: tuple = ()) -> dict:
    """Mamba2 weights; ``lead`` prepends axes (a stack of layers).  A_log,
    D and dt_bias stay float32, as in the reference."""
    d_in = expand * d_model
    H = d_in // head_dim
    in_dim = 2 * d_in + 2 * state + H
    f32 = lambda fill: torch.full(lead + (H,), fill, dtype=torch.float32,
                                  device=device)
    return {
        "w_in": layers._normal(gen, lead + (d_model, in_dim),
                               1.0 / math.sqrt(d_model), dtype, device),
        "conv_w": layers._normal(gen, lead + (conv, d_in + 2 * state), 0.1,
                                 dtype, device),
        "conv_b": torch.zeros(lead + (d_in + 2 * state,), dtype=dtype,
                              device=device),
        "A_log": f32(0.0),                           # A = -exp(A_log) = -1
        "D": f32(1.0),
        "dt_bias": f32(math.log(math.e - 1)),        # softplus -> 1
        "norm_w": torch.zeros(lead + (d_in,), dtype=dtype, device=device),
        "w_out": layers._normal(gen, lead + (d_in, d_model),
                                1.0 / math.sqrt(d_in), dtype, device),
    }


class SSMCache(NamedTuple):
    state: torch.Tensor       # (B, H, N, P) fp32: the SSD state
    conv_buf: torch.Tensor    # (B, K-1, C): the causal conv's tail


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` with no threshold (torch's
    ``F.softplus`` returns x itself past 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def mamba2_decode_step(params, x, cache: SSMCache, *, state: int, expand: int,
                       head_dim: int, norm_eps: float = 1e-6):
    """Single-token decode: x (B, 1, d) → (out (B, 1, d), new SSMCache)."""
    B, _, d = x.shape
    d_in = expand * d
    H = d_in // head_dim
    proj = x[:, 0] @ params["w_in"]
    z, xr, Bm, Cm, dt_raw = torch.split(
        proj, [d_in, d_in, state, state, H], dim=-1)
    xbc_raw = torch.cat([xr, Bm, Cm], dim=-1)               # (B, C) pre-conv
    window = torch.cat([cache.conv_buf, xbc_raw[:, None, :]], dim=1)  # (B,K,C)
    conv = (window * params["conv_w"][None]).sum(dim=1) + params["conv_b"]
    xbc = F.silu(conv)
    xr, Bm, Cm = torch.split(xbc, [d_in, state, state], dim=-1)
    dt = softplus(dt_raw.float() + params["dt_bias"])       # (B, H)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A)                                   # (B, H)
    xh = xr.reshape(B, H, head_dim).float()
    s = cache.state * a[:, :, None, None] + torch.einsum(
        "bn,bhp->bhnp", Bm.float(), xh * dt[..., None])
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), s)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(B, d_in).to(x.dtype)
    y = layers.rms_norm(y * F.silu(z), params["norm_w"], norm_eps)
    out = (y @ params["w_out"])[:, None, :]
    new_tail = torch.cat([cache.conv_buf[:, 1:], xbc_raw[:, None]], dim=1)
    return out, SSMCache(state=s, conv_buf=new_tail)
