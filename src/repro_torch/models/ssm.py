"""Mamba2 (SSD) blocks: the zamba2 hybrid backbone.

Counterpart of the reference's ``models/ssm.py``: the weights, the
full-sequence mixer ``mamba2`` (the causal conv and the chunked SSD
[arXiv:2405.21060], which serve the forward and training), the decode
cache and the single-token step, an O(1) update of the ``(H, N, P)`` state
per request.  Single group (B and C shared across heads), a per-head scalar
decay A, as in the reference.

The chunked SSD keeps the reference's precision: the decay-weighted score
tensor of a chunk is built in float32, rounded to bfloat16 and contracted
with bfloat16 ``x * dt``; the inter-chunk term and the state update stay
float32.  The intra-chunk terms of all chunks are one batched pass,
rematerialised in the backward (the reference checkpoints each chunk);
only the state recurrence loops over chunks.  The reference's
``REPRO_SSD_NAIVE`` switch (a float32 A/B variant, off by default) is not
ported.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (K, C), b (C,)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):      # K is tiny (4): unrolled adds, as the reference
        out = out + pad[:, i:i + S, :] * w[i][None, None, :]
    return out + b


def _intra(cum, Cc, Bc, xd):
    """The intra-chunk term of every chunk: ``y[q] = sum_{j <= q}
    exp(cum_q - cum_j) (C_q . B_j) xd_j``.  cum (B, nc, Q, H), Cc / Bc
    (B, nc, Q, N), xd (B, nc, Q, H, P), all float32 → (B, nc, Q, H, P).

    The score tensor is rounded to bfloat16 and contracted with bfloat16
    ``xd``, as in the reference.  The mask is applied before the
    exponential (``exp(-inf) = 0``), where the reference masks after it:
    the values are the same, and a masked entry whose exponent overflows
    gives a zero gradient instead of ``0 * inf``."""
    Q = cum.shape[2]
    tril = torch.ones((Q, Q), dtype=torch.bool, device=cum.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Q,Q,H)
    G = torch.exp(diff.masked_fill(~tril[None, None, :, :, None],
                                   float("-inf")))
    scores = torch.einsum("bcqn,bcjn->bcqj", Cc, Bc)
    W = (G * scores[..., None]).to(torch.bfloat16)
    return torch.einsum("bcqjh,bcjhp->bcqhp", W,
                        xd.to(torch.bfloat16)).float()


def _ssd_chunked(xh, Bm, Cm, dt, A, chunk: int):
    """xh (B, S, H, P), Bm / Cm (B, S, N), dt (B, S, H) float32, A (H,)
    negative → (y (B, S, H, P) float32, final state (B, H, N, P) float32).

    The chunk Q is ``chunk`` shrunk to a divisor of S.  The state entering
    chunk c is ``s_c = exp(cum_last_{c-1}) s_{c-1} + U_{c-1}``, where U is a
    chunk's own contribution ``sum_j exp(cum_last - cum_j) B_j xd_j^T``."""
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q
    xc = xh.reshape(Bsz, nc, Q, H, Pd).float()
    Bc = Bm.reshape(Bsz, nc, Q, N).float()
    Cc = Cm.reshape(Bsz, nc, Q, N).float()
    dtc = dt.reshape(Bsz, nc, Q, H)
    cum = torch.cumsum(dtc * A, dim=2)                  # log decay, <= 0
    xd = xc * dtc[..., None]                            # fold dt once
    if torch.is_grad_enabled():
        y_intra = checkpoint(_intra, cum, Cc, Bc, xd, use_reentrant=False)
    else:
        y_intra = _intra(cum, Cc, Bc, xd)
    last = cum[:, :, -1, :]                             # (B, nc, H)
    dec_end = torch.exp(last[:, :, None, :] - cum)      # (B, nc, Q, H)
    U = torch.einsum("bcjn,bcjhp->bchnp", Bc, dec_end[..., None] * xd)
    decay = torch.exp(last)[..., None, None]            # (B, nc, H, 1, 1)
    s = torch.zeros((Bsz, H, N, Pd), dtype=torch.float32, device=xh.device)
    entering = []
    for c in range(nc):
        entering.append(s)
        s = s * decay[:, c] + U[:, c]
    prev = torch.stack(entering, dim=1)                 # (B, nc, H, N, P)
    y_inter = torch.einsum("bcqn,bchnp,bcqh->bcqhp", Cc, prev, torch.exp(cum))
    return (y_intra + y_inter).reshape(Bsz, S, H, Pd), s


def mamba2(params, x, *, state: int, conv: int, expand: int, head_dim: int,
           chunk: int, norm_eps: float = 1e-6):
    """Full-sequence Mamba2 mixer: x (B, S, d) → (out (B, S, d), the final
    `SSMCache`, or None when S < conv - 1)."""
    B, S, d = x.shape
    d_in = expand * d
    H = d_in // head_dim
    proj = x @ params["w_in"]
    z, xr, Bm, Cm, dt_raw = torch.split(
        proj, [d_in, d_in, state, state, H], dim=-1)
    xbc_raw = torch.cat([xr, Bm, Cm], dim=-1)
    xbc = F.silu(_causal_conv1d(xbc_raw, params["conv_w"], params["conv_b"]))
    xr, Bm, Cm = torch.split(xbc, [d_in, state, state], dim=-1)
    dt = softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xr.reshape(B, S, H, head_dim)
    y, s_final = _ssd_chunked(xh, Bm, Cm, dt, A, chunk)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = layers.rms_norm(y * F.silu(z), params["norm_w"], norm_eps)
    out = y @ params["w_out"]
    cache = None
    if S >= conv - 1:
        cache = SSMCache(state=s_final,
                         conv_buf=xbc_raw[:, S - (conv - 1):, :])
    return out, cache


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
