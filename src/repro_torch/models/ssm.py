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

On a ``(data, model)`` mesh (`mamba2_ranks`) the mixer splits its heads
over ``model``, as the reference constrains ``xh`` on ``heads``: ``w_in``
and ``w_out`` are FSDP only, so each rank gathers them and takes its heads'
``z``, ``x`` and ``dt`` columns of ``w_in`` and the conv input's ``B`` and
``C`` whole, runs the causal conv and the chunked SSD on its heads, and
normalises its heads' gated output by the ranks' summed squares over
``d_in``; its rows of ``w_out`` follow, summed over ``model``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel import sharding
from . import layers
from .remat import remat_call


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
        y_intra = remat_call(_intra, cum, Cc, Bc, xd)
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
    `SSMCache`, or None when S < conv - 1): `_mamba2_heads` over every
    head, then `mamba2_heads_out`."""
    B, S, d = x.shape
    g, s_final, xbc_raw = _mamba2_heads(
        params, x, 0, expand * d // head_dim, state=state, expand=expand,
        head_dim=head_dim, chunk=chunk)
    out = mamba2_heads_out(params, g, None, 0, x.dtype, norm_eps)
    cache = None
    if S >= conv - 1:
        cache = SSMCache(state=s_final,
                         conv_buf=xbc_raw[:, S - (conv - 1):, :])
    return out, cache


def _mamba2_heads(params, x, h0: int, n_heads: int, *, state: int,
                  expand: int, head_dim: int, chunk: int):
    """The full-sequence mixer of the heads ``[h0, h0 + n_heads)`` (one
    rank's heads on a mesh, or all of them) before its norm: x (B, S, d) →
    ``(g, s_final, xbc_raw)``: their gated output ``y * silu(z)`` (B, S,
    n_heads P) in x's dtype, their final SSD state (B, n_heads, N, P) fp32
    and the conv's input (B, S, n_heads P + 2N).  One product takes those
    heads' ``z`` and ``x`` columns of ``w_in``, the conv input's ``B`` and
    ``C`` (whole) and the heads' ``dt`` columns; the depthwise conv runs on
    those channels."""
    B, S, d = x.shape
    d_in = expand * d
    lo, hi = h0 * head_dim, (h0 + n_heads) * head_dim
    w, cw, cb = params["w_in"], params["conv_w"], params["conv_b"]
    if hi - lo < d_in:                   # a rank's heads: their columns
        dt0 = 2 * d_in + 2 * state + h0
        w = torch.cat([w[:, lo:hi], w[:, d_in + lo:d_in + hi],
                       w[:, 2 * d_in:2 * d_in + 2 * state],
                       w[:, dt0:dt0 + n_heads]], dim=1)
        cw = torch.cat([cw[:, lo:hi], cw[:, d_in:]], dim=1)
        cb = torch.cat([cb[lo:hi], cb[d_in:]])
    n = hi - lo
    z, xbc_raw, dt_raw = torch.split(x @ w, [n, n + 2 * state, n_heads],
                                     dim=-1)
    xbc = F.silu(_causal_conv1d(xbc_raw, cw, cb))
    xr, Bm, Cm = torch.split(xbc, [n, state, state], dim=-1)
    dt = softplus(dt_raw.float() + params["dt_bias"][h0:h0 + n_heads])
    A = -torch.exp(params["A_log"][h0:h0 + n_heads])
    xh = xr.reshape(B, S, n_heads, head_dim)
    y, s_final = _ssd_chunked(xh, Bm, Cm, dt, A, chunk)
    y = y + params["D"][None, None, h0:h0 + n_heads, None] * xh.float()
    return y.reshape(B, S, n).to(x.dtype) * F.silu(z), s_final, xbc_raw


def mamba2_ranks(params, hs: list, mesh, *, state: int, conv: int,
                 expand: int, head_dim: int, chunk: int,
                 norm_eps: float = 1e-6) -> list:
    """`mamba2`'s output of one activation a rank, one body for every
    case: `_mamba2_heads` on a rank's heads, the gated RMSNorm by their
    sum of squares, then ``w_out``'s rows of those heads
    (`mamba2_heads_out`).  The heads split over ``model`` where they split
    evenly, the squares and the outputs then summed over ``model``, in the
    activations' dtype; otherwise (and on one device, with no ``mesh``)
    each rank gathers the weights and runs every head."""
    M = mesh.shape.get("model", 1) if mesh is not None else 1
    H = expand * hs[0].shape[-1] // head_dim
    split = M > 1 and H % M == 0
    Hl = H // M if split else H
    h0s = [sharding.axis_index(mesh, r, "model") * Hl if split else 0
           for r in range(len(hs))]
    w = layers.gathered_tree(params)
    gs = [_mamba2_heads(w[r], h, h0s[r], Hl, state=state, expand=expand,
                        head_dim=head_dim, chunk=chunk)[0]
          for r, h in enumerate(hs)]
    sq = (sharding.psum([(g.float() * g.float()).sum(-1) for g in gs], mesh,
                        "model") if split else [None] * len(gs))
    outs = [mamba2_heads_out(w[r], g, sq[r], h0s[r] * head_dim, g.dtype,
                             norm_eps) for r, g in enumerate(gs)]
    return sharding.psum(outs, mesh, "model") if split else outs


def mamba2_decode_step(params, x, cache: SSMCache, *, state: int, expand: int,
                       head_dim: int, norm_eps: float = 1e-6):
    """Single-token decode: x (B, 1, d) → (out (B, 1, d), new SSMCache):
    `mamba2_decode_heads` over every head, then `mamba2_heads_out`."""
    g, new = mamba2_decode_heads(params, x[:, 0], cache, 0, state=state,
                                 expand=expand, head_dim=head_dim)
    out = mamba2_heads_out(params, g, None, 0, x.dtype, norm_eps)
    return out[:, None, :], new


def mamba2_decode_heads(params, h, cache: SSMCache, h0: int, *, state: int,
                        expand: int, head_dim: int):
    """The single-token step of the heads ``[h0, h0 + H_l)`` whose state
    ``cache.state (B, H_l, N, P)`` holds (one rank's heads on a mesh, or
    all of them): h (B, d) → ``(g (B, H_l P) fp32, new SSMCache)``, ``g``
    the heads' gated output before its norm.  Each head's ``z``, ``x`` and
    ``dt`` columns of ``w_in`` are the heads' own; the conv input (B and C
    with it) and the conv tail are whole."""
    B, d = h.shape
    d_in = expand * d
    Hl = cache.state.shape[1]
    lo, hi = h0 * head_dim, (h0 + Hl) * head_dim
    w_in = params["w_in"]
    if hi - lo == d_in:                  # every head: one product
        z, xbc_raw, dt_raw = torch.split(h @ w_in, [d_in, d_in + 2 * state, Hl],
                                         dim=-1)
    else:
        dt0 = 2 * d_in + 2 * state + h0
        z = h @ w_in[:, lo:hi]
        xbc_raw = h @ w_in[:, d_in:2 * d_in + 2 * state]
        dt_raw = h @ w_in[:, dt0:dt0 + Hl]
    window = torch.cat([cache.conv_buf, xbc_raw[:, None, :]], dim=1)  # (B,K,C)
    conv = (window * params["conv_w"][None]).sum(dim=1) + params["conv_b"]
    xbc = F.silu(conv)
    xr = xbc[:, lo:hi]
    Bm, Cm = xbc[:, d_in:d_in + state], xbc[:, d_in + state:]
    dt = softplus(dt_raw.float() + params["dt_bias"][h0:h0 + Hl])  # (B, H_l)
    A = -torch.exp(params["A_log"][h0:h0 + Hl])
    a = torch.exp(dt * A)
    xh = xr.reshape(B, Hl, head_dim).float()
    s = cache.state * a[:, :, None, None] + torch.einsum(
        "bn,bhp->bhnp", Bm.float(), xh * dt[..., None])
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), s)
    y = y + params["D"][None, h0:h0 + Hl, None] * xh
    g = (y.reshape(B, hi - lo).to(h.dtype) * F.silu(z)).float()
    new_tail = torch.cat([cache.conv_buf[:, 1:], xbc_raw[:, None]], dim=1)
    return g, SSMCache(state=s, conv_buf=new_tail)


def mamba2_heads_out(params, g, sq, lo: int, dtype, norm_eps: float,
                     sum_dtype=None):
    """The gated RMSNorm of ``g (..., n)``, columns ``[lo, lo + n)`` of
    ``d_in``, by ``sq (...)``, the float32 sum of squares over all of
    ``d_in`` (the ranks' sum on a mesh; None where ``g`` is all of it), then ``w_out``'s rows ``[lo, lo +
    n)`` → (..., d) in ``dtype``, or with ``sum_dtype`` the product in it,
    for a sum over the ranks."""
    d_in = params["norm_w"].shape[-1]
    hi = lo + g.shape[-1]
    y = layers.rms_norm(g, params["norm_w"][lo:hi], norm_eps, sq=sq,
                        n=d_in).to(dtype)
    if sum_dtype is None:
        return y @ params["w_out"][lo:hi]
    return y.to(sum_dtype) @ params["w_out"][lo:hi].to(sum_dtype)
