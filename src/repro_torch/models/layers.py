"""Shared model layers: RMSNorm, RoPE, blockwise flash attention, MLP,
embedding.

Counterpart of the reference's ``models/layers.py``.  Layers are functions
over dicts of tensors laid out as the
reference's pytrees, so `convert.lm_params_from_numpy` carries them over
leaf for leaf.  Each mirrors the reference's float32 arithmetic as XLA
compiles it: a mean is sum × fp32 reciprocal, a division by a constant is a
multiply by its fp32 reciprocal, and the RoPE frequencies are the correctly
rounded ``theta ** e`` that XLA's ``pow`` gives (``torch.pow`` is an ulp off).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..core.util import fp32_reciprocal, mean_last
from .flash import flash_attention


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(mean_last(x * x)[..., None] + eps)
    return (x * (1.0 + w.float())).to(dt)


@functools.lru_cache(maxsize=None)
def rope_freq(half: int, theta: float, device) -> torch.Tensor:
    """``theta ** (-arange(half) / half)`` in float32, cached per device.
    The exponent is the fp32 product the reference computes; the power is
    taken in float64 and rounded, which is XLA's result bit for bit."""
    e = -torch.arange(half, dtype=torch.float32) * fp32_reciprocal(half)
    return (float(theta) ** e.double()).float().to(device)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, dh) rotated by ``angles (..., S, half)``."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh), positions: (..., S) → rotated x."""
    freq = rope_freq(x.shape[-1] // 2, theta, x.device)
    return _rotate(x, positions[..., None].float() * freq)


def rope_at(x: torch.Tensor, position: int, theta: float) -> torch.Tensor:
    """`rope` with every position equal to the Python int ``position``: the
    same fp32 angles, with no position tensor on the device."""
    freq = rope_freq(x.shape[-1] // 2, theta, x.device)
    return _rotate(x, (freq * float(position))[None])


# A leaf of more elements than this is drawn in pieces of PIECE elements
# along its leading axes, so its float32 temporary stays small (deepseek-v3's
# stacked expert weights are 15 GB in bf16).
_WHOLE, _PIECE = 2**30, 2**28


def _normal(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    """``normal(shape) * scale`` drawn in float32 from ``gen``, in ``dtype``."""
    def draw(piece_shape):
        x = torch.randn(piece_shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(dtype)

    if math.prod(shape) <= _WHOLE or len(shape) < 2:
        return draw(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.view(-1, shape[-1])
    step = max(1, _PIECE // shape[-1])
    for r0 in range(0, rows.shape[0], step):
        piece = rows[r0:r0 + step]
        piece.copy_(draw(piece.shape))
    return out


def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, qk_norm: bool, dtype, device,
                   lead: tuple = ()) -> dict:
    """Attention weights; ``lead`` prepends axes (a stack of layers)."""
    sc = lambda fan_in: 1.0 / math.sqrt(fan_in)
    w = lambda *shape: _normal(gen, lead + shape, sc(shape[0]), dtype, device)
    p = {"wq": w(d_model, n_heads * head_dim),
         "wk": w(d_model, n_kv_heads * head_dim),
         "wv": w(d_model, n_kv_heads * head_dim),
         "wo": w(n_heads * head_dim, d_model)}
    if qk_norm:
        p["q_norm"] = torch.zeros(lead + (head_dim,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros(lead + (head_dim,), dtype=dtype, device=device)
    return p


def attention(params, x: torch.Tensor, positions: torch.Tensor, *,
              n_heads: int, n_kv_heads: int, head_dim: int,
              rope_theta: float, qk_norm: bool = False, causal: bool = True,
              window: int = 0, softcap: float = 0.0, norm_eps: float = 1e-6,
              cross_kv=None):
    """Full-sequence (train / prefill) attention of ``x (B, S, d)`` at
    ``positions (B, S)``.  Returns ``(out, (k, v))``; ``cross_kv = (k, v)``
    attends to given keys and values (no RoPE, not causal)."""
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    if cross_kv is None:
        k = (x @ params["wk"]).reshape(B, S, n_kv_heads, head_dim)
        v = (x @ params["wv"]).reshape(B, S, n_kv_heads, head_dim)
    else:
        k, v = cross_kv
    if qk_norm:
        q = rms_norm(q, params["q_norm"], norm_eps)
        k = rms_norm(k, params["k_norm"], norm_eps)
    if cross_kv is None and rope_theta > 0:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    out = flash_attention(q, k, v, causal=causal and cross_kv is None,
                          window=window, softcap=softcap)
    out = out.reshape(B, S, n_heads * head_dim) @ params["wo"]
    return out, (k, v)


def init_mlp(gen, d_model: int, d_ff: int, dtype, device, gated: bool = True,
             lead: tuple = ()) -> dict:
    """MLP weights; ``lead`` prepends axes (a stack of layers)."""
    w = lambda *shape: _normal(gen, lead + shape, 1.0 / math.sqrt(shape[0]),
                               dtype, device)
    p = {"w_up": w(d_model, d_ff), "w_down": w(d_ff, d_model)}
    if gated:
        p["w_gate"] = w(d_model, d_ff)
    return p


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(params, x: torch.Tensor, act=F.silu) -> torch.Tensor:
    h = x @ params["w_up"]
    if "w_gate" in params:
        h = act(x @ params["w_gate"]) * h
    else:
        h = act(h)
    return h @ params["w_down"]


def init_embedding(gen, vocab: int, d_model: int, dtype, device,
                   tie: bool) -> dict:
    p = {"embed": _normal(gen, (vocab, d_model), 0.02, dtype, device)}
    if not tie:
        p["unembed"] = _normal(gen, (d_model, vocab), 1.0 / math.sqrt(d_model),
                               dtype, device)
    return p


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of the embedding table at ``tokens``.  `F.embedding`'s
    backward sums each row's gradient in a fixed order on the card (the
    gather's own backward, ``index_put_`` with accumulate, adds by atomics),
    so a training step repeats bit for bit."""
    return F.embedding(tokens, params["embed"])


def unembed(params, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    w = params["unembed"] if "unembed" in params else params["embed"].T
    logits = (x @ w).float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits * fp32_reciprocal(softcap))
    return logits
