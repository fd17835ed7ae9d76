"""Multi-head Latent Attention (deepseek-v3) [arXiv:2412.19437].

Counterpart of the reference's ``models/mla.py``: the KV of a token is
compressed to a ``d_c``-dim latent plus one shared rotary key, and queries
go through their own ``d_cq`` latent.  Training (`mla_attention`) builds
per-head keys and values from the latent and runs the flash attention with
``dqk = dh + r`` and ``dv = dh``; the decode (``serve/serve_step.py``,
``_mla_decode_block``) scores queries against the latent cache directly
(the *absorbed* form).
"""
from __future__ import annotations

import math

import torch

from . import layers
from .flash import flash_attention


def init_mla(gen, d_model: int, n_heads: int, head_dim: int, d_c: int,
             d_cq: int, rope_dim: int, dtype, device, lead: tuple = ()) -> dict:
    """MLA weights; ``lead`` prepends axes (a stack of layers)."""
    H, dh, r = n_heads, head_dim, rope_dim
    w = lambda *shape: layers._normal(gen, lead + shape,
                                      1.0 / math.sqrt(shape[0]), dtype, device)
    p = {
        "w_dkv": w(d_model, d_c + r),
        "kv_norm": torch.zeros(lead + (d_c,), dtype=dtype, device=device),
        "w_uk": w(d_c, H * dh),
        "w_uv": w(d_c, H * dh),
        "w_o": w(H * dh, d_model),
    }
    if d_cq:
        p["w_dq"] = w(d_model, d_cq)
        p["q_norm"] = torch.zeros(lead + (d_cq,), dtype=dtype, device=device)
        p["w_uq"] = w(d_cq, H * (dh + r))
    else:
        p["w_q"] = w(d_model, H * (dh + r))
    return p


def _rope(x, positions, theta: float):
    """`layers.rope` at ``positions (B, S)``, or `layers.rope_at` when
    ``positions`` is one Python int (the decode's position)."""
    if isinstance(positions, int):
        return layers.rope_at(x, positions, theta)
    return layers.rope(x, positions, theta)


def mla_latent(params, x, positions, *, rope_dim: int, rope_theta: float,
               norm_eps: float = 1e-6):
    """The (latent, rotary-key) pair that the decode cache stores:
    x (B, S, d) → ((B, S, d_c), (B, S, r))."""
    d_c = params["kv_norm"].shape[0]
    ckr = x @ params["w_dkv"]
    c, kr = ckr[..., :d_c], ckr[..., d_c:]
    c = layers.rms_norm(c, params["kv_norm"], norm_eps)
    kr = _rope(kr[..., None, :], positions, rope_theta)[..., 0, :]
    return c, kr


def mla_queries(params, x, positions, *, n_heads: int, head_dim: int,
                rope_dim: int, rope_theta: float, norm_eps: float = 1e-6):
    """x (B, S, d) → (q_nope (B, S, H, dh), q_rope (B, S, H, r))."""
    B, S, _ = x.shape
    H, dh, r = n_heads, head_dim, rope_dim
    if "w_dq" in params:
        cq = layers.rms_norm(x @ params["w_dq"], params["q_norm"], norm_eps)
        q = (cq @ params["w_uq"]).reshape(B, S, H, dh + r)
    else:
        q = (x @ params["w_q"]).reshape(B, S, H, dh + r)
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    return q_nope, _rope(q_rope, positions, rope_theta)


def mla_attention(params, x, positions, *, n_heads: int, head_dim: int,
                  rope_dim: int, rope_theta: float, norm_eps: float = 1e-6):
    """Training / prefill path: per-head ``k_nope`` and ``v`` from the
    latent, the rotary key shared by every head, causal flash attention.
    Returns ``(out (B, S, d), (latent c, rotary key kr))``, the cache
    pair."""
    B, S, _ = x.shape
    H, dh, r = n_heads, head_dim, rope_dim
    c, kr = mla_latent(params, x, positions, rope_dim=r,
                       rope_theta=rope_theta, norm_eps=norm_eps)
    q_nope, q_rope = mla_queries(
        params, x, positions, n_heads=H, head_dim=dh, rope_dim=r,
        rope_theta=rope_theta, norm_eps=norm_eps)
    k_nope = (c @ params["w_uk"]).reshape(B, S, H, dh)
    v = (c @ params["w_uv"]).reshape(B, S, H, dh)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, r)], dim=-1)
    out = flash_attention(q, k, v, causal=True)     # dv = dh < dqk = dh + r
    out = out.reshape(B, S, H * dh) @ params["w_o"]
    return out, (c, kr)
