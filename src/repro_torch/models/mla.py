"""Multi-head Latent Attention (deepseek-v3) [arXiv:2412.19437].

Counterpart of the reference's ``models/mla.py``: the KV of a token is
compressed to a ``d_c``-dim latent plus one shared rotary key, and queries
go through their own ``d_cq`` latent.  Training (`mla_attention`) builds
per-head keys and values from the latent and runs the flash attention with
``dqk = dh + r`` and ``dv = dh``; the decode (``serve/serve_step.py``,
``_mla_block``) scores queries against the latent cache directly
(the *absorbed* form).

On a ``(data, model)`` mesh (`mla_attention_ranks`) the training attention
splits its heads over ``model``, as the reference constrains ``q`` on
``heads``: each rank computes the latent and the rotary key whole (``w_dkv``
and ``w_dq`` are FSDP only), its heads' queries, keys and values from its
column blocks of ``w_uq`` (``w_q``), ``w_uk`` and ``w_uv``, the flash
attention over them, and its row block of ``w_o``; one sum over ``model``
follows.
"""
from __future__ import annotations

import math

import torch

from ..parallel import sharding
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


def mla_attention_ranks(params, hs: list, positions: list, mesh, *,
                        n_heads: int, head_dim: int, rope_dim: int,
                        rope_theta: float, norm_eps: float = 1e-6) -> list:
    """`mla_attention` of one activation a rank: the heads split over
    ``model`` where ``w_uq`` (or ``w_q``), ``w_uk`` and ``w_uv`` split
    their columns and ``w_o`` its rows on whole heads over ``model`` alone,
    the rank's output block of ``w_o`` summed over ``model``; otherwise
    every weight gathered and every head computed on every rank (with no
    ``mesh``, `mla_attention` on one device)."""
    M = mesh.shape.get("model", 1) if mesh is not None else 1
    cols = ("w_uq" if "w_uq" in params else "w_q", "w_uk", "w_uv")
    tp = (M > 1 and n_heads % M == 0
          and all(layers._model_split(params[k], -1) for k in cols)
          and layers._model_split(params["w_o"], -2))
    kw = dict(head_dim=head_dim, rope_dim=rope_dim, rope_theta=rope_theta,
              norm_eps=norm_eps)
    if not tp:
        w = layers.gathered_tree(params)
        return [mla_attention(w[r], h, positions[r], n_heads=n_heads, **kw)[0]
                for r, h in enumerate(hs)]
    local = {k: params[k].gathered(keep=("model",)) for k in cols + ("w_o",)}
    whole = {k: layers.rank_leaves(v, len(hs)) for k, v in params.items()
             if k not in local}
    parts = []
    for r, h in enumerate(hs):
        p = {k: v[r] for k, v in {**whole, **local}.items()}
        parts.append(mla_attention(p, h, positions[r], n_heads=n_heads // M,
                                   **kw)[0])
    return sharding.psum(parts, mesh, "model")
