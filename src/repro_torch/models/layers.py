"""Shared model layers: RMSNorm, RoPE, blockwise flash attention, MLP,
embedding.

Counterpart of the reference's ``models/layers.py``.  Layers are functions
over dicts of tensors laid out as the
reference's pytrees, so `convert.lm_params_from_numpy` carries them over
leaf for leaf.  Each mirrors the reference's float32 arithmetic as XLA
compiles it: a mean is sum × fp32 reciprocal, a division by a constant is a
multiply by its fp32 reciprocal, and the RoPE frequencies are the correctly
rounded ``theta ** e`` that XLA's ``pow`` gives (``torch.pow`` is an ulp off).

On a ``(data, model)`` mesh (`attention_ranks`, `mlp_ranks`) the layers take
one activation a rank (its data shard, equal over ``model``) and a layer's
tree of `parallel.sharding.Sharded` weights, and give one output a rank,
again equal over ``model``.  Attention's ``wq`` / ``wk`` / ``wv`` are
column-parallel and ``wo`` row-parallel, likewise the MLP's ``w_up`` /
``w_gate`` and ``w_down``: each rank gathers its ``model`` block of the
weights over the FSDP axis, computes its heads or FFN columns, and one sum
over ``model`` follows the row-parallel product.  Where a weight's split
does not fall on whole heads or on the matching FFN columns, the layer
gathers the weights whole and computes as on one device, on every rank.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..core.util import fp32_reciprocal
from ..parallel import sharding
from .flash import flash_attention


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
             sq: torch.Tensor = None, n: int = None) -> torch.Tensor:
    """RMSNorm of ``x``'s rows.  Where ``x`` is a block of columns of rows
    of ``n`` (one rank's heads), ``sq`` is the float32 sum of squares over
    the whole rows (the ranks' sums added) and ``w`` the block's weights;
    with no ``sq``, the rows are whole."""
    dt = x.dtype
    x = x.float()
    if sq is None:
        sq, n = (x * x).sum(-1), x.shape[-1]
    var = sq * sq.new_full((), 1.0 / n)               # `core.util.mean_last`
    x = x * torch.rsqrt(var + eps)[..., None]
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


def _mlp_hidden(params, x: torch.Tensor, act) -> torch.Tensor:
    h = x @ params["w_up"]
    if "w_gate" in params:
        return act(x @ params["w_gate"]) * h
    return act(h)


def mlp(params, x: torch.Tensor, act=F.silu) -> torch.Tensor:
    return _mlp_hidden(params, x, act) @ params["w_down"]


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


# ---------------------------------------------------------------------------
# tensor parallelism on a (data, model) mesh: one activation a rank
# ---------------------------------------------------------------------------

def rank_leaves(leaf, n: int, keep=()) -> list:
    """One tensor a rank: a `Sharded` leaf's blocks gathered
    (`Sharded.gathered`), or on one device (``n`` = 1) the tensor itself."""
    if isinstance(leaf, sharding.Sharded):
        return leaf.gathered(keep)
    return [leaf] * n


def gathered_tree(tree) -> list:
    """One dict a rank of a tree's `Sharded` leaves gathered whole; of a
    tree on one device, the tree itself as its one rank's."""
    keys = list(tree)
    cols = {k: (gathered_tree(tree[k]) if isinstance(tree[k], dict)
                else rank_leaves(tree[k], 1)) for k in keys}
    n = len(next(iter(cols.values())))
    return [{k: cols[k][r] for k in keys} for r in range(n)]


def _model_split(leaf, dim: int) -> bool:
    """Whether ``leaf`` splits ``dim`` over ``model`` alone."""
    return leaf.spec[dim % len(leaf.spec)] == "model"


def _cross_kv(p, enc: torch.Tensor, n_kv: int, head_dim: int) -> tuple:
    """The keys and values of cross-attention over ``enc (B, Te, d)``
    from ``p``'s ``wk`` / ``wv`` (their columns of ``n_kv`` heads)."""
    B, Te, _ = enc.shape
    return ((enc @ p["wk"]).reshape(B, Te, n_kv, head_dim),
            (enc @ p["wv"]).reshape(B, Te, n_kv, head_dim))


def attention_ranks(params, hs: list, positions: list, mesh, *,
                    n_heads: int, n_kv_heads: int, head_dim: int,
                    rope_theta: float, qk_norm: bool = False,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, norm_eps: float = 1e-6,
                    cross: list | None = None) -> list:
    """`attention` of one activation a rank: the heads split over
    ``model`` where ``wq`` and ``wo`` split on whole heads, the local
    query heads' keys and values from ``wk`` / ``wv``'s own blocks when
    those fall on whole heads, else from their gathered columns of the
    heads needed; otherwise every weight gathered and every head computed
    on every rank.  ``cross`` (one encoder output a rank, its rows of the
    batch) makes it the decoder's cross-attention: each rank's keys and
    values are its encoder rows through its heads' columns of ``wk`` /
    ``wv`` (no RoPE, not causal).  With no ``mesh``, `attention` of
    ``hs``' one activation on one device."""
    M = mesh.shape.get("model", 1) if mesh is not None else 1
    H, Hkv, dh = n_heads, n_kv_heads, head_dim
    g = H // Hkv
    tp = (M > 1 and H % M == 0 and _model_split(params["wq"], -1)
          and _model_split(params["wo"], -2))
    Hl = H // M
    kv_local = tp and Hkv % M == 0 and all(
        _model_split(params[k], -1) for k in ("wk", "wv"))
    if tp and not kv_local and not (Hl % g == 0 or g % Hl == 0):
        tp = False
    kw = dict(head_dim=dh, rope_theta=rope_theta, qk_norm=qk_norm,
              causal=causal, window=window, softcap=softcap,
              norm_eps=norm_eps)
    norms = {k: rank_leaves(params[k], len(hs)) for k in ("q_norm", "k_norm")
             if k in params}
    if not tp:
        full = {k: rank_leaves(params[k], len(hs))
                for k in ("wq", "wk", "wv", "wo")}
        outs = []
        for r, h in enumerate(hs):
            p = {k: v[r] for k, v in {**full, **norms}.items()}
            ckv = _cross_kv(p, cross[r], Hkv, dh) if cross else None
            outs.append(attention(p, h, positions[r], n_heads=H,
                                  n_kv_heads=Hkv, cross_kv=ckv, **kw)[0])
        return outs
    local = {k: params[k].gathered(keep=("model",)) for k in ("wq", "wo")}
    kv = {k: params[k].gathered(keep=("model",) if kv_local else ())
          for k in ("wk", "wv")}
    parts = []
    for r, h in enumerate(hs):
        p = {k: v[r] for k, v in {**local, **norms}.items()}
        if kv_local:
            n_kv = Hkv // M
            p["wk"], p["wv"] = kv["wk"][r], kv["wv"][r]
        else:      # the kv heads this rank's query heads read
            m = sharding.axis_index(mesh, r, "model")
            lo, hi = (m * Hl) // g, ((m + 1) * Hl - 1) // g + 1
            n_kv = hi - lo
            p["wk"] = kv["wk"][r][:, lo * dh:hi * dh]
            p["wv"] = kv["wv"][r][:, lo * dh:hi * dh]
        ckv = _cross_kv(p, cross[r], n_kv, dh) if cross else None
        parts.append(attention(p, h, positions[r], n_heads=Hl,
                               n_kv_heads=n_kv, cross_kv=ckv, **kw)[0])
    return sharding.psum(parts, mesh, "model")


def mlp_ranks(params, hs: list, mesh, act=F.silu, sum_dtype=None) -> list:
    """`mlp` of one activation a rank: column-parallel ``w_up`` /
    ``w_gate`` and row-parallel ``w_down`` with one sum over ``model``
    where all three split their FFN dim over it, else the weights
    gathered whole on every rank (with no ``mesh``: `mlp` on one
    device).  The row-parallel products are summed in the activations'
    dtype, as the reference sums them; with ``sum_dtype`` (the decode's
    float32) each rank's product is taken and the ranks' products summed
    in it, and the sum rounded once to the activations' dtype, as one
    device rounds its product."""
    M = mesh.shape.get("model", 1) if mesh is not None else 1
    names = [k for k in ("w_up", "w_gate") if k in params]
    tp = M > 1 and all(_model_split(params[k], -1) for k in names) \
        and _model_split(params["w_down"], -2)
    w = {k: rank_leaves(params[k], len(hs), keep=("model",) if tp else ())
         for k in names + ["w_down"]}
    if not (tp and sum_dtype is not None):
        outs = [mlp({k: v[r] for k, v in w.items()}, h, act=act)
                for r, h in enumerate(hs)]
        return sharding.psum(outs, mesh, "model") if tp else outs
    outs = [_mlp_hidden({k: v[r] for k, v in w.items()}, h, act).to(sum_dtype)
            @ w["w_down"][r].to(sum_dtype) for r, h in enumerate(hs)]
    return [o.to(h.dtype) for o, h in
            zip(sharding.psum(outs, mesh, "model"), hs)]


def embed_ranks(params, tokens: list) -> list:
    """`embed` of one token block a rank, the vocab-split table gathered
    whole on each rank (the reference's choice: gathering the table beats
    summing activations over the vocab); on one device, `embed`."""
    table = rank_leaves(params["embed"], len(tokens))
    return [F.embedding(t, table[r]) for r, t in enumerate(tokens)]


def unembed_weights(params) -> list:
    """One dict a rank holding the whole unembedding (``unembed``, or the
    tied ``embed``), gathered; on one device, one dict."""
    key = "unembed" if "unembed" in params else "embed"
    return [{key: w} for w in rank_leaves(params[key], 1)]
