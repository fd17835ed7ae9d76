"""Batched single-token decode (`make_serve_step`) for every family.

Counterpart of the reference's ``serve/serve_step.py``: the dense and vlm
decode, the moe decode (GQA or absorbed-MLA attention, then the experts),
the Mamba2 hybrid (groups of Mamba2 steps, each group followed by the
shared attention block over that group's k/v), the xLSTM ``ssm`` decode
((mLSTM, sLSTM + FFN) pairs), the encoder-decoder decode with its
``encode_cross_cache`` prefill, on one device or on a ``(data, model)``
mesh.  Every block is written once, over a list of one activation a rank
(`_Ranks`); one device is one rank, where the projections are plain
products, nothing is summed or merged, and each layer's attention reads
only the cache rows that attend.  The reference's ``REPRO_SPLIT_LOCAL_DECODE``
branch (off by default, marked refuted there) is not ported.  Where the
reference scans over the layer stack, the port loops over it in Python and
updates the cache **in place**: the step writes the new token's k and v
(its latent, its recurrent states, and its signature bits) into the
caller's tensors and returns the cache dict with ``length + 1``.

Sketch attention (the paper's S-ANN adapted to decode, DESIGN.md §5.4), in
the dense and vlm decode: every layer ORs the new key's 64-bit SRP
signature into its 512-token block, and each *global* layer (window 0)
attends only over the blocks that collide with the query's signature in at
least 16 bits, plus the current block.  The port compacts those blocks into
a live list on the device and runs the hand-written CUDA kernel
`kernels.ops.sketch_decode_attn` over it (its plain version on the CPU);
a rank holding one block of a sequence split over the mesh runs its
partial entry over its live blocks, and the ranks' results are merged.
Local layers, and every layer with sketch off, compute the plain
attention (`decode_attention_partial`; `decode_attention` is the
reference's whole-cache form).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import prng
from ..core.util import fp32_reciprocal
from ..kernels import ops
from ..kernels.sketch_decode_attn import (block_mask, compact_live,
                                          live_blocks_from_sketch)
from ..models import layers, mla, model as model_lib, moe, ssm, xlstm
from ..parallel import sharding
from ..parallel.sharding import Sharded
from . import kv_cache
from .kv_cache import SIG_BITS, SKETCH_BLOCK

_SIG_SEED = 42
_MIN_MATCH_FRAC = 0.25
MIN_MATCH = int(SIG_BITS * _MIN_MATCH_FRAC)
# A signature bit may round either way where |x . proj| (float64) is within
# this fraction of |x| |proj column|: fp32 sums in another order, and the
# projection a few ulp from the reference's.
SIG_FLIP_TOL = 1e-5

# XLA's single-precision erf_inv (Giles' polynomial), which
# jax.random.normal uses; torch.erfinv is up to 91 ulp away at dh = 256.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def rope_token(x: torch.Tensor, position: int, theta: float) -> torch.Tensor:
    """x (B, 1, H, dh) rotated at the Python int ``position``."""
    if theta <= 0:
        return x
    return layers.rope_at(x, position, theta)


def decode_attention(q, k_cache, v_cache, length: int, *, window: int = 0,
                     softcap: float = 0.0, extra_mask=None):
    """q (B, 1, H, dh); caches (B, S, Hkv, dh); attend over [0, length],
    reading the whole cache: the reference's form, the plain version the
    tests hold `decode_attention_partial` (which the decode runs) against."""
    B, _, H, dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qs = q.reshape(B, Hkv, G, dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qs, k_cache.float()) * dh ** -0.5
    if softcap > 0.0:
        s = softcap * torch.tanh(s * fp32_reciprocal(softcap))
    pos = torch.arange(S, device=q.device)
    mask = pos <= length
    if window > 0:
        mask = mask & (pos > length - window)
    mask = mask[None, None, None, :]
    if extra_mask is not None:
        mask = mask & extra_mask
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.clamp(m, min=-1e30))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, H * dh)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``; each Horner step is rounded once, as the
    fused multiply-add XLA emits for it (exact product in float64)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = lambda i: torch.where(lt, _ERFINV_W_LT_5[i], _ERFINV_W_GE_5[i])
    p = coef(0)
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = (coef(i).double() + p.double() * w).float()
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max, p * x)


@functools.lru_cache(maxsize=None)
def _sig_proj(dh: int, device="cpu") -> torch.Tensor:
    """``jax.random.normal(PRNGKey(42), (dh, SIG_BITS))``, rebuilt from the
    threefry bits (`core.prng`): a uniform on [nextafter(-1, 0), 1) as
    ``jax.random.uniform`` draws it, then ``sqrt(2) * erf_inv``.  Within a
    few ulp of the reference (its ``log1p`` rounds differently); computed
    once on the CPU and cached per device."""
    x0, x1 = prng.threefry2x32(prng.PRNGKey(_SIG_SEED, device="cpu"), 0,
                               torch.arange(dh * SIG_BITS))
    mant = ((x0 ^ x1) >> 9) | 0x3F800000                # float32 in [1, 2)
    f = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = torch.clamp(f * 2.0 + lo, min=lo)               # (1 - lo) is 2.0 in fp32
    sqrt2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))
    return (sqrt2 * _erfinv32(u)).reshape(dh, SIG_BITS).to(device)


def _head_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(axis=2)`` as ``jnp.mean`` takes it: a float32 sum times the
    fp32 reciprocal of the count, rounded to x's dtype."""
    return (x.float().sum(2) * fp32_reciprocal(x.shape[2])).to(x.dtype)


def _sig_bits(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """x (..., dh) → (..., SIG_BITS) bool SRP signature."""
    return (x.float() @ proj) >= 0.0


def sig_near_boundary(x: torch.Tensor, proj: torch.Tensor,
                      tol: float = SIG_FLIP_TOL) -> torch.Tensor:
    """x (..., dh) → (..., SIG_BITS) bool: the bits whose projection lies
    within ``tol * |x| * |proj column|`` of the sign boundary."""
    x, proj = x.double(), proj.to(x.device).double()
    y = x @ proj
    return y.abs() <= tol * x.norm(dim=-1, keepdim=True) * proj.norm(dim=0)


def sig_flips(x, proj, got, want, tol: float = SIG_FLIP_TOL):
    """(bits where two signatures of ``x`` differ, those of them away from
    a sign boundary)."""
    diff = (got != want).cpu()
    near = sig_near_boundary(x.cpu(), proj.cpu(), tol)
    return int(diff.sum()), int((diff & ~near).sum())


def _live_blocks(q, sigs, length: int):
    """q (B, 1, H, dh), sigs (B, nb, SIG_BITS) → the live list ``(block_ids
    (B, nb), n_live (B,))``: the blocks up to the current one whose
    signature shares at least MIN_MATCH set bits with the query's, and
    always the current block (`live_blocks_from_sketch`)."""
    proj = _sig_proj(q.shape[-1], q.device)
    q_sig = _sig_bits(_head_mean(q)[:, 0], proj)               # (B, bits)
    return live_blocks_from_sketch(q_sig, sigs, length + 1, SKETCH_BLOCK,
                                   MIN_MATCH, current=length // SKETCH_BLOCK)


def sketch_block_mask(q, sigs, length: int) -> torch.Tensor:
    """q (B, 1, H, dh), sigs (B, nb, SIG_BITS) → extra_mask (B, 1, 1, S) for
    `decode_attention`: positions in blocks with fewer than MIN_MATCH
    colliding bits are pruned (paper §3 bucket collision, block
    granularity), and so are blocks past ``length``, which
    `decode_attention` masks anyway."""
    nb = sigs.shape[1]
    live = block_mask(*_live_blocks(q, sigs, length), nb)
    pos_block = torch.arange(nb * SKETCH_BLOCK, device=q.device) // SKETCH_BLOCK
    return live[:, pos_block][:, None, None, :]


def _update_sigs(sigs, k_new, length: int):
    """OR the new key's signature into its block, in place.  sigs (B, nb,
    bits); k_new (B, 1, Hkv, dh)."""
    proj = _sig_proj(k_new.shape[-1], k_new.device)
    bits = _sig_bits(_head_mean(k_new)[:, 0], proj)            # (B, bits)
    sigs[:, length // SKETCH_BLOCK] |= bits
    return sigs



# ---------------------------------------------------------------------------
# the ranks of one step: a (data, model) mesh's, or one device as one rank
# ---------------------------------------------------------------------------

# The dtype the decode sums the ranks' row-parallel products in (the MLP's
# ``w_down``, the experts' combine, Mamba2's ``w_out``): float32, the sum
# rounded once, as one device rounds its product.  The reference's
# ``moe_ep`` sums its combine in bfloat16; PERF.md §6 records the departure,
# why, and its cost against bfloat16 sums.
SUM_DTYPE = torch.float32


def _shards(leaf) -> list:
    """A leaf's blocks, one a rank: a `Sharded` leaf's, or one device's
    tensor."""
    return leaf.shards if isinstance(leaf, Sharded) else [leaf]


def _split(leaf, dim: int):
    """The mesh axes that cut ``leaf``'s dim ``dim`` into more than one
    block, or None."""
    if not isinstance(leaf, Sharded):
        return None
    ax = leaf.spec[dim]
    return ax if sharding.axis_size(leaf.mesh, ax) > 1 else None


def _block(leaf, r: int, dim: int) -> tuple:
    """Rank ``r``'s ``(start, size)`` of ``leaf``'s dim ``dim``."""
    size = _shards(leaf)[r].shape[dim]
    if not isinstance(leaf, Sharded):
        return 0, size
    return sharding.axis_index(leaf.mesh, r, leaf.spec[dim]) * size, size


def _col(w, hs: list, mesh) -> list:
    """``h @ w`` on every rank, whole: column-parallel over ``model`` (each
    rank its block of columns, then the all-gather of the outputs) where
    ``w`` splits its columns over ``model`` alone, else ``w`` gathered (on
    one device, ``h @ w``)."""
    if isinstance(w, Sharded) and layers._model_split(w, -1):
        blocks = w.gathered(keep=("model",))
        ys = [h @ blocks[r] for r, h in enumerate(hs)]
        return sharding.all_gather(ys, mesh, "model", dim=ys[0].dim() - 1)
    full = layers.rank_leaves(w, len(hs))
    return [h @ full[r] for r, h in enumerate(hs)]


def _row(w, xs: list, mesh) -> list:
    """``x @ w.float()`` on every rank (``x`` fp32 and whole): row-parallel
    over ``model`` (each rank its block of rows, then one sum over
    ``model``) where ``w`` splits its rows over ``model`` alone, else ``w``
    gathered (on one device, ``x @ w.float()``)."""
    if isinstance(w, Sharded) and layers._model_split(w, -2):
        blocks = w.gathered(keep=("model",))
        outs = []
        for r, x in enumerate(xs):
            n = blocks[r].shape[0]
            lo = sharding.axis_index(mesh, r, "model") * n
            outs.append(x[..., lo:lo + n] @ blocks[r].float())
        return sharding.psum(outs, mesh, "model")
    full = layers.rank_leaves(w, len(xs))
    return [x @ full[r].float() for r, x in enumerate(xs)]


class _Ranks:
    """One decode step's ranks (a mesh's, or one device as one rank): each
    rank's rows of the batch (the data axes of `kv_cache.cache_axes`, or
    the whole batch where it is replicated, and always for the xLSTM's
    replicated states), the merge of a sequence's partials, the embedding
    on every rank and the logits of each distinct batch block on the first
    rank's device."""

    def __init__(self, cfg: ModelConfig, mesh, B: int):
        self.cfg, self.mesh = cfg, mesh
        self.n = 1 if mesh is None else mesh.size
        ba, _ = kv_cache.cache_axes(cfg, B, mesh)
        self.batch_axes = () if ba is None or cfg.family == "ssm" else ba
        if mesh is None:
            self.rows = [(0, B)]
        else:
            spec = (sharding.canonical(self.batch_axes),)
            self.rows = [sharding._blocks((B,), spec, mesh, r)[0]
                         for r in range(mesh.size)]

    def firsts(self) -> list:
        """The first rank of each distinct batch block, in batch order."""
        seen, out = set(), []
        for r, rows in enumerate(self.rows):
            if rows not in seen:
                seen.add(rows)
                out.append(r)
        return sorted(out, key=lambda r: self.rows[r])

    def embed(self, tree, tokens) -> list:
        devs = [tokens.device] if self.mesh is None else self.mesh.devices
        toks = [tokens[b0:b0 + n].to(d) for (b0, n), d in zip(self.rows, devs)]
        xs = layers.embed_ranks(tree["embedding"], toks)
        if self.cfg.scale_embeddings:
            # the reference rounds sqrt(d_model) to the activation dtype first
            xs = [x * _embed_scale(self.cfg, x.dtype) for x in xs]
        return xs

    def logits(self, tree, xs: list) -> torch.Tensor:
        """The final norm and unembedding on one rank of each batch block,
        the blocks assembled on the first rank's device."""
        cfg, dev = self.cfg, xs[0].device
        ln_f = layers.rank_leaves(tree["ln_f"], self.n)
        w = layers.unembed_weights(tree["embedding"])
        out = []
        for r in self.firsts():
            x = layers.rms_norm(xs[r], ln_f[r], cfg.norm_eps)
            out.append(layers.unembed(w[r], x, cfg.final_softcap).to(dev))
        return torch.cat(out) if len(out) > 1 else out[0]

    def global_list(self, per_rank: list):
        """A layer's live lists ``(block_ids, n_live)`` of every rank → the
        whole batch's on the first rank's device."""
        dev = per_rank[0][0].device
        firsts = self.firsts()
        ids = [per_rank[r][0].to(dev) for r in firsts]
        n = [per_rank[r][1].to(dev) for r in firsts]
        return (torch.cat(ids), torch.cat(n)) if len(firsts) > 1 \
            else (ids[0], n[0])

    def merge(self, parts: list, leaf, dim: int) -> list:
        """Partials over ``leaf``'s dim ``dim`` merged across the ranks it
        splits over; where it is whole, each rank's own output."""
        axes = _split(leaf, dim)
        if axes is None:
            return [p[0] for p in parts]
        return sharding.merge_partials(parts, self.mesh, axes)


def _empty_partial(o_shape, device):
    """A rank's partial with nothing live: zeros, ``m = -inf``, ``l = 0``."""
    o = torch.zeros(o_shape, dtype=torch.float32, device=device)
    m = torch.full(o_shape[:-1], float("-inf"), device=device)
    return o, m, torch.zeros(o_shape[:-1], device=device)


def _live_range(s0: int, size: int, length: int, window: int) -> tuple:
    """The positions ``[lo, hi)`` of a block starting at ``s0`` that attend:
    at or below ``length``, and within ``window`` of it (``window`` > 0)."""
    lo = max(s0, length - window + 1) if window > 0 else s0
    return lo, min(s0 + size, length + 1)


def decode_attention_partial(q, k_cache, v_cache, length: int, s0: int, *,
                             window: int = 0, softcap: float = 0.0):
    """`decode_attention` over the cache block whose first row is global
    position ``s0``, un-merged: q (B, 1, H, dh); caches (B, S_block, Hkv,
    dh) → ``(o (B, Hkv, G, dh), m, l (B, Hkv, G))`` fp32, ``o`` normalised.
    Only the rows in `_live_range` are read; with none, the empty
    partial."""
    B, _, H, dh = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    lo, hi = _live_range(s0, k_cache.shape[1], length, window)
    if hi <= lo:
        return _empty_partial((B, Hkv, G, dh), q.device)
    k = k_cache[:, lo - s0:hi - s0].float()
    v = v_cache[:, lo - s0:hi - s0].float()
    qs = q.reshape(B, Hkv, G, dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qs, k) * dh ** -0.5
    if softcap > 0.0:
        s = softcap * torch.tanh(s * fp32_reciprocal(softcap))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    p = p / l[..., None]
    return torch.einsum("bhgs,bshd->bhgd", p, v), m, l


def _write_token(leaf, new: list, length: int, dim: int = 1) -> None:
    """Write each rank's new row into its block of a layer's cache ``leaf``
    (``(B, S, ...)``) where the block holds position ``length``."""
    for r, t in enumerate(_shards(leaf)):
        s0, size = _block(leaf, r, dim)
        if s0 <= length < s0 + size:
            t[:, length - s0] = new[r].to(t.dtype)


def _sketch_partials(q: list, kc, vc, sigs, length: int, cfg: ModelConfig,
                     live_out) -> list:
    """A global layer's sketch attention: the live list decided once from
    the block signatures (on each device, a batch block's replicas equal),
    then `ops.sketch_decode_attn` over it where a rank holds the whole
    sequence, else each rank's ids inside its block of the sequence
    rebased to it and `ops.sketch_decode_attn_partial` on every rank whose
    block starts at or below ``length``."""
    dh, Hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    G = cfg.n_heads // Hkv
    nb = sigs.shape[1]
    split = _split(kc, 1) is not None
    decided: dict = {}
    lists, parts = [], []
    for r, q_r in enumerate(q):
        B, dev = q_r.shape[0], q_r.device
        key = (_block(sigs, r, 0)[0], dev)
        if key not in decided:
            ids, n_live = _live_blocks(q_r, _shards(sigs)[r], length)
            decided[key] = (ids, n_live,
                            block_mask(ids, n_live, nb) if split else None)
        ids, n_live, live = decided[key]
        lists.append((ids, n_live))
        qk = q_r.reshape(B, Hkv, G, dh).contiguous()
        kc_r, vc_r = _shards(kc)[r], _shards(vc)[r]
        if not split:
            parts.append((ops.sketch_decode_attn(
                qk, kc_r, vc_r, ids, n_live, length + 1, SKETCH_BLOCK,
                cfg.attn_softcap),))
            continue
        s0, size = _block(kc, r, 1)
        if s0 > length:         # nothing of this block is written yet
            parts.append((torch.zeros((B, Hkv, G, dh), device=dev),
                          torch.full((B, Hkv, G), float("-inf"), device=dev)))
            continue
        b0 = s0 // SKETCH_BLOCK
        ids_r, n_r = compact_live(live[:, b0:b0 + size // SKETCH_BLOCK])
        parts.append(ops.sketch_decode_attn_partial(
            qk, kc_r, vc_r, ids_r, n_r, min(length + 1 - s0, size),
            SKETCH_BLOCK, cfg.attn_softcap))
    if live_out is not None:
        live_out.append(lists)
    return parts


def _attn_block(p, xs: list, kc, vc, length: int, cfg: ModelConfig,
                ms: _Ranks, *, window: int, sigs=None, live_out=None,
                rope_theta=None) -> list:
    """Dense-attention decode sub-block: the projections tensor-parallel
    (`_col`, `_row`), the token's k and v (and, with ``sigs``, its
    signature bits) written in place by the rank that owns position
    ``length``, each rank's partial over its block of the sequence (global
    positions) merged across the sequence's ranks before ``wo``.  A global
    layer with ``sigs`` runs the kernel over its live blocks and appends
    each rank's ``(block_ids, n_live)`` to ``live_out``.  ``rope_theta``
    overrides the config's (the encoder-decoder's self-attention passes 0:
    no RoPE)."""
    mesh, n = ms.mesh, ms.n
    dh = cfg.resolved_head_dim
    ln = {k: layers.rank_leaves(p[k], n) for k in ("ln1", "ln1_post")
          if k in p}
    hs = [layers.rms_norm(x, ln["ln1"][r], cfg.norm_eps)
          for r, x in enumerate(xs)]
    a = p["attn"]
    heads = lambda w, h: [t.reshape(-1, 1, h, dh) for t in _col(w, hs, mesh)]
    q = heads(a["wq"], cfg.n_heads)
    k = heads(a["wk"], cfg.n_kv_heads)
    v = heads(a["wv"], cfg.n_kv_heads)
    if cfg.qk_norm:
        qn = layers.rank_leaves(a["q_norm"], n)
        kn = layers.rank_leaves(a["k_norm"], n)
        q = [layers.rms_norm(t, qn[r], cfg.norm_eps) for r, t in enumerate(q)]
        k = [layers.rms_norm(t, kn[r], cfg.norm_eps) for r, t in enumerate(k)]
    theta = cfg.rope_theta if rope_theta is None else rope_theta
    q = [rope_token(t, length, theta) for t in q]
    k = [rope_token(t, length, theta) for t in k]
    _write_token(kc, [t[:, 0] for t in k], length)
    _write_token(vc, [t[:, 0] for t in v], length)
    if sigs is not None:
        for r, t in enumerate(k):
            _update_sigs(_shards(sigs)[r], t, length)
    if sigs is not None and window <= 0:
        parts = _sketch_partials(q, kc, vc, sigs, length, cfg, live_out)
    else:
        parts = [decode_attention_partial(
            q[r], _shards(kc)[r], _shards(vc)[r], length, _block(kc, r, 1)[0],
            window=window, softcap=cfg.attn_softcap) for r in range(n)]
    o = [t.reshape(t.shape[0], 1, cfg.n_heads * dh)
         for t in ms.merge(parts, kc, 1)]
    out = _row(a["wo"], o, mesh)      # fp32 attention output, as in JAX
    if "ln1_post" in ln:
        out = [layers.rms_norm(t, ln["ln1_post"][r], cfg.norm_eps)
               for r, t in enumerate(out)]
    return [x + t.to(x.dtype) for x, t in zip(xs, out)]


def _mlp_block(p, xs: list, cfg: ModelConfig, ms: _Ranks) -> list:
    ln = {k: layers.rank_leaves(p[k], ms.n) for k in ("ln2", "ln2_post")
          if k in p}
    hs = [layers.rms_norm(x, ln["ln2"][r], cfg.norm_eps)
          for r, x in enumerate(xs)]
    act = layers.gelu_tanh if cfg.mlp_act == "gelu" else F.silu
    m = layers.mlp_ranks(p["mlp"], hs, ms.mesh, act=act, sum_dtype=SUM_DTYPE)
    if "ln2_post" in ln:
        m = [layers.rms_norm(t, ln["ln2_post"][r], cfg.norm_eps)
             for r, t in enumerate(m)]
    return [x + t for x, t in zip(xs, m)]


def _moe_block(p, hs: list, cfg: ModelConfig, ms: _Ranks, cf: float):
    """The MoE layer on every rank: `moe.moe_ranks` (one device's
    `moe.moe_dense`, or expert parallelism where the ``model`` axis divides
    the experts, as the reference's ``moe_ep``), or, with the batch
    replicated and no expert split, `moe.moe_dense` of the whole batch on
    every rank."""
    if ms.mesh is not None and not ms.batch_axes \
            and not moe._use_ep(p, ms.mesh):
        tree = layers.gathered_tree(p)
        return [moe.moe_dense(tree[r], h, topk=cfg.moe_topk,
                              capacity_factor=cf)[0] for r, h in enumerate(hs)]
    return moe.moe_ranks(p, hs, ms.mesh, topk=cfg.moe_topk,
                         capacity_factor=cf, sum_dtype=SUM_DTYPE)[0]


def _mla_token(pa, x, ln1, length: int, cfg: ModelConfig):
    """The token's latent and rotary key (the cache's new row) and its
    queries: ``(c_new (B, d_c), kr_new (B, r), q_nope, q_rope)``."""
    h = layers.rms_norm(x, ln1, cfg.norm_eps)
    c_new, kr_new = mla.mla_latent(pa, h, length, rope_dim=cfg.mla_rope_dim,
                                   rope_theta=cfg.rope_theta,
                                   norm_eps=cfg.norm_eps)
    q_nope, q_rope = mla.mla_queries(
        pa, h, length, n_heads=cfg.n_heads, head_dim=cfg.resolved_head_dim,
        rope_dim=cfg.mla_rope_dim, rope_theta=cfg.rope_theta,
        norm_eps=cfg.norm_eps)
    return c_new[:, 0], kr_new[:, 0], q_nope, q_rope


def _mla_partial(pa, q_nope, q_rope, c, kr, cfg: ModelConfig):
    """The absorbed scores of the queries against latent rows ``c`` (B, n,
    d_c) and rotary keys ``kr`` (B, n, r), every row attending, scaled by
    ``1 / sqrt(dh + r)`` → ``(o_lat (B, H, d_c), m, l (B, H))`` fp32, the
    latent output normalised."""
    H, dh, d_c = cfg.n_heads, cfg.resolved_head_dim, cfg.mla_d_c
    c = c.float()
    w_uk = pa["w_uk"].reshape(d_c, H, dh)
    q_abs = torch.einsum("bqhd,chd->bhc", q_nope.float(), w_uk.float())
    s = torch.einsum("bhc,bsc->bhs", q_abs, c) \
        + torch.einsum("bqhr,bsr->bhs", q_rope.float(), kr.float())
    s = s * fp32_reciprocal(math.sqrt(dh + cfg.mla_rope_dim))
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(-1)
    return torch.einsum("bhs,bsc->bhc", e / l[..., None], c), m, l


def _mla_out(pa, o_lat, cfg: ModelConfig):
    """``w_uv`` of the latent output: (B, H, d_c) → (B, 1, H dh) fp32."""
    H, dh, d_c = cfg.n_heads, cfg.resolved_head_dim, cfg.mla_d_c
    w_uv = pa["w_uv"].reshape(d_c, H, dh)
    o = torch.einsum("bhc,chd->bhd", o_lat, w_uv.float())
    return o.reshape(o.shape[0], 1, H * dh)



def _mla_block(p, xs: list, cc, krc, length: int, cfg: ModelConfig,
               ms: _Ranks) -> list:
    """Absorbed MLA decode: the latent and queries on every rank (weights
    gathered), the token's latent and rotary key written in place by the
    owner of position ``length``, each rank's absorbed scores against its
    block's written rows of ``c`` / ``kr`` merged across the sequence's
    ranks, then ``w_uv`` and ``w_o`` (row-parallel)."""
    n = ms.n
    ln1 = layers.rank_leaves(p["ln1"], n)
    w = {k: layers.rank_leaves(v, n) for k, v in p["attn"].items()
         if k != "w_o"}
    pas = [{k: v[r] for k, v in w.items()} for r in range(n)]
    tok = [_mla_token(pas[r], x, ln1[r], length, cfg)
           for r, x in enumerate(xs)]
    _write_token(cc, [t[0] for t in tok], length)
    _write_token(krc, [t[1] for t in tok], length)
    parts = []
    for r, (_, _, q_nope, q_rope) in enumerate(tok):
        s0, size = _block(cc, r, 1)
        lo, hi = _live_range(s0, size, length, 0)
        if hi <= lo:
            parts.append(_empty_partial(
                (q_nope.shape[0], cfg.n_heads, cfg.mla_d_c), q_nope.device))
            continue
        parts.append(_mla_partial(pas[r], q_nope, q_rope,
                                  _shards(cc)[r][:, lo - s0:hi - s0],
                                  _shards(krc)[r][:, lo - s0:hi - s0], cfg))
    o_lat = ms.merge(parts, cc, 1)
    o = [_mla_out(pas[r], t, cfg) for r, t in enumerate(o_lat)]
    out = _row(p["attn"]["w_o"], o, ms.mesh)
    return [x + t.to(x.dtype) for x, t in zip(xs, out)]


def _mamba2_block(p, xs: list, st, cb, cfg: ModelConfig, ms: _Ranks) -> list:
    """Mamba2's decode step (`ssm.mamba2_decode_heads`, then
    `ssm.mamba2_heads_out`), split by heads over ``model`` as ``ssm_state``
    is: each rank projects ``z``, ``x`` and ``dt`` for its heads and the
    conv input whole (the conv tail stays whole and replicated), updates
    its heads' state, and normalises its heads' gated output by the ranks'
    summed squares over ``d_in``; ``w_out``'s row blocks are summed over
    ``model``.  The new conv tails of the batch blocks are gathered into
    every replica."""
    mesh, n = ms.mesh, ms.n
    kw = dict(state=cfg.ssm_state, expand=cfg.ssm_expand,
              head_dim=cfg.ssm_head_dim)
    ln = layers.rank_leaves(p["ln"], n)
    w = layers.gathered_tree(p["mixer"])
    heads = _split(st, 1)
    gs, cols, tails = [], [], []
    for r, x in enumerate(xs):
        st_r = _shards(st)[r]
        h0 = _block(st, r, 1)[0]
        b0, nb = ms.rows[r]
        h = layers.rms_norm(x, ln[r], cfg.norm_eps)[:, 0]
        g, new = ssm.mamba2_decode_heads(
            w[r], h, ssm.SSMCache(st_r, _shards(cb)[r][b0:b0 + nb]), h0, **kw)
        st_r.copy_(new.state)
        gs.append(g)
        cols.append(h0 * cfg.ssm_head_dim)
        tails.append(new.conv_buf)
    sq = [(g * g).sum(-1) for g in gs]
    if heads:
        sq = sharding.psum(sq, mesh, heads)
    outs = [ssm.mamba2_heads_out(w[r], g, sq[r], cols[r], xs[r].dtype,
                                  cfg.norm_eps, SUM_DTYPE if heads else None)
            for r, g in enumerate(gs)]
    if heads:
        outs = [o.to(x.dtype) for o, x in
                zip(sharding.psum(outs, mesh, heads), xs)]
    if ms.batch_axes:
        tails = sharding.all_gather(tails, mesh, ms.batch_axes, dim=0)
    for r, t in enumerate(tails):
        _shards(cb)[r].copy_(t)
    return [x + o[:, None] for x, o in zip(xs, outs)]


def _layer_views(cfg: ModelConfig, tree) -> dict:
    """Each stack's per-layer trees (views of the stacked leaves)."""
    lp = model_lib.layer_params
    stack = lambda name, n: [lp(tree[name], i) for i in range(n)]
    f = cfg.family
    if f in ("dense", "vlm"):
        return {"blocks": stack("blocks", cfg.n_layers)}
    if f == "moe":
        nd = cfg.n_dense_layers
        return {"dense": stack("dense_blocks", nd) if nd else [],
                "moe": stack("moe_blocks", cfg.n_layers - nd)}
    if f == "hybrid":
        G, E = cfg.n_layers // cfg.attn_every, cfg.attn_every
        return {"mamba": [[lp(g, e) for e in range(E)]
                          for g in stack("mamba_blocks", G)]}
    if f == "ssm":
        pairs = cfg.n_layers // 2
        return {"pairs": list(zip(stack("mlstm_blocks", pairs),
                                  stack("slstm_blocks", pairs)))}
    if f == "encdec":
        return {"dec": stack("dec_blocks", cfg.n_layers)}
    raise ValueError(f)


def _seq_capacity(cache: dict):
    """The cache's token capacity (None for the recurrent ``ssm`` cache)."""
    for name in ("k", "dk", "c"):
        if name in cache:
            return cache[name].shape[2]
    return None


def _decode_dense(cfg, views, tree, cache, xs, length, sigs, live, ms):
    for i, (p, window) in enumerate(zip(views["blocks"],
                                        model_lib.window_pattern(cfg))):
        xs = _attn_block(p, xs, cache["k"][i], cache["v"][i], length, cfg, ms,
                         window=window, sigs=None if sigs is None else sigs[i],
                         live_out=live)
        xs = _mlp_block(p, xs, cfg, ms)
    return xs


def _decode_moe(cfg, views, tree, cache, xs, length, sigs, live, ms):
    for i, p in enumerate(views["dense"]):
        xs = _attn_block(p, xs, cache["dk"][i], cache["dv"][i], length, cfg,
                         ms, window=0)
        xs = _mlp_block(p, xs, cfg, ms)
    cf = max(cfg.capacity_factor, 8.0)  # tiny T at decode
    for i, p in enumerate(views["moe"]):
        if cfg.use_mla:
            xs = _mla_block(p, xs, cache["c"][i], cache["kr"][i], length, cfg,
                            ms)
        else:
            xs = _attn_block(p, xs, cache["k"][i], cache["v"][i], length, cfg,
                             ms, window=0)
        ln2 = layers.rank_leaves(p["ln2"], ms.n)
        hs = [layers.rms_norm(x, ln2[r], cfg.norm_eps)
              for r, x in enumerate(xs)]
        xs = [x + m for x, m in zip(xs, _moe_block(p["moe"], hs, cfg, ms, cf))]
    return xs


def _decode_hybrid(cfg, views, tree, cache, xs, length, sigs, live, ms):
    st, cb = cache["ssm_state"], cache["conv_buf"]
    for g, group in enumerate(views["mamba"]):
        for e, p in enumerate(group):
            xs = _mamba2_block(p, xs, st[g][e], cb[g][e], cfg, ms)
        p = tree["shared_attn"]
        xs = _attn_block(p, xs, cache["k"][g], cache["v"][g], length, cfg, ms,
                         window=0)
        xs = _mlp_block(p, xs, cfg, ms)
    return xs


def _decode_ssm(cfg, views, tree, cache, xs, length, sigs, live, ms):
    """The xLSTM pairs on every rank over the whole batch, each rank's
    weights gathered and its replica of every state updated in place: the
    replicas stay equal."""
    names = ("mlstm_C", "mlstm_n", "mlstm_m", *(f"slstm_{n}" for n in "cnhm"))
    pairs = [(layers.gathered_tree(pm), layers.gathered_tree(psl))
             for pm, psl in views["pairs"]]
    out = []
    for r, x in enumerate(xs):
        st = {k: _shards(cache[k])[r] for k in names}
        x1 = x[:, 0]      # (B, d); the cells consume (B, 1, d) sequences
        for i, (wm, ws) in enumerate(pairs):
            pm, psl = wm[r], ws[r]
            h = layers.rms_norm(x1, pm["ln"], cfg.norm_eps)[:, None]
            o, s1 = xlstm.mlstm(pm["mixer"], h, n_heads=cfg.n_heads,
                                norm_eps=cfg.norm_eps, state=xlstm.MLSTMState(
                                    st["mlstm_C"][i], st["mlstm_n"][i],
                                    st["mlstm_m"][i]))
            x1 = x1 + o[:, 0]
            h = layers.rms_norm(x1, psl["ln"], cfg.norm_eps)[:, None]
            o2, s2 = xlstm.slstm(psl["mixer"], h, n_heads=cfg.n_heads,
                                 norm_eps=cfg.norm_eps, state=xlstm.SLSTMState(
                                     *(st[f"slstm_{n}"][i] for n in "cnhm")))
            x1 = x1 + o2[:, 0]
            hf = layers.rms_norm(x1, psl["ln_ffn"], cfg.norm_eps)
            x1 = x1 + layers.mlp(psl["ffn"], hf)
            for name, value in zip(names, (*s1, *s2)):
                st[name][i].copy_(value)
        out.append(x1[:, None])
    return out


def _decode_encdec(cfg, views, tree, cache, xs, length, sigs, live, ms):
    # absolute sinusoidal position of the current token
    S = cache["k"].shape[2]
    tab = {}
    for x in xs:
        if x.device not in tab:
            tab[x.device] = model_lib._sinusoid(S, cfg.d_model, x.dtype,
                                                x.device)
    xs = [x + tab[x.device][:, length:length + 1] for x in xs]
    dh = cfg.resolved_head_dim
    Te = cache["xk"].shape[2]
    for i, p in enumerate(views["dec"]):
        xs = _attn_block(p, xs, cache["k"][i], cache["v"][i], length, cfg, ms,
                         window=0, rope_theta=0.0)
        # cross attention over the precomputed encoder cache
        xk, xv = cache["xk"][i], cache["xv"][i]
        ln_x = layers.rank_leaves(p["ln_x"], ms.n)
        hs = [layers.rms_norm(x, ln_x[r], cfg.norm_eps)
              for r, x in enumerate(xs)]
        q = [t.reshape(t.shape[0], 1, cfg.n_heads, dh)
             for t in _col(p["xattn"]["wq"], hs, ms.mesh)]
        parts = [decode_attention_partial(
            q[r], _shards(xk)[r], _shards(xv)[r], Te - 1, _block(xk, r, 1)[0])
            for r in range(ms.n)]
        o = [t.reshape(t.shape[0], 1, cfg.n_heads * dh)
             for t in ms.merge(parts, xk, 1)]
        a = _row(p["xattn"]["wo"], o, ms.mesh)
        xs = [x + t.to(x.dtype) for x, t in zip(xs, a)]
        xs = _mlp_block(p, xs, cfg, ms)
    return xs


_DECODE = {"dense": _decode_dense, "vlm": _decode_dense, "moe": _decode_moe,
           "hybrid": _decode_hybrid, "ssm": _decode_ssm,
           "encdec": _decode_encdec}


def make_serve_step(cfg: ModelConfig, sketch: bool = False, mesh=None):
    """``serve_step(params, cache, tokens)``: tokens (B, 1) int on the
    cache's device → (logits (B, 1, vocab) fp32, cache with ``length + 1``).
    ``params`` is `models.model.init_model`'s tree (or its ``to_dict()``),
    any family.  After each call, ``serve_step.last_live`` lists
    ``(block_ids, n_live)`` of every global layer that ran the sketch
    kernel, in layer order (only the dense and vlm decode runs it); the
    list is refilled in place by the next call.

    On a ``(data, model)`` ``mesh`` the cache is
    `kv_cache.init_cache(..., mesh=mesh)`'s, the weights
    `parallel.param_specs.shard_params`'s, ``tokens`` lie on any device,
    and the logits come back on the mesh's first device; ``last_live``
    holds the whole batch's lists there."""
    if cfg.family not in _DECODE:
        raise ValueError(cfg.family)
    decode = _DECODE[cfg.family]
    views = {"params": None}
    # updated in place: the step must not refer to itself (a reference
    # cycle would hold the weights its views keep until a garbage collection)
    last_live = []

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        length = cache["length"]
        cap = _seq_capacity(cache)
        if cap is not None and length >= cap:
            raise ValueError(f"serve_step: the cache holds {length} tokens "
                             f"and has no room for another")
        if views["params"] is not params:
            tree = params.to_dict() if hasattr(params, "to_dict") else params
            if mesh is not None and not isinstance(tree["ln_f"], Sharded):
                raise ValueError("serve_step on a mesh: place the weights "
                                 "with param_specs.shard_params")
            views.update(params=params, tree=tree,
                         layers=_layer_views(cfg, tree))
        tree = views["tree"]
        sigs = cache.get("block_sigs") if sketch else None
        if sigs is not None and cfg.family in ("dense", "vlm"):
            rows = _shards(cache["k"])[0].shape[2]
            if rows % SKETCH_BLOCK:
                raise ValueError(
                    f"serve_step: a rank's {rows} cache rows are not whole "
                    f"{SKETCH_BLOCK}-token sketch blocks")
        ms = _Ranks(cfg, mesh, tokens.shape[0])
        live = []
        xs = decode(cfg, views["layers"], tree, cache, ms.embed(tree, tokens),
                    length, sigs, live, ms)
        last_live[:] = [ms.global_list(ids_n) for ids_n in live]
        return ms.logits(tree, xs), dict(cache, length=length + 1)

    serve_step.last_live = last_live
    return serve_step


def _embed_scale(cfg: ModelConfig, dtype) -> float:
    """``sqrt(d_model)`` rounded to the activation dtype, as the reference
    scales the embeddings."""
    return float(torch.tensor(math.sqrt(cfg.d_model), dtype=dtype))


@torch.no_grad()
def encode_cross_cache(params, cfg: ModelConfig, frames, cache) -> dict:
    """Run the encoder once over ``frames (B, enc_frames, d_model)`` (the
    stub frontend's embeddings) and return the cache with every decoder
    layer's cross-attention ``xk`` / ``xv``, bfloat16 as the reference
    stores them (whisper-style serving prefill).  On a mesh (``cache``
    from `kv_cache.init_cache` with one) each distinct batch block of the
    cross cache is encoded once a device with its layers' weights
    gathered, and each rank keeps its block of the sequence."""
    tree = params.to_dict() if hasattr(params, "to_dict") else params
    if isinstance(cache["xk"], Sharded):
        return _encode_cross_cache_mesh(tree, cfg, frames, cache)
    layer = lambda name, i: model_lib.layer_params(tree[name], i)
    xk, xv = _cross_kv(layer, tree["enc_ln_f"], cfg, frames)
    return dict(cache, xk=xk, xv=xv)


def _cross_kv(layer, enc_ln_f, cfg: ModelConfig, frames):
    """The encoder over ``frames`` and each decoder layer's cross keys and
    values, bfloat16 ``(L, B, Te, Hkv, dh)``; ``layer(stack, i)`` gives
    layer ``i``'s weights of stack ``"enc_blocks"`` / ``"dec_blocks"`` on
    ``frames``' device."""
    dt = model_lib._dtype(cfg)
    B, Te, _ = frames.shape
    dh = cfg.resolved_head_dim
    enc_pos = torch.arange(Te, dtype=torch.int32,
                           device=frames.device).expand(B, Te)
    x = frames.to(dt) + model_lib._sinusoid(Te, cfg.d_model, dt, frames.device)
    for i in range(cfg.n_enc_layers):
        p = layer("enc_blocks", i)
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = layers.attention(p["attn"], h, enc_pos, n_heads=cfg.n_heads,
                                n_kv_heads=cfg.n_kv_heads, head_dim=dh,
                                rope_theta=0.0, causal=False,
                                norm_eps=cfg.norm_eps)
        x = x + a
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + layers.mlp(p["mlp"], h, act=layers.gelu_tanh)
    enc = layers.rms_norm(x, enc_ln_f, cfg.norm_eps)
    xk, xv = [], []
    for i in range(cfg.n_layers):
        p = layer("dec_blocks", i)["xattn"]
        for out, w in ((xk, p["wk"]), (xv, p["wv"])):
            out.append((enc @ w).reshape(B, Te, cfg.n_kv_heads, dh)
                       .to(torch.bfloat16))
    return torch.stack(xk), torch.stack(xv)



def _encode_cross_cache_mesh(tree, cfg: ModelConfig, frames, cache) -> dict:
    """`encode_cross_cache` into a mesh cache: the whole batch encoded once
    a device (each layer's weights gathered there; the same products as on
    one device), each rank keeping its blocks of the batch and the
    sequence, bfloat16."""
    mesh = cache["xk"].mesh
    done: dict = {}
    out = {"xk": [], "xv": []}
    for r, dev in enumerate(mesh.devices):
        if dev not in done:
            def layer(name, i, r=r):
                return layers.gathered_tree(
                    model_lib.layer_params(tree[name], i))[r]
            done[dev] = _cross_kv(layer, tree["enc_ln_f"].gathered()[r], cfg,
                                  frames.to(dev))
        for name, full in zip(("xk", "xv"), done[dev]):
            b0, nb = _block(cache[name], r, 1)
            s0, size = _block(cache[name], r, 2)
            out[name].append(full[:, b0:b0 + nb, s0:s0 + size].contiguous())
    return dict(cache, **{name: Sharded(shards, cache[name].spec, mesh,
                                        cache[name].shape)
                          for name, shards in out.items()})
