"""Batched single-token decode (`make_serve_step`) for every family.

Counterpart of the reference's ``serve/serve_step.py``: the dense and vlm
decode, the moe decode (GQA or absorbed-MLA attention, then the experts),
the Mamba2 hybrid (groups of Mamba2 steps, each group followed by the
shared attention block over that group's k/v), the xLSTM ``ssm`` decode
((mLSTM, sLSTM + FFN) pairs), the encoder-decoder decode with its
``encode_cross_cache`` prefill.  The reference's ``REPRO_SPLIT_LOCAL_DECODE``
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
`kernels.ops.sketch_decode_attn` over it (its plain version on the CPU).
Local layers, and every layer with sketch off, use the plain
`decode_attention`, as the reference computes them.
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
from ..kernels.sketch_decode_attn import block_mask, live_blocks_from_sketch
from ..models import layers, mla, model as model_lib, moe, ssm, xlstm
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
    """q (B, 1, H, dh); caches (B, S, Hkv, dh); attend over [0, length]."""
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


def _attn_decode_block(p, x, kc, vc, length: int, cfg: ModelConfig, *,
                       window: int, sigs=None, live_out=None, rope_theta=None):
    """Dense-attention decode sub-block; writes the token's k and v (and,
    with ``sigs``, its signature) in place and returns the new x.  A global
    layer with ``sigs`` runs the kernel over its live blocks and stores
    ``(block_ids, n_live)`` in ``live_out``.  ``rope_theta`` overrides the
    config's (the encoder-decoder's self-attention passes 0: no RoPE)."""
    dh = cfg.resolved_head_dim
    B = x.shape[0]
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (h @ p["attn"]["wq"]).reshape(B, 1, cfg.n_heads, dh)
    k = (h @ p["attn"]["wk"]).reshape(B, 1, cfg.n_kv_heads, dh)
    v = (h @ p["attn"]["wv"]).reshape(B, 1, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["attn"]["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, p["attn"]["k_norm"], cfg.norm_eps)
    theta = cfg.rope_theta if rope_theta is None else rope_theta
    q = rope_token(q, length, theta)
    k = rope_token(k, length, theta)
    kc[:, length] = k[:, 0].to(kc.dtype)
    vc[:, length] = v[:, 0].to(vc.dtype)
    if sigs is not None:
        _update_sigs(sigs, k, length)
    if sigs is not None and window <= 0:
        block_ids, n_live = _live_blocks(q, sigs, length)
        G = cfg.n_heads // cfg.n_kv_heads
        a = ops.sketch_decode_attn(
            q.reshape(B, cfg.n_kv_heads, G, dh).contiguous(), kc, vc,
            block_ids, n_live, length + 1, SKETCH_BLOCK, cfg.attn_softcap)
        a = a.reshape(B, 1, cfg.n_heads * dh)
        if live_out is not None:
            live_out.append((block_ids, n_live))
    else:
        a = decode_attention(q, kc, vc, length, window=window,
                             softcap=cfg.attn_softcap)
    a = a @ p["attn"]["wo"].float()      # fp32 attention output, as in JAX
    if "ln1_post" in p:
        a = layers.rms_norm(a, p["ln1_post"], cfg.norm_eps)
    return x + a.to(x.dtype)


def _mlp_block(p, x, cfg: ModelConfig):
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    act = layers.gelu_tanh if cfg.mlp_act == "gelu" else F.silu
    m = layers.mlp(p["mlp"], h, act=act)
    if "ln2_post" in p:
        m = layers.rms_norm(m, p["ln2_post"], cfg.norm_eps)
    return x + m


def _mla_decode_block(p, x, cc, krc, length: int, cfg: ModelConfig):
    """Absorbed MLA decode: scores against the latent cache directly,
    scaled by ``1 / sqrt(dh + r)``.  Writes the token's latent and rotary
    key in place and returns the new x."""
    B = x.shape[0]
    H, dh, r = cfg.n_heads, cfg.resolved_head_dim, cfg.mla_rope_dim
    d_c = cfg.mla_d_c
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    c_new, kr_new = mla.mla_latent(p["attn"], h, length, rope_dim=r,
                                   rope_theta=cfg.rope_theta,
                                   norm_eps=cfg.norm_eps)
    cc[:, length] = c_new[:, 0].to(cc.dtype)
    krc[:, length] = kr_new[:, 0].to(krc.dtype)
    q_nope, q_rope = mla.mla_queries(
        p["attn"], h, length, n_heads=H, head_dim=dh, rope_dim=r,
        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
    w_uk = p["attn"]["w_uk"].reshape(d_c, H, dh)
    q_abs = torch.einsum("bqhd,chd->bhc", q_nope.float(), w_uk.float())
    s = torch.einsum("bhc,bsc->bhs", q_abs, cc.float()) \
        + torch.einsum("bqhr,bsr->bhs", q_rope.float(), krc.float())
    s = s * fp32_reciprocal(math.sqrt(dh + r))
    mask = torch.arange(cc.shape[1], device=x.device) <= length
    s = torch.where(mask[None, None, :], s, float("-inf"))
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsc->bhc", w, cc.float())          # (B, H, d_c)
    w_uv = p["attn"]["w_uv"].reshape(d_c, H, dh)
    o = torch.einsum("bhc,chd->bhd", o_lat, w_uv.float())
    o = o.reshape(B, 1, H * dh) @ p["attn"]["w_o"].float()
    return x + o.to(x.dtype)


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


def _decode_dense(cfg, views, tree, cache, x, length, sigs, live):
    for i, (p, window) in enumerate(zip(views["blocks"],
                                        model_lib.window_pattern(cfg))):
        x = _attn_decode_block(
            p, x, cache["k"][i], cache["v"][i], length, cfg, window=window,
            sigs=None if sigs is None else sigs[i], live_out=live)
        x = _mlp_block(p, x, cfg)
    return x


def _decode_moe(cfg, views, tree, cache, x, length, sigs, live):
    for i, p in enumerate(views["dense"]):
        x = _attn_decode_block(p, x, cache["dk"][i], cache["dv"][i], length,
                               cfg, window=0)
        x = _mlp_block(p, x, cfg)
    cf = max(cfg.capacity_factor, 8.0)  # tiny T at decode
    for i, p in enumerate(views["moe"]):
        if cfg.use_mla:
            x = _mla_decode_block(p, x, cache["c"][i], cache["kr"][i], length,
                                  cfg)
        else:
            x = _attn_decode_block(p, x, cache["k"][i], cache["v"][i], length,
                                   cfg, window=0)
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        m, _ = moe.moe(p["moe"], h, topk=cfg.moe_topk, capacity_factor=cf)
        x = x + m
    return x


def _decode_hybrid(cfg, views, tree, cache, x, length, sigs, live):
    st, cb = cache["ssm_state"], cache["conv_buf"]
    for g, group in enumerate(views["mamba"]):
        for e, p in enumerate(group):
            h = layers.rms_norm(x, p["ln"], cfg.norm_eps)
            o, nc = ssm.mamba2_decode_step(
                p["mixer"], h, ssm.SSMCache(st[g, e], cb[g, e]),
                state=cfg.ssm_state, expand=cfg.ssm_expand,
                head_dim=cfg.ssm_head_dim, norm_eps=cfg.norm_eps)
            st[g, e].copy_(nc.state)
            cb[g, e].copy_(nc.conv_buf)
            x = x + o
        p = tree["shared_attn"]
        x = _attn_decode_block(p, x, cache["k"][g], cache["v"][g], length, cfg,
                               window=0)
        x = _mlp_block(p, x, cfg)
    return x


def _decode_ssm(cfg, views, tree, cache, x, length, sigs, live):
    x1 = x[:, 0]      # (B, d); the cells consume (B, 1, d) sequences
    for i, (pm, psl) in enumerate(views["pairs"]):
        h = layers.rms_norm(x1, pm["ln"], cfg.norm_eps)[:, None]
        o, st = xlstm.mlstm(pm["mixer"], h, n_heads=cfg.n_heads,
                            norm_eps=cfg.norm_eps, state=xlstm.MLSTMState(
                                cache["mlstm_C"][i], cache["mlstm_n"][i],
                                cache["mlstm_m"][i]))
        x1 = x1 + o[:, 0]
        h = layers.rms_norm(x1, psl["ln"], cfg.norm_eps)[:, None]
        o2, st2 = xlstm.slstm(psl["mixer"], h, n_heads=cfg.n_heads,
                              norm_eps=cfg.norm_eps, state=xlstm.SLSTMState(
                                  *(cache[f"slstm_{n}"][i] for n in "cnhm")))
        x1 = x1 + o2[:, 0]
        hf = layers.rms_norm(x1, psl["ln_ffn"], cfg.norm_eps)
        x1 = x1 + layers.mlp(psl["ffn"], hf)
        for name, value in (("mlstm_C", st.C), ("mlstm_n", st.n),
                            ("mlstm_m", st.m), *((f"slstm_{n}", v) for n, v
                                                 in zip("cnhm", st2))):
            cache[name][i].copy_(value)
    return x1[:, None]


def _decode_encdec(cfg, views, tree, cache, x, length, sigs, live):
    # absolute sinusoidal position of the current token
    tab = model_lib._sinusoid(cache["k"].shape[2], cfg.d_model, x.dtype,
                              x.device)
    x = x + tab[:, length:length + 1]
    B, dh = x.shape[0], cfg.resolved_head_dim
    Te = cache["xk"].shape[2]
    for i, p in enumerate(views["dec"]):
        x = _attn_decode_block(p, x, cache["k"][i], cache["v"][i], length, cfg,
                               window=0, rope_theta=0.0)
        # cross attention over the precomputed encoder cache
        h = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
        q = (h @ p["xattn"]["wq"]).reshape(B, 1, cfg.n_heads, dh)
        a = decode_attention(q, cache["xk"][i], cache["xv"][i], Te - 1)
        x = x + (a @ p["xattn"]["wo"].float()).to(x.dtype)
        x = _mlp_block(p, x, cfg)
    return x


_DECODE = {"dense": _decode_dense, "vlm": _decode_dense, "moe": _decode_moe,
           "hybrid": _decode_hybrid, "ssm": _decode_ssm,
           "encdec": _decode_encdec}


def make_serve_step(cfg: ModelConfig, sketch: bool = False):
    """``serve_step(params, cache, tokens)``: tokens (B, 1) int on the
    cache's device → (logits (B, 1, vocab) fp32, cache with ``length + 1``).
    ``params`` is `models.model.init_model`'s tree (or its ``to_dict()``),
    any family.  After each call, ``serve_step.last_live`` lists
    ``(block_ids, n_live)`` of every global layer that ran the sketch
    kernel, in layer order (only the dense and vlm decode runs it); the
    list is refilled in place by the next call."""
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
            views.update(params=params, tree=tree,
                         layers=_layer_views(cfg, tree))
        tree = views["tree"]
        sigs = cache.get("block_sigs") if sketch else None
        x = layers.embed(tree["embedding"], tokens)
        if cfg.scale_embeddings:
            # the reference rounds sqrt(d_model) to the activation dtype first
            x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
        live = []
        x = decode(cfg, views["layers"], tree, cache, x, length, sigs, live)
        x = layers.rms_norm(x, tree["ln_f"], cfg.norm_eps)
        logits = layers.unembed(tree["embedding"], x, cfg.final_softcap)
        last_live[:] = live
        return logits, dict(cache, length=length + 1)

    serve_step.last_live = last_live
    return serve_step


@torch.no_grad()
def encode_cross_cache(params, cfg: ModelConfig, frames, cache) -> dict:
    """Run the encoder once over ``frames (B, enc_frames, d_model)`` (the
    stub frontend's embeddings) and return the cache with every decoder
    layer's cross-attention ``xk`` / ``xv``, bfloat16 as the reference
    stores them (whisper-style serving prefill)."""
    tree = params.to_dict() if hasattr(params, "to_dict") else params
    dt = model_lib._dtype(cfg)
    B, Te, _ = frames.shape
    dh = cfg.resolved_head_dim
    enc_pos = torch.arange(Te, dtype=torch.int32,
                           device=frames.device).expand(B, Te)
    x = frames.to(dt) + model_lib._sinusoid(Te, cfg.d_model, dt, frames.device)
    for i in range(cfg.n_enc_layers):
        p = model_lib.layer_params(tree["enc_blocks"], i)
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = layers.attention(p["attn"], h, enc_pos, n_heads=cfg.n_heads,
                                n_kv_heads=cfg.n_kv_heads, head_dim=dh,
                                rope_theta=0.0, causal=False,
                                norm_eps=cfg.norm_eps)
        x = x + a
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + layers.mlp(p["mlp"], h, act=layers.gelu_tanh)
    enc = layers.rms_norm(x, tree["enc_ln_f"], cfg.norm_eps)
    xk, xv = [], []
    for i in range(cfg.n_layers):
        p = model_lib.layer_params(tree["dec_blocks"], i)["xattn"]
        for out, w in ((xk, p["wk"]), (xv, p["wv"])):
            out.append((enc @ w).reshape(B, Te, cfg.n_kv_heads, dh)
                       .to(torch.bfloat16))
    return dict(cache, xk=torch.stack(xk), xv=torch.stack(xv))
