"""Model assembly: init for every family, the layer pattern, forward.

Counterpart of the reference's ``models/model.py``: ``window_pattern``, the
dense block, ``init_model`` / ``init_params`` and ``forward`` for every
family (dense, vlm with its patch projection, moe with MLA or GQA attention
and the MTP head, the Mamba2 hybrid, the xLSTM ``ssm`` and the
encoder-decoder), and the sinusoid table.

Parameters live in a `ParamTree`, an ``nn.Module`` whose parameter names map
one to one onto the reference's pytree: ``blocks.attn.wq`` is
``params["blocks"]["attn"]["wq"]``, stacked on a leading layer axis as the
reference stacks it for ``lax.scan``.  The tree indexes like the reference's
dict (``params["blocks"]["attn"]["wq"]``, ``"ln1_post" in p``), so the decode
code reads as the reference's does.  A `ParamTree`'s parameters never take
gradients: it serves the decode.  Training holds the same tree as nested
dicts of tensors (`init_params`, ``ParamTree.to_dict``), and `forward` takes
either.  A stacked tree (``blocks``, ``dense_blocks``, ``moe_blocks``,
``mamba_blocks``, ``mlstm_blocks``, ``slstm_blocks``, ``enc_blocks``,
``dec_blocks``) may also be a list of per-layer trees (the train step
passes per-layer leaves that take gradients; ``mamba_blocks`` a list of
groups, each a list of layers).  Where the reference scans over a stack,
`forward` loops over its layers; with ``cfg.remat`` and gradients on, each
loop body is rematerialised in the backward (`remat.remat_call`) where the reference's ``_scan_stack`` puts ``jax.checkpoint``: a layer of
the dense, moe and encoder-decoder stacks, a group (its Mamba2 layers and
the shared block) of the hybrid, an (mLSTM, sLSTM + FFN) pair of the
xLSTM.

Every family's forward is one path over a list of activations, one a
rank (`forward_ranks`): on one device the list holds the whole batch as its
one rank.  On a ``(data, model)`` mesh (``ctx`` with a mesh) the
parameters are a tree of `parallel.sharding.Sharded` leaves placed by
`parallel.param_specs`, and every input of the batch (``tokens``,
``frames``, ``patches``) splits its rows over the data axes.  Each rank
runs its data shard; attention (self, causal or not, and the decoder's
cross-attention) and the MLPs are tensor-parallel over ``model``
(`layers.attention_ranks`, `layers.mlp_ranks`), MLA, Mamba2 and the mLSTM
split their heads over ``model`` (`mla.mla_attention_ranks`,
`ssm.mamba2_ranks`, `xlstm.mlstm_ranks`), the MoE layers are
expert-parallel (`moe.moe_ranks`), and each layer gathers its FSDP weights
inside the layer (rematerialised with it).  The residual stream stays
replicated over ``model``: the reference's ``seq_sp`` constraint splits it
over the sequence there, a layout only.
"""
from __future__ import annotations

import functools
import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..core.util import fp32_reciprocal, resolve_device
from ..parallel import param_specs
from ..parallel.sharding import NULL_CTX, Sharded, ShardingCtx, shard_tensor
from . import layers, mla, moe, ssm, xlstm
from .remat import remat_call

VIT_DIM = 1024  # the stub InternViT's output width


class ParamTree(nn.Module):
    """Nested parameters built from a dict of tensors (and dicts)."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def to_dict(self) -> dict:
        """The tree as nested dicts of tensors (the reference's layout)."""
        out = {n: p.data for n, p in self._parameters.items()}
        out.update({n: m.to_dict() for n, m in self._modules.items()})
        return out


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def window_pattern(cfg: ModelConfig) -> tuple:
    """Per-layer sliding windows: 0 = global.  gemma2: 1:1, gemma3: 5:1."""
    if cfg.local_global_period <= 0 or cfg.local_window <= 0:
        return (cfg.local_window,) * cfg.n_layers
    per = cfg.local_global_period
    return tuple(0 if i % per == per - 1 else cfg.local_window
                 for i in range(cfg.n_layers))


def _init_dense_block(gen, cfg: ModelConfig, dt, device, lead=()) -> dict:
    """A dense block's parameters; ``lead`` prepends axes (a stack)."""
    zeros = lambda: torch.zeros(lead + (cfg.d_model,), dtype=dt, device=device)
    p = {
        "ln1": zeros(),
        "attn": layers.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.qk_norm, dt, device, lead=lead),
        "ln2": zeros(),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device, lead=lead),
    }
    if cfg.sandwich_norm:  # gemma family: pre+post block norms
        p["ln1_post"] = zeros()
        p["ln2_post"] = zeros()
    return p


def _init_moe_blocks(gen, cfg: ModelConfig, dt, device, lead) -> dict:
    p = {
        "ln1": torch.zeros(lead + (cfg.d_model,), dtype=dt, device=device),
        "ln2": torch.zeros(lead + (cfg.d_model,), dtype=dt, device=device),
        "moe": moe.init_moe(gen, cfg.d_model, cfg.n_experts,
                            cfg.n_shared_experts, cfg.d_ff_expert, dt, device,
                            lead=lead),
    }
    if cfg.use_mla:
        p["attn"] = mla.init_mla(
            gen, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, cfg.mla_d_c,
            cfg.mla_d_cq, cfg.mla_rope_dim, dt, device, lead=lead)
    else:
        p["attn"] = layers.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.qk_norm, dt, device, lead=lead)
    return p


def _init_encdec_blocks(gen, cfg: ModelConfig, dt, device, lead,
                        decoder: bool) -> dict:
    """Whisper's encoder or decoder blocks: no qk-norm, an ungated MLP, and
    in the decoder a cross-attention after the self-attention."""
    zeros = lambda: torch.zeros(lead + (cfg.d_model,), dtype=dt, device=device)
    attn = lambda: layers.init_attention(
        gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
        False, dt, device, lead=lead)
    p = {"ln1": zeros(), "attn": attn()}
    if decoder:
        p["ln_x"], p["xattn"] = zeros(), attn()
    p["ln2"] = zeros()
    p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device,
                               gated=False, lead=lead)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, device="cuda") -> dict:
    """Random parameters with the reference's distributions (normal ×
    1/sqrt(fan_in), embedding normal × 0.02, norm weights zero), drawn from
    ``gen`` on ``device`` (the generator's device), as nested dicts with the
    reference's names, shapes and dtypes for every family.  Stacks carry a
    leading layer axis, as the reference's ``vmap`` init gives them
    (``(groups, attn_every, ...)`` for the hybrid's Mamba2 layers)."""
    device = resolve_device(device)
    dt = _dtype(cfg)
    d = cfg.d_model
    params: dict = {
        "embedding": layers.init_embedding(gen, cfg.vocab, d, dt, device,
                                           cfg.tie_embeddings),
        "ln_f": torch.zeros((d,), dtype=dt, device=device),
    }
    if cfg.family in ("dense", "vlm"):
        params["blocks"] = _init_dense_block(gen, cfg, dt, device,
                                             (cfg.n_layers,))
        if cfg.family == "vlm":
            params["patch_proj"] = layers._normal(
                gen, (VIT_DIM, d), 1.0 / math.sqrt(VIT_DIM), dt, device)
    elif cfg.family == "moe":
        nd, nm = cfg.n_dense_layers, cfg.n_layers - cfg.n_dense_layers
        if nd:
            params["dense_blocks"] = _init_dense_block(gen, cfg, dt, device,
                                                       (nd,))
        params["moe_blocks"] = _init_moe_blocks(gen, cfg, dt, device, (nm,))
        if cfg.mtp_depth:
            params["mtp"] = {
                "proj": layers._normal(gen, (2 * d, d), 1.0 / math.sqrt(2 * d),
                                       dt, device),
                "block": _init_dense_block(gen, cfg, dt, device),
                "ln": torch.zeros((d,), dtype=dt, device=device),
            }
    elif cfg.family == "hybrid":
        if cfg.attn_every <= 0 or cfg.n_layers % cfg.attn_every:
            raise ValueError(f"hybrid: n_layers {cfg.n_layers} is not a "
                             f"multiple of attn_every {cfg.attn_every}")
        lead = (cfg.n_layers // cfg.attn_every, cfg.attn_every)
        params["mamba_blocks"] = {
            "ln": torch.zeros(lead + (d,), dtype=dt, device=device),
            "mixer": ssm.init_mamba2(gen, d, cfg.ssm_state, cfg.ssm_conv,
                                     cfg.ssm_expand, cfg.ssm_head_dim, dt,
                                     device, lead=lead),
        }
        params["shared_attn"] = _init_dense_block(gen, cfg, dt, device)
    elif cfg.family == "ssm":   # xlstm: (mLSTM, sLSTM) pairs
        if cfg.n_layers % 2:
            raise ValueError(f"ssm: n_layers {cfg.n_layers} is odd")
        lead = (cfg.n_layers // 2,)
        zeros = lambda: torch.zeros(lead + (d,), dtype=dt, device=device)
        params["mlstm_blocks"] = {
            "ln": zeros(),
            "mixer": xlstm.init_mlstm(gen, d, cfg.n_heads, dt, device,
                                      lead=lead)}
        params["slstm_blocks"] = {
            "ln": zeros(),
            "mixer": xlstm.init_slstm(gen, d, cfg.n_heads, dt, device,
                                      lead=lead),
            "ln_ffn": zeros(),
            "ffn": layers.init_mlp(gen, d, 4 * d // 3, dt, device, lead=lead)}
    elif cfg.family == "encdec":
        params["enc_blocks"] = _init_encdec_blocks(
            gen, cfg, dt, device, (cfg.n_enc_layers,), decoder=False)
        params["enc_ln_f"] = torch.zeros((d,), dtype=dt, device=device)
        params["dec_blocks"] = _init_encdec_blocks(
            gen, cfg, dt, device, (cfg.n_layers,), decoder=True)
    else:
        raise ValueError(cfg.family)
    return params


def init_model(cfg: ModelConfig, gen: torch.Generator, device="cuda") -> ParamTree:
    """`init_params` as a `ParamTree` (the decode's parameters)."""
    return ParamTree(init_params(cfg, gen, device))


def layer_params(blocks, i: int):
    """Layer ``i``'s tree: a slice of the stacked ``blocks`` (or entry ``i``
    of a list of per-layer trees)."""
    if isinstance(blocks, (list, tuple)):
        return blocks[i]
    return {k: layer_params(v, i) if isinstance(v, Mapping) else v[i]
            for k, v in blocks.items()}


def _dense_block(p, xs: list, positions: list, window: int,
                 cfg: ModelConfig, mesh=None) -> list:
    """A dense block over a list of activations: one on one device, or one
    a rank of ``mesh`` (its data shard), the weights then `Sharded` and
    attention and the MLP tensor-parallel over ``model``."""
    ln = {k: layers.rank_leaves(p[k], len(xs))
          for k in ("ln1", "ln2", "ln1_post", "ln2_post") if k in p}
    hs = [layers.rms_norm(x, ln["ln1"][r], cfg.norm_eps)
          for r, x in enumerate(xs)]
    a = layers.attention_ranks(
        p["attn"], hs, positions, mesh,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm, causal=True, window=window,
        softcap=cfg.attn_softcap, norm_eps=cfg.norm_eps)
    if "ln1_post" in ln:
        a = [layers.rms_norm(t, ln["ln1_post"][r], cfg.norm_eps)
             for r, t in enumerate(a)]
    xs = [x + t for x, t in zip(xs, a)]
    hs = [layers.rms_norm(x, ln["ln2"][r], cfg.norm_eps)
          for r, x in enumerate(xs)]
    m = layers.mlp_ranks(p["mlp"], hs, mesh,
                         act=layers.gelu_tanh if cfg.mlp_act == "gelu"
                         else F.silu)
    if "ln2_post" in ln:
        m = [layers.rms_norm(t, ln["ln2_post"][r], cfg.norm_eps)
             for r, t in enumerate(m)]
    return [x + t for x, t in zip(xs, m)]


def _moe_block(p, xs: list, positions: list, cfg: ModelConfig, mesh=None):
    """A MoE block over a list of activations (as `_dense_block`; MLA
    attention split by heads, `mla.mla_attention_ranks`) → (activations,
    aux loss)."""
    ln = {k: layers.rank_leaves(p[k], len(xs)) for k in ("ln1", "ln2")}
    hs = [layers.rms_norm(x, ln["ln1"][r], cfg.norm_eps)
          for r, x in enumerate(xs)]
    if cfg.use_mla:
        a = mla.mla_attention_ranks(
            p["attn"], hs, positions, mesh, n_heads=cfg.n_heads,
            head_dim=cfg.resolved_head_dim, rope_dim=cfg.mla_rope_dim,
            rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
    else:
        a = layers.attention_ranks(
            p["attn"], hs, positions, mesh, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm, causal=True,
            norm_eps=cfg.norm_eps)
    xs = [x + t for x, t in zip(xs, a)]
    hs = [layers.rms_norm(x, ln["ln2"][r], cfg.norm_eps)
          for r, x in enumerate(xs)]
    m, aux = moe.moe_ranks(p["moe"], hs, mesh, topk=cfg.moe_topk,
                           capacity_factor=cfg.capacity_factor)
    return [x + t for x, t in zip(xs, m)], aux


def _run_stack(body, stack, n: int, xs: list, remat: bool):
    """``xs = body(layer_params(stack, i), xs)`` for i < n over a list of
    activations (one on one device, one a rank on a mesh), each layer (its
    gathers and collectives included) rematerialised in the backward when
    ``remat`` (`remat.remat_call`); a body may also return ``(xs, aux)``, the auxes
    summed in layer order."""
    aux = None
    for i in range(n):
        f = functools.partial(lambda p, *xs: body(p, list(xs)),
                              layer_params(stack, i))
        out = remat_call(f, *xs) if remat else f(*xs)
        if isinstance(out, tuple):
            xs, a = out
            aux = a if aux is None else aux + a
        else:
            xs = out
    return xs, aux


def _lm_stack(tree, cfg: ModelConfig, xs: list, positions: list,
              remat: bool, mesh=None):
    """The dense (vlm) or moe stack over a list of activations (one on one
    device, one a rank of ``mesh``) → (activations, the scaled MoE aux or
    None)."""
    if cfg.family in ("dense", "vlm"):
        stack = [(layer_params(tree["blocks"], i), window)
                 for i, window in enumerate(window_pattern(cfg))]
        xs, _ = _run_stack(lambda pw, xs: _dense_block(
            pw[0], xs, positions, pw[1], cfg, mesh), stack, cfg.n_layers, xs,
            remat)
        return xs, None
    nd, nm = cfg.n_dense_layers, cfg.n_layers - cfg.n_dense_layers
    if nd:
        xs, _ = _run_stack(lambda p, xs: _dense_block(p, xs, positions, 0,
                                                      cfg, mesh),
                           tree["dense_blocks"], nd, xs, remat)
    xs, aux = _run_stack(lambda p, xs: _moe_block(p, xs, positions, cfg, mesh),
                         tree["moe_blocks"], nm, xs, remat)
    if aux is not None:
        aux = aux * cfg.moe_aux_coef * fp32_reciprocal(max(nm, 1))
    return xs, aux


def _hybrid_group(shared, group, xs: list, positions: list, cfg: ModelConfig,
                  mesh=None) -> list:
    """One hybrid group over a list of activations: its Mamba2 layers in
    turn (split by heads on a mesh, `ssm.mamba2_ranks`), then the shared
    attention block (global)."""
    for e in range(cfg.attn_every):
        p = layer_params(group, e)
        ln = layers.rank_leaves(p["ln"], len(xs))
        hs = [layers.rms_norm(x, ln[r], cfg.norm_eps) for r, x in enumerate(xs)]
        o = ssm.mamba2_ranks(p["mixer"], hs, mesh, state=cfg.ssm_state,
                             conv=cfg.ssm_conv, expand=cfg.ssm_expand,
                             head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk,
                             norm_eps=cfg.norm_eps)
        xs = [x + t for x, t in zip(xs, o)]
    return _dense_block(shared, xs, positions, 0, cfg, mesh)


def _xlstm_pair(ps, xs: list, cfg: ModelConfig, mesh=None) -> list:
    """An (mLSTM, sLSTM + gated FFN) pair over a list of activations;
    ``ps`` is the pair's two trees.  On a mesh the mLSTM splits by heads
    (`xlstm.mlstm_ranks`), the sLSTM runs whole on every rank and the FFN
    is tensor-parallel (`layers.mlp_ranks`)."""
    pm, psl = ps
    n = len(xs)
    ln = {k: layers.rank_leaves(psl[k], n) for k in ("ln", "ln_ffn")}
    ln_m = layers.rank_leaves(pm["ln"], n)
    hs = [layers.rms_norm(x, ln_m[r], cfg.norm_eps) for r, x in enumerate(xs)]
    o = xlstm.mlstm_ranks(pm["mixer"], hs, mesh, n_heads=cfg.n_heads,
                          norm_eps=cfg.norm_eps)
    xs = [x + t for x, t in zip(xs, o)]
    hs = [layers.rms_norm(x, ln["ln"][r], cfg.norm_eps)
          for r, x in enumerate(xs)]
    o = xlstm.slstm_ranks(psl["mixer"], hs, n_heads=cfg.n_heads,
                          norm_eps=cfg.norm_eps)
    xs = [x + t for x, t in zip(xs, o)]
    hs = [layers.rms_norm(x, ln["ln_ffn"][r], cfg.norm_eps)
          for r, x in enumerate(xs)]
    return [x + t for x, t in zip(xs, layers.mlp_ranks(psl["ffn"], hs, mesh))]


def forward(params, cfg: ModelConfig, batch: dict, ctx: ShardingCtx = NULL_CTX,
            return_hidden: bool = False):
    """``batch["tokens"] (B, S)`` (and ``"patches" (B, n_patches, 1024)``
    for vlm, ``"frames" (B, enc_frames, d_model)`` for encdec, the stub
    frontends' outputs) → ``(logits (B, S, vocab) fp32, aux)``; aux holds
    ``moe_aux`` and, for a model with an MTP head, ``mtp_logits``.
    ``return_hidden=True`` skips the unembedding and yields the final normed
    hidden states (and ``mtp_hidden``): the train loss unembeds them chunk
    by chunk.  On a mesh (``ctx.mesh``) see `forward_ranks`: the outputs
    are `Sharded` (the logits split over the batch axes and the vocab), and
    ``moe_aux`` lies on the mesh's first device."""
    tree = params.to_dict() if isinstance(params, ParamTree) else params
    if ctx.mesh is not None:
        return _forward_mesh(tree, cfg, batch, ctx, return_hidden)
    (x,), aux = forward_ranks(tree, cfg, {k: [v] for k, v in batch.items()})
    if aux["moe_aux"] is None:
        aux["moe_aux"] = torch.zeros((), dtype=torch.float32, device=x.device)
    if "mtp_hidden" in aux:
        aux["mtp_hidden"] = aux["mtp_hidden"][0]
    if return_hidden:
        return x, aux
    out_aux = {"moe_aux": aux["moe_aux"]}
    if "mtp_hidden" in aux:
        out_aux["mtp_logits"] = layers.unembed(
            tree["embedding"], aux["mtp_hidden"], cfg.final_softcap)
    return layers.unembed(tree["embedding"], x, cfg.final_softcap), out_aux


def forward_ranks(tree, cfg: ModelConfig, batch: dict, mesh=None):
    """The forward of one block of each input a rank (``batch[k][r]``, rank
    r's rows of ``tokens`` and of ``patches`` or ``frames``; with no
    ``mesh``, one device's whole batch as its one rank) → (one final normed
    hidden state a rank, text positions only for vlm; ``{"moe_aux": the
    scaled MoE aux on the first rank's device, or None}``, with
    ``"mtp_hidden"`` (one a rank) for a model with an MTP head)."""
    if mesh is not None and not isinstance(tree["ln_f"], Sharded):
        raise ValueError("forward on a mesh: place the weights with "
                         "param_specs.shard_params")
    tokens = batch["tokens"]
    remat = cfg.remat and torch.is_grad_enabled()
    if cfg.family == "encdec":
        return _forward_encdec(tree, cfg, batch, remat, mesh), {"moe_aux": None}
    xs = layers.embed_ranks(tree["embedding"], tokens)
    if cfg.scale_embeddings:
        # the reference rounds sqrt(d_model) to the activation dtype first
        xs = [x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
              for x in xs]
    n_patches = 0
    if cfg.family == "vlm":
        proj = layers.rank_leaves(tree["patch_proj"], len(xs))
        n_patches = batch["patches"][0].shape[1]
        for r, (pt, x) in enumerate(zip(batch["patches"], xs)):
            dt = torch.promote_types(pt.dtype, proj[r].dtype)
            xs[r] = torch.cat([(pt.to(dt) @ proj[r].to(dt)).to(x.dtype), x],
                              dim=1)
    positions = [torch.arange(x.shape[1], dtype=torch.int32,
                              device=x.device).expand(x.shape[:2])
                 for x in xs]
    aux = None
    if cfg.family in ("dense", "vlm", "moe"):
        xs, aux = _lm_stack(tree, cfg, xs, positions, remat, mesh)
    elif cfg.family == "hybrid":
        xs, _ = _run_stack(lambda g, xs: _hybrid_group(
            tree["shared_attn"], g, xs, positions, cfg, mesh),
            tree["mamba_blocks"], cfg.n_layers // cfg.attn_every, xs, remat)
    elif cfg.family == "ssm":
        n = cfg.n_layers // 2
        pairs = [(layer_params(tree["mlstm_blocks"], i),
                  layer_params(tree["slstm_blocks"], i)) for i in range(n)]
        xs, _ = _run_stack(lambda ps, xs: _xlstm_pair(ps, xs, cfg, mesh),
                           pairs, n, xs, remat)
    else:
        raise ValueError(cfg.family)
    ln_f = layers.rank_leaves(tree["ln_f"], len(xs))
    xs = [layers.rms_norm(x, ln_f[r], cfg.norm_eps) for r, x in enumerate(xs)]
    out_aux = {"moe_aux": aux}
    if cfg.family == "moe" and cfg.mtp_depth and "mtp" in tree:
        out_aux["mtp_hidden"] = _mtp_head(tree, cfg, xs, tokens, positions,
                                          mesh)
    return [x[:, n_patches:] for x in xs], out_aux


def _forward_mesh(tree, cfg: ModelConfig, batch: dict, ctx: ShardingCtx,
                  return_hidden: bool):
    mesh = ctx.mesh
    batch = shard_batch(batch, mesh)
    xs, aux = forward_ranks(tree, cfg, {k: v.shards for k, v in batch.items()},
                            mesh)
    if aux["moe_aux"] is None:
        aux["moe_aux"] = torch.zeros((), dtype=torch.float32,
                                     device=mesh.devices[0])
    B, S = batch["tokens"].shape
    spec = ctx.spec("batch", None, None)
    mtp = aux.pop("mtp_hidden", None)
    if return_hidden:
        hidden = lambda hs: Sharded(hs, spec, mesh, (B, S, cfg.d_model))
        if mtp is not None:
            aux["mtp_hidden"] = hidden(mtp)
        return hidden(xs), aux
    w = layers.unembed_weights(tree["embedding"])

    def logits(hs):
        out = [layers.unembed(w[r], h, cfg.final_softcap)
               for r, h in enumerate(hs)]
        return ctx.constrain(Sharded(out, spec, mesh, (B, S, cfg.vocab)),
                             "batch", None, "vocab")
    if mtp is not None:
        aux["mtp_logits"] = logits(mtp)
    return logits(xs), aux


def shard_batch(batch: dict, mesh) -> dict:
    """Every input of ``batch`` split over the mesh's batch axes
    (`param_specs.batch_shardings`); an input already `Sharded` stays as
    it is."""
    specs = param_specs.batch_shardings(
        {k: v for k, v in batch.items() if not isinstance(v, Sharded)}, mesh)
    return {k: v if isinstance(v, Sharded) else shard_tensor(v, specs[k], mesh)
            for k, v in batch.items()}


def _mtp_head(tree, cfg: ModelConfig, hs: list, tokens: list, positions: list,
              mesh=None) -> list:
    """Depth-1 multi-token prediction (deepseek-v3), one final hidden state
    a rank: h_t joined with the embedding of token t+1 (each rank's own
    rows rolled), projected, through one dense block → hidden states that
    predict token t+2 through the shared unembedding."""
    p = tree["mtp"]
    n = len(hs)
    ln, proj = (layers.rank_leaves(p[k], n) for k in ("ln", "proj"))
    emb_next = layers.embed_ranks(tree["embedding"],
                                  [torch.roll(t, -1, 1) for t in tokens])
    xs = [torch.cat([layers.rms_norm(h, ln[r], cfg.norm_eps),
                     emb_next[r].to(h.dtype)], dim=-1) @ proj[r]
          for r, h in enumerate(hs)]
    return _dense_block(p["block"], xs, positions, 0, cfg, mesh)


def _enc_block(p, xs: list, positions: list, cfg: ModelConfig, mesh=None):
    ln = {k: layers.rank_leaves(p[k], len(xs)) for k in ("ln1", "ln2")}
    hs = [layers.rms_norm(x, ln["ln1"][r], cfg.norm_eps)
          for r, x in enumerate(xs)]
    a = layers.attention_ranks(p["attn"], hs, positions, mesh,
                               n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                               head_dim=cfg.resolved_head_dim, rope_theta=0.0,
                               causal=False, norm_eps=cfg.norm_eps)
    xs = [x + t for x, t in zip(xs, a)]
    hs = [layers.rms_norm(x, ln["ln2"][r], cfg.norm_eps)
          for r, x in enumerate(xs)]
    m = layers.mlp_ranks(p["mlp"], hs, mesh, act=layers.gelu_tanh)
    return [x + t for x, t in zip(xs, m)]


def _dec_block(p, ys: list, enc: list, positions: list, cfg: ModelConfig,
               mesh=None):
    ln = {k: layers.rank_leaves(p[k], len(ys)) for k in ("ln1", "ln_x", "ln2")}
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim, rope_theta=0.0,
              norm_eps=cfg.norm_eps)
    hs = [layers.rms_norm(y, ln["ln1"][r], cfg.norm_eps)
          for r, y in enumerate(ys)]
    a = layers.attention_ranks(p["attn"], hs, positions, mesh, causal=True,
                               **kw)
    ys = [y + t for y, t in zip(ys, a)]
    hs = [layers.rms_norm(y, ln["ln_x"][r], cfg.norm_eps)
          for r, y in enumerate(ys)]
    a = layers.attention_ranks(p["xattn"], hs, positions, mesh, causal=False,
                               cross=enc, **kw)
    ys = [y + t for y, t in zip(ys, a)]
    hs = [layers.rms_norm(y, ln["ln2"][r], cfg.norm_eps)
          for r, y in enumerate(ys)]
    m = layers.mlp_ranks(p["mlp"], hs, mesh, act=layers.gelu_tanh)
    return [y + t for y, t in zip(ys, m)]


def _forward_encdec(tree, cfg: ModelConfig, batch: dict, remat: bool,
                    mesh=None) -> list:
    """Whisper over one block of ``frames`` and ``tokens`` a rank: the
    non-causal encoder over the stub frontend's frames (no RoPE; sinusoid
    positions; ``enc_ln_f``), then the decoder's causal self-attention,
    cross-attention to the rank's encoder rows and ungated gelu MLP → one
    final normed hidden state a rank."""
    frames, tokens = batch["frames"], batch["tokens"]
    dt = _dtype(cfg)
    pos = lambda ts, n: [torch.arange(n, dtype=torch.int32,
                                      device=t.device).expand(t.shape[0], n)
                         for t in ts]
    Te, S = frames[0].shape[1], tokens[0].shape[1]
    enc_pos, dec_pos = pos(frames, Te), pos(tokens, S)
    xs = [f.to(dt) + _sinusoid(Te, cfg.d_model, dt, f.device) for f in frames]
    enc, _ = _run_stack(lambda p, xs: _enc_block(p, xs, enc_pos, cfg, mesh),
                        tree["enc_blocks"], cfg.n_enc_layers, xs, remat)
    ln = layers.rank_leaves(tree["enc_ln_f"], len(enc))
    enc = [layers.rms_norm(e, ln[r], cfg.norm_eps) for r, e in enumerate(enc)]
    ys = layers.embed_ranks(tree["embedding"], tokens)
    ys = [y + _sinusoid(S, cfg.d_model, y.dtype, y.device) for y in ys]
    ys, _ = _run_stack(lambda p, ys: _dec_block(p, ys, enc, dec_pos, cfg, mesh),
                       tree["dec_blocks"], cfg.n_layers, ys, remat)
    ln = layers.rank_leaves(tree["ln_f"], len(ys))
    return [layers.rms_norm(y, ln[r], cfg.norm_eps) for r, y in enumerate(ys)]


@functools.lru_cache(maxsize=32)
def _sinusoid_np(S: int, d: int):
    """The absolute sinusoid positions (S, d) in float64: sines then
    cosines, as the reference's table."""
    pos = np.arange(S)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)


@functools.lru_cache(maxsize=32)
def _sinusoid(S: int, d: int, dtype, device) -> torch.Tensor:
    """`_sinusoid_np` as (1, S, d) in ``dtype`` on ``device`` (cached: the
    decode reads one row a step)."""
    t = torch.from_numpy(_sinusoid_np(S, d))
    return t.to(dtype).to(device)[None]
