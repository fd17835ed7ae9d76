"""Model assembly: init for every family, the layer pattern, forward.

Counterpart of the reference's ``models/model.py``: ``window_pattern``, the
dense block, ``init_model`` / ``init_params`` for every family (dense, vlm,
moe with MLA or GQA attention, the Mamba2 hybrid, the xLSTM ``ssm`` and the
encoder-decoder), the sinusoid table, and ``forward`` for the dense family.
The other families decode (``serve/serve_step.py``); their forward is not
ported yet (``ROADMAP.md``, queue 1).

Parameters live in a `ParamTree`, an ``nn.Module`` whose parameter names map
one to one onto the reference's pytree: ``blocks.attn.wq`` is
``params["blocks"]["attn"]["wq"]``, stacked on a leading layer axis as the
reference stacks it for ``lax.scan``.  The tree indexes like the reference's
dict (``params["blocks"]["attn"]["wq"]``, ``"ln1_post" in p``), so the decode
code reads as the reference's does.  A `ParamTree`'s parameters never take
gradients: it serves the decode.  Training holds the same tree as nested
dicts of tensors (`init_params`, ``ParamTree.to_dict``), and `forward` takes
either.  Its ``blocks`` may also be a list of per-layer trees (the train
step passes per-layer leaves that take gradients); with ``cfg.remat`` and
gradients on, each layer is rematerialised in the backward
(``torch.utils.checkpoint``), as the reference's ``_scan_stack`` is.
"""
from __future__ import annotations

import functools
import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.util import resolve_device
from . import layers, mla, moe, ssm, xlstm

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


def _dense_only(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what}: family {cfg.family!r} is not ported yet "
            "(ROADMAP.md, queue 1)")


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


def layer_params(blocks, i: int) -> dict:
    """Layer ``i``'s tree: a slice of the stacked ``blocks`` (or entry ``i``
    of a list of per-layer trees)."""
    if isinstance(blocks, (list, tuple)):
        return blocks[i]
    return {k: layer_params(v, i) if isinstance(v, Mapping) else v[i]
            for k, v in blocks.items()}


def _dense_block(p, x, positions, window: int, cfg: ModelConfig):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _ = layers.attention(
        p["attn"], h, positions,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm, causal=True, window=window,
        softcap=cfg.attn_softcap, norm_eps=cfg.norm_eps)
    if "ln1_post" in p:
        a = layers.rms_norm(a, p["ln1_post"], cfg.norm_eps)
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    m = layers.mlp(p["mlp"], h,
                   act=layers.gelu_tanh if cfg.mlp_act == "gelu" else F.silu)
    if "ln2_post" in p:
        m = layers.rms_norm(m, p["ln2_post"], cfg.norm_eps)
    return x + m


def forward(params, cfg: ModelConfig, batch: dict, return_hidden: bool = False):
    """``batch["tokens"] (B, S)`` → ``(logits (B, S, vocab) fp32, aux)``;
    ``return_hidden=True`` skips the unembedding and yields the final normed
    hidden states (the train loss unembeds them chunk by chunk)."""
    _dense_only(cfg, "forward")
    tree = params.to_dict() if isinstance(params, ParamTree) else params
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = layers.embed(tree["embedding"], tokens)
    if cfg.scale_embeddings:
        # the reference rounds sqrt(d_model) to the activation dtype first
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, window in enumerate(window_pattern(cfg)):
        block = functools.partial(_dense_block, layer_params(tree["blocks"], i),
                                  positions=positions, window=window, cfg=cfg)
        x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
    x = layers.rms_norm(x, tree["ln_f"], cfg.norm_eps)
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}
    if return_hidden:
        return x, aux
    return layers.unembed(tree["embedding"], x, cfg.final_softcap), aux


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
