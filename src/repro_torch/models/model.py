"""Model assembly for the dense family: ``init_model`` and the layer pattern.

Counterpart of the reference's ``models/model.py`` (``window_pattern``, the
dense block's init and ``init_model`` for the dense family; ``forward`` goes
with the training slice).

Parameters live in a `ParamTree`, an ``nn.Module`` whose parameter names map
one to one onto the reference's pytree: ``blocks.attn.wq`` is
``params["blocks"]["attn"]["wq"]``, stacked on a leading layer axis as the
reference stacks it for ``lax.scan``.  The tree indexes like the reference's
dict (``params["blocks"]["attn"]["wq"]``, ``"ln1_post" in p``), so the decode
code reads as the reference's does.  Parameters never take gradients here.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.util import resolve_device
from . import layers


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


def _init_dense_blocks(gen, cfg: ModelConfig, dt, device) -> dict:
    """The dense blocks' parameters, stacked on a leading layer axis."""
    lead = (cfg.n_layers,)
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


def init_model(cfg: ModelConfig, gen: torch.Generator, device="cuda") -> ParamTree:
    """Random parameters with the reference's distributions (normal ×
    1/sqrt(fan_in), embedding normal × 0.02, norm weights zero), drawn from
    ``gen`` on ``device`` (the generator's device)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"init_model: family {cfg.family!r} is not ported yet "
            "(ROADMAP.md, queue 1)")
    device = resolve_device(device)
    dt = _dtype(cfg)
    params = {
        "embedding": layers.init_embedding(gen, cfg.vocab, cfg.d_model, dt,
                                           device, cfg.tie_embeddings),
        "ln_f": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "blocks": _init_dense_blocks(gen, cfg, dt, device),
    }
    return ParamTree(params)
