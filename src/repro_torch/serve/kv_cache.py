"""KV cache construction for batched decode (dense family).

Counterpart of the reference's ``serve/kv_cache.py``: ``k`` and ``v`` of
``(L, B, S, Hkv, dh)`` in the parameter dtype, and with sketch attention on,
per-block SRP signatures ``block_sigs (L, B, S // SKETCH_BLOCK, SIG_BITS)``
bool (DESIGN.md §5.4).  There is no mesh: the cache lives on one device.

``length`` (the number of tokens decoded so far, shared by every request of
the batch as the reference's 0-d ``cache["length"]`` is) is a Python int, so
that a decode step never reads a device scalar back to the host.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.util import resolve_device

SIG_BITS = 64
SKETCH_BLOCK = 512


def init_cache(cfg: ModelConfig, B: int, s_max: int, sketch: bool = False,
               device="cuda") -> dict:
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"init_cache: family {cfg.family!r} is not ported yet "
            "(ROADMAP.md, queue 1)")
    device = resolve_device(device)
    dt = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    shape = (cfg.n_layers, B, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {"length": 0,
             "k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if sketch:
        nb = s_max // SKETCH_BLOCK
        cache["block_sigs"] = torch.zeros((cfg.n_layers, B, nb, SIG_BITS),
                                          dtype=torch.bool, device=device)
    return cache


def cache_bytes(cache: dict) -> int:
    return sum(x.numel() * x.element_size() for x in cache.values()
               if isinstance(x, torch.Tensor))
