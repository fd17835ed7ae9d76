"""KV and state caches for batched decode, every family.

Counterpart of the reference's ``serve/kv_cache.py``.  Stacked on the layer
axis, as the reference's ``lax.scan`` reads them:

  dense/vlm : ``k``/``v`` (L, B, S, Hkv, dh)
  moe       : the dense layers' ``dk``/``dv`` and the MoE layers' ``k``/``v``;
              with MLA, the latent cache ``c`` (L, B, S, d_c) and the shared
              rotary key ``kr`` (L, B, S, r) instead of ``k``/``v``
  hybrid    : the Mamba2 state ``ssm_state`` (G, E, B, H, N, P) fp32 and conv
              tails ``conv_buf`` (G, E, B, K-1, C), and the shared attention
              block's per-group ``k``/``v`` (G, B, S, Hkv, dh)
  ssm       : the mLSTM ``mlstm_C`` / ``_n`` / ``_m`` and sLSTM ``slstm_c`` /
              ``_n`` / ``_h`` / ``_m`` states per pair, fp32, the
              stabilisers ``m`` at -inf
  encdec    : the decoder's self ``k``/``v`` and the cross ``xk``/``xv``
              (L, B, enc_frames, Hkv, dh), which `serve_step.
              encode_cross_cache` fills

With sketch attention on, per-block SRP signatures ``block_sigs (L_sig, B,
S // SKETCH_BLOCK, SIG_BITS)`` bool ride along (DESIGN.md §5.4), ``L_sig``
the leading size of ``k`` (or ``n_layers`` without one), as the reference
allocates them; only the dense and vlm decode reads them.

On a ``(data, model)`` mesh (``mesh=``, a `parallel.sharding.Mesh`) each
leaf is a `parallel.sharding.Sharded` placed per `cache_specs`, the
reference's placement: the batch over the data axes (``pod``, ``data``)
when it divides them, the cache's sequence over ``model``, or over
``(data, model)`` with the batch replicated when it does not (``long_500k``'s
B = 1); Mamba2's ``ssm_state`` split by heads over ``model``; the block
signatures split by batch and replicated over the sequence; every other
leaf (the conv tails, the xLSTM states) replicated; the cross caches split
over the sequence only where ``enc_frames`` divides those axes.  Each rank's
block is a tensor of its own on its device, replicas included.

``length`` (the number of tokens decoded so far, shared by every request of
the batch as the reference's 0-d ``cache["length"]`` is) is a Python int, so
that a decode step never reads a device scalar back to the host.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..core.util import resolve_device
from ..parallel.sharding import (Mesh, Sharded, axis_size, canonical,
                                 check_spec, shard_tensor)

SIG_BITS = 64
SKETCH_BLOCK = 512


def cache_axes(cfg: ModelConfig, B: int, mesh: Optional[Mesh]):
    """``(batch axes, sequence axes)`` of the cache for a batch of ``B``:
    the data axes and ``("model",)`` when ``B`` divides the data axes, else
    None (the batch replicated) and the sequence over ``(data, model)``;
    ``(None, None)`` without a mesh."""
    if mesh is None:
        return None, None
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp_size = math.prod(mesh.shape[a] for a in dp) if dp else 1
    if B % max(dp_size, 1) == 0 and B >= dp_size:
        return dp, ("model",)
    return None, tuple(a for a in ("data", "model") if a in mesh.axis_names)


def _on(mesh: Mesh, axes):
    """A spec entry of the axes (a name or a tuple) that ``mesh`` has."""
    if axes is None:
        return None
    names = axes if isinstance(axes, tuple) else (axes,)
    return canonical(tuple(a for a in names if a in mesh.axis_names))


def leaf_spec(name: str, shape: tuple, cfg: ModelConfig, B: int,
              mesh: Mesh) -> tuple:
    """The spec of cache leaf ``name`` of ``shape`` (the reference's
    ``cache_specs``, leaf by leaf)."""
    ba, sa = cache_axes(cfg, B, mesh)

    def div(axes, dim):
        if axes is None:
            return None
        return axes if dim % axis_size(mesh, axes) == 0 else None

    if name in ("k", "v", "dk", "dv", "xk", "xv"):
        spec = (None, div(ba, shape[1]), div(sa, shape[2]), None, None)
    elif name in ("c", "kr"):
        spec = (None, ba, sa, None)
    elif name == "ssm_state":
        spec = (None, None, ba, "model", None, None)
    elif name == "block_sigs":
        spec = (None, ba, None, None)
    else:
        spec = (None,) * len(shape)
    return tuple(_on(mesh, a) for a in spec)


def cache_specs(cache: dict, cfg: ModelConfig, B: int, mesh: Mesh) -> dict:
    """The spec of every leaf of ``cache`` (anything with a ``shape``; a
    `Sharded` cache's global shapes): `leaf_spec`'s, ``()`` for ``length``
    (the reference's replicated scalar)."""
    return {name: () if name == "length"
            else leaf_spec(name, tuple(x.shape), cfg, B, mesh)
            for name, x in cache.items()}


def init_cache(cfg: ModelConfig, B: int, s_max: int, sketch: bool = False,
               device="cuda", mesh: Optional[Mesh] = None) -> dict:
    """The zero cache (the xLSTM stabilisers at -inf) for ``B`` requests of
    up to ``s_max`` tokens on ``device``, or with a ``mesh`` one block a
    rank on each rank's device per `cache_specs`."""
    if mesh is not None:
        return _init_on_mesh(cfg, B, s_max, sketch, mesh)
    device = resolve_device(device)
    dt = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    f32 = dict(dtype=torch.float32, device=device)

    def kv(L, S):
        shape = (L, B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        return torch.zeros(shape, dtype=dt, device=device)

    cache: dict = {"length": 0}
    if cfg.family in ("dense", "vlm"):
        cache["k"], cache["v"] = kv(cfg.n_layers, s_max), kv(cfg.n_layers, s_max)
    elif cfg.family == "moe":
        nd, nm = cfg.n_dense_layers, cfg.n_layers - cfg.n_dense_layers
        if nd:
            cache["dk"], cache["dv"] = kv(nd, s_max), kv(nd, s_max)
        if cfg.use_mla:
            cache["c"] = torch.zeros((nm, B, s_max, cfg.mla_d_c), dtype=dt,
                                     device=device)
            cache["kr"] = torch.zeros((nm, B, s_max, cfg.mla_rope_dim),
                                      dtype=dt, device=device)
        else:
            cache["k"], cache["v"] = kv(nm, s_max), kv(nm, s_max)
    elif cfg.family == "hybrid":
        G, E = cfg.n_layers // cfg.attn_every, cfg.attn_every
        d_in = cfg.ssm_expand * cfg.d_model
        H = d_in // cfg.ssm_head_dim
        conv_ch = d_in + 2 * cfg.ssm_state
        cache["ssm_state"] = torch.zeros(
            (G, E, B, H, cfg.ssm_state, cfg.ssm_head_dim), **f32)
        cache["conv_buf"] = torch.zeros((G, E, B, cfg.ssm_conv - 1, conv_ch),
                                        dtype=dt, device=device)
        cache["k"], cache["v"] = kv(G, s_max), kv(G, s_max)
    elif cfg.family == "ssm":
        pairs = cfg.n_layers // 2
        Pm = 2 * cfg.d_model // cfg.n_heads
        cache["mlstm_C"] = torch.zeros((pairs, B, cfg.n_heads, Pm, Pm), **f32)
        cache["mlstm_n"] = torch.zeros((pairs, B, cfg.n_heads, Pm), **f32)
        cache["mlstm_m"] = torch.full((pairs, B, cfg.n_heads), float("-inf"),
                                      **f32)
        for name in ("c", "n", "h", "m"):
            fill = float("-inf") if name == "m" else 0.0
            cache[f"slstm_{name}"] = torch.full((pairs, B, cfg.d_model), fill,
                                                **f32)
    elif cfg.family == "encdec":
        cache["k"], cache["v"] = kv(cfg.n_layers, s_max), kv(cfg.n_layers, s_max)
        cache["xk"] = kv(cfg.n_layers, cfg.enc_frames)
        cache["xv"] = kv(cfg.n_layers, cfg.enc_frames)
    else:
        raise ValueError(cfg.family)
    if sketch:
        L_sig = cache["k"].shape[0] if "k" in cache else cfg.n_layers
        nb = s_max // SKETCH_BLOCK
        cache["block_sigs"] = torch.zeros((L_sig, B, nb, SIG_BITS),
                                          dtype=torch.bool, device=device)
    return cache


def _init_on_mesh(cfg: ModelConfig, B: int, s_max: int, sketch: bool,
                  mesh: Mesh) -> dict:
    """`init_cache` on ``mesh``: the leaves' shapes, dtypes and fills from
    the one-device cache on the meta device, each rank's block made on its
    device."""
    like = init_cache(cfg, B, s_max, sketch, device="meta")
    cache: dict = {"length": 0}
    for name, x in like.items():
        if name == "length":
            continue
        shape = tuple(x.shape)
        spec = check_spec(shape, leaf_spec(name, shape, cfg, B, mesh), mesh)
        fill = float("-inf") if name in ("mlstm_m", "slstm_m") else 0
        block = tuple(n // axis_size(mesh, ax) for n, ax in zip(shape, spec))
        cache[name] = Sharded([torch.full(block, fill, dtype=x.dtype,
                                          device=dev) for dev in mesh.devices],
                              spec, mesh, shape)
    return cache


def batch_dim(name: str) -> int:
    """The batch dim of cache leaf ``name``: 2 of Mamba2's ``(G, E, B, ...)``
    ``ssm_state`` and ``conv_buf``, else 1."""
    return 2 if name in ("ssm_state", "conv_buf") else 1


def shard_cache(cache: dict, cfg: ModelConfig, mesh: Mesh) -> dict:
    """A one-device cache (of any device, the host's included, its leaves in
    any order) placed on ``mesh`` per `cache_specs`: each rank's block a
    tensor of its own."""
    B = next(v.shape[batch_dim(k)] for k, v in cache.items() if k != "length")
    specs = cache_specs(cache, cfg, B, mesh)
    return {k: v if k == "length" else shard_tensor(v, specs[k], mesh)
            for k, v in cache.items()}


def cache_bytes(cache: dict) -> int:
    """Bytes of the cache's tensors; of a `Sharded` leaf, one copy of each
    distinct block."""
    n = 0
    for x in cache.values():
        if isinstance(x, Sharded):
            n += sum(s.numel() * s.element_size() for _, s in x.distinct())
        elif isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
    return n
