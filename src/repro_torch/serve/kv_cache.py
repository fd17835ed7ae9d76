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
allocates them; only the dense and vlm decode reads them.  There is no
mesh: the cache lives on one device.

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


def cache_bytes(cache: dict) -> int:
    return sum(x.numel() * x.element_size() for x in cache.values()
               if isinstance(x, torch.Tensor))
