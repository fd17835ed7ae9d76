"""Every model family's init, cache and batched decode against the
reference's, on the CPU.

Trees: the port's ``init_params`` and ``init_cache`` give the names, shapes
and dtypes of ``jax.eval_shape`` of the reference's ``init_model`` and
``init_cache`` (sketch signatures included) for all ten smoke configs.

Decode, float32, for the seven configs the dense tests do not cover: one
numpy tree (`torch_parity.lm_tree_np`) and one zero cache go to both
packages (whisper's cross cache filled by each package's
``encode_cross_cache`` from the same frames; internvl2 with sketch
attention on, so every layer runs `sketch_decode_attn`'s plain version),
then 8 greedy steps from the reference's tokens.  Logits within 1e-5 of
their largest value at every step; every cache leaf within 1e-5 of its
largest value (fp32 sums in another order, growing through depth and
steps; the MoE routes equal, as the logits show; the bfloat16 cross cache
within one bf16 ulp), the -inf stabilisers
replaced by finite values in both, block signatures equal, and ``length``
equal.  The caches cross through `convert.lm_cache_from_numpy` and
`lm_cache_to_numpy`, which keep float32 and -inf leaves and an int
``length``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model as jmodel
from repro.serve import kv_cache as jkv
from repro.serve import serve_step as jserve
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.models import model as tmodel
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import serve_step as tserve

from torch_parity import assert_rel, f32, fast_jit, lm_tree_np, port_model_cfg

B, STEPS = 2, 8
NEW = ["deepseek-moe-16b", "deepseek-v3-671b", "granite-8b", "internvl2-76b",
       "whisper-large-v3", "xlstm-125m", "zamba2-2.7b"]


def _shapes(tree) -> dict:
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in leaves}


def _torch_shapes(tree) -> dict:
    def walk(d, pre):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from walk(v, pre + f"['{k}']")
            elif isinstance(v, torch.Tensor):
                yield pre + f"['{k}']", (tuple(v.shape),
                                         str(v.dtype).split(".")[1])
    return dict(walk(tree, ""))


@pytest.mark.parametrize("arch", tregistry.ARCH_IDS)
def test_init_params_and_cache_match_reference_shapes(arch):
    assert set(tregistry.ARCH_IDS) == set(jregistry.ARCH_IDS)
    cfg = jregistry.get_smoke_config(arch)
    tcfg = tregistry.get_smoke_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    want = _shapes(jax.eval_shape(lambda k: jmodel.init_model(cfg, k),
                                  jax.random.PRNGKey(0)))
    got = _torch_shapes(tmodel.init_params(
        tcfg, torch.Generator().manual_seed(0), "cpu"))
    assert got == want
    want = _shapes(jax.eval_shape(
        lambda: jkv.init_cache(cfg, B, 1024, sketch=True)))
    cache = tkv.init_cache(tcfg, B, 1024, sketch=True, device="cpu")
    assert cache.pop("length") == 0
    assert want.pop("['length']") == ((), "int32")
    assert _torch_shapes(cache) == want


def _within_one_bf16_ulp(got, want):
    """The cross cache is bfloat16 in both packages (the reference casts
    it), so an element whose fp32 value lies near a rounding boundary may
    round one bf16 ulp (2^-7 of its magnitude, at most) either way."""
    want = np.asarray(want, np.float32)
    assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want)).all()


@pytest.mark.parametrize("arch", NEW)
def test_decode_matches_reference(arch):
    cfg = dataclasses.replace(jregistry.get_smoke_config(arch),
                              param_dtype="float32")
    tcfg = port_model_cfg(cfg)
    sketch = cfg.family == "vlm"
    s_max = 1024 if sketch else 64
    tree = lm_tree_np(cfg, 7)
    cache = jax.tree.map(np.asarray, jkv.init_cache(cfg, B, s_max, sketch=sketch))
    params_j = jax.tree.map(jnp.asarray, tree)
    params_t = convert.lm_params_from_numpy(tree, "cpu")
    cache_j = jax.tree.map(jnp.asarray, cache)
    cache_t = convert.lm_cache_from_numpy(cache, "cpu")
    assert cache_t["length"] == 0 and isinstance(cache_t["length"], int)
    for name in ("mlstm_m", "slstm_m"):
        if name in cache:
            assert torch.isneginf(cache_t[name]).all()
            assert cache_t[name].dtype == torch.float32
    if cfg.family == "encdec":
        frames = np.random.default_rng(8).normal(
            size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        cache_j = fast_jit(lambda p, f, c: jserve.encode_cross_cache(
            p, cfg, f, c))(params_j, frames, cache_j)
        cache_t = tserve.encode_cross_cache(params_t, tcfg,
                                            torch.from_numpy(frames), cache_t)
        for name in ("xk", "xv"):
            assert cache_t[name].dtype == torch.bfloat16
            _within_one_bf16_ulp(f32(cache_t[name]), cache_j[name])
    step_j = fast_jit(jserve.make_serve_step(cfg, sketch=sketch))
    step_t = tserve.make_serve_step(tcfg, sketch=sketch)
    tok = np.random.default_rng(9).integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    for _ in range(STEPS):
        lj, cache_j = step_j(params_j, cache_j, tok)
        lt, cache_t = step_t(params_t, cache_t, torch.from_numpy(tok))
        lj = np.asarray(lj)
        assert lt.shape == lj.shape == (B, 1, cfg.vocab)
        assert_rel(lt, lj, 1e-5)
        tok = lj.argmax(-1).astype(np.int32)
    if sketch:
        assert len(step_t.last_live) == cfg.n_layers   # every layer global
    got = convert.lm_cache_to_numpy(cache_t)
    assert got.pop("length") == int(cache_j["length"]) == STEPS
    want = {k: np.asarray(v) for k, v in cache_j.items() if k != "length"}
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        assert g.dtype == np.float32, name
        assert np.isfinite(w).all() and np.isfinite(g).all(), name
        if name in ("xk", "xv"):
            _within_one_bf16_ulp(g, w)
        else:
            assert_rel(g, w.astype(np.float32), 1e-5)
