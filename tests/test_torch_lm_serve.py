"""The port's batched decode step against the reference's, end to end on the
CPU, at the reference's smoke configs.

Both packages start from one injected state: parameters in the layout of
the reference's ``init_model`` (norm weights nonzero, so their ``1 + w``
scale matters), K/V
random up to position 600 of a 1024-token cache (two sketch blocks), and
block signatures in which block 0 is sparse (at most 8 bits) for request 0
and dense for request 1, so request 0's global layers prune block 0.  Four
tokens are decoded in each.  float32: logits within 1e-5 of their largest
value, the K/V the four steps wrote within 3e-6 of their largest entry
(fp32 sums run in another order in XLA and in torch, and the difference
grows through each attention layer: 1.34e-6 after qwen3's three layers),
the injected K/V unchanged in both, block signatures equal
except at bits that the sign-boundary rule explains (0 on these seeds), and
every global layer's live blocks equal to the reference's (read from its
``sketch_block_mask``).  bfloat16: logits within the reference's own 3e-2
(tests/test_serve.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model as jmodel
from repro.serve import serve_step as jserve
from repro_torch import convert
from repro_torch.checkpoint.checkpoint import tree_map
from repro_torch.configs import registry as tregistry
from repro_torch.models import model as tmodel
from repro_torch.parallel import param_specs
from repro_torch.parallel.sharding import Mesh, make_ctx
from repro_torch.serve import serve_step as tserve

S, B, LEN0, STEPS, BLOCK = 1024, 2, 600, 4, 512


def _params(cfg, seed):
    """The reference ``init_model``'s parameter tree (its names, shapes and
    dtypes, from ``jax.eval_shape``) drawn with numpy at its distributions:
    normal / sqrt(fan_in) matrices, embedding normal * 0.02, and norm
    weights 0.1 * normal where the reference has zeros, so that their
    ``1 + w`` scale matters.  (Running the reference's own random init
    compiles for ~8 s a config on one core.)"""
    shapes = jax.eval_shape(lambda k: jmodel.init_model(cfg, k),
                            jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name.startswith("ln") or name.endswith("_norm"):
            x = 0.1 * rng.normal(size=leaf.shape)
        elif name == "embed":
            x = 0.02 * rng.normal(size=leaf.shape)
        else:
            x = rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[-2])
        return np.asarray(x.astype(np.float32), leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _state(cfg, seed, sketch):
    rng = np.random.default_rng(seed + 100)
    L, Hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = jnp.bfloat16 if cfg.param_dtype == "bfloat16" else np.float32
    kv = []
    for _ in range(2):
        x = np.zeros((L, B, S, Hkv, dh), np.float32)
        x[:, :, :LEN0] = rng.normal(size=(L, B, LEN0, Hkv, dh))
        kv.append(np.asarray(x, dt))
    cache = {"length": np.int32(LEN0), "k": kv[0], "v": kv[1]}
    if sketch:
        sigs = rng.random((L, B, S // BLOCK, 64)) < 0.5
        sigs[:, 0, 0] = False                       # request 0: sparse block 0
        for layer in range(L):
            sigs[layer, 0, 0, rng.choice(64, size=8, replace=False)] = True
        sigs[:, 1, 0] = rng.random((L, 64)) < 0.9   # request 1: dense block 0
        cache["block_sigs"] = sigs
    return cache


def _run(arch, monkeypatch, dtype="float32", sketch=True, seed=0):
    cfg = dataclasses.replace(jregistry.get_smoke_config(arch), param_dtype=dtype)
    tcfg = dataclasses.replace(tregistry.get_smoke_config(arch), param_dtype=dtype)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    tree, cache = _params(cfg, seed), _state(cfg, seed, sketch)
    tokens = np.random.default_rng(seed + 200).integers(0, cfg.vocab, (B, STEPS))

    masks = []
    orig = jserve.sketch_block_mask

    def recording(q, sigs, length):
        m = orig(q, sigs, length)
        jax.debug.callback(lambda m: masks.append(np.asarray(m)), m)
        return m

    monkeypatch.setattr(jserve, "sketch_block_mask", recording)
    step_j = jax.jit(jserve.make_serve_step(cfg, sketch=sketch))
    params_j = jax.tree.map(jnp.asarray, tree)
    cache_j = jax.tree.map(jnp.asarray, cache)
    step_t = tserve.make_serve_step(tcfg, sketch=sketch)
    params_t = convert.lm_params_from_numpy(tree, device="cpu")
    cache_t = convert.lm_cache_from_numpy(cache, device="cpu")
    out = {"logits": [], "live_t": [], "cfg": tcfg}
    for t in range(STEPS):
        lj, cache_j = step_j(params_j, cache_j, jnp.asarray(tokens[:, t:t + 1]))
        lt, cache_t = step_t(params_t, cache_t, torch.from_numpy(tokens[:, t:t + 1]))
        jax.effects_barrier()
        out["logits"].append((lt.numpy(), np.asarray(lj)))
        out["live_t"].append([(ids.numpy(), n.numpy()) for ids, n in step_t.last_live])
    assert cache_t["length"] == int(cache_j["length"]) == LEN0 + STEPS
    out.update(cache_t=convert.lm_cache_to_numpy(cache_t),
               cache_j={k: np.asarray(v, np.float32) if k in ("k", "v")
                        else np.asarray(v) for k, v in cache_j.items()},
               masks=masks, tokens=tokens)
    return out


def _check_fp32(r, sketch):
    cfg = r["cfg"]
    for lt, lj in r["logits"]:
        assert lt.shape == lj.shape == (B, 1, cfg.vocab)
        assert np.abs(lt - lj).max() <= 1e-5 * np.abs(lj).max()
    new = np.zeros(S, bool)
    new[LEN0:LEN0 + STEPS] = True
    for name in ("k", "v"):
        a, b = r["cache_t"][name], r["cache_j"][name]
        assert np.abs(a[:, :, new] - b[:, :, new]).max() <= 3e-6 * np.abs(b[:, :, new]).max(), name
        np.testing.assert_array_equal(a[:, :, ~new], b[:, :, ~new])
    if not sketch:
        assert "block_sigs" not in r["cache_t"]
        return
    # block signatures: a bit may differ only where one of the new keys'
    # projections is at the sign boundary (none does on these seeds)
    new_k = torch.from_numpy(r["cache_t"]["k"][:, :, LEN0:LEN0 + STEPS])
    L, _, T, Hkv, dh = new_k.shape
    mean = tserve._head_mean(new_k.reshape(L * B, T, Hkv, dh)).reshape(L, B, T, dh)
    near = tserve.sig_near_boundary(mean, tserve._sig_proj(mean.shape[-1]))
    near_blk = np.zeros(r["cache_t"]["block_sigs"].shape, bool)
    for t in range(STEPS):
        near_blk[:, :, (LEN0 + t) // BLOCK] |= near[:, :, t].numpy()
    diff = r["cache_t"]["block_sigs"] != r["cache_j"]["block_sigs"]
    assert not (diff & ~near_blk).any()
    assert not diff.any()
    # live blocks of every global layer, step and request
    glob = [i for i, w in enumerate(tserve.model_lib.window_pattern(cfg)) if w <= 0]
    nb = S // BLOCK
    assert len(r["masks"]) == STEPS * L
    pruned = 0
    for t in range(STEPS):
        assert len(r["live_t"][t]) == len(glob)
        in_range = np.arange(nb) * BLOCK < LEN0 + t + 1
        for (ids, n), layer in zip(r["live_t"][t], glob):
            want = r["masks"][t * L + layer][:, 0, 0, ::BLOCK] & in_range
            for b in range(B):
                got = set(ids[b, :n[b]].tolist())
                assert got == set(np.nonzero(want[b])[0].tolist()), (t, layer, b)
                assert (ids[b, n[b]:] == -1).all()
                pruned += len(got) < in_range.sum()
    assert pruned > 0                       # the injected state did prune


@pytest.mark.parametrize("arch", ["gemma3-4b", "gemma2-27b"])
def test_sketch_decode_matches_reference(arch, monkeypatch):
    _check_fp32(_run(arch, monkeypatch), sketch=True)


def test_plain_decode_matches_reference_qwen3(monkeypatch):
    _check_fp32(_run("qwen3-4b", monkeypatch, sketch=False), sketch=False)


def test_sketch_decode_bf16_within_reference_bound(monkeypatch):
    r = _run("gemma3-4b", monkeypatch, dtype="bfloat16")
    for lt, lj in r["logits"]:
        assert np.isfinite(lt).all()
        assert np.abs(lt - lj).max() < 3e-2 * max(np.abs(lj).max(), 1.0)
    assert r["cache_t"]["k"].dtype == np.float32      # bf16 values, exact


def test_registry_lists_only_ported_configs():
    """Every architecture of the reference is listed, decodes and runs its
    forward (deepseek-v3's with the MTP head), on one device and on a
    (data, model) mesh (MLA split by heads), where weights not placed by
    ``param_specs`` are refused."""
    assert set(tregistry.ARCH_IDS) == set(jregistry.ARCH_IDS)
    cfg = tregistry.get_smoke_config("deepseek-v3-671b")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with torch.no_grad():
        logits, aux = tmodel.forward(params, cfg, {"tokens": tokens})
    assert logits.shape == aux["mtp_logits"].shape == (1, 4, cfg.vocab)
    mesh = Mesh(("cpu",) * 2, axis_names=("data", "model"), axis_sizes=(1, 2))
    with pytest.raises(ValueError, match="shard_params"):
        tmodel.forward(params, cfg, {"tokens": tokens}, ctx=make_ctx(mesh))
    # in float32 the mesh's logits are the one device's but for the MoE
    # ranks' bfloat16 combine (moe_ep's bound: 2e-2 of the largest)
    cfg = dataclasses.replace(cfg, param_dtype="float32")
    params = tree_map(lambda x: x.float(), params)
    with torch.no_grad():
        want, waux = tmodel.forward(params, cfg, {"tokens": tokens})
        got, gaux = tmodel.forward(param_specs.shard_params(params, mesh), cfg,
                                   {"tokens": tokens}, ctx=make_ctx(mesh))
    for a, b in ((got, want), (gaux["mtp_logits"], waux["mtp_logits"])):
        assert float((a.full("cpu") - b).abs().max()) <= \
            2e-2 * float(b.abs().max())
