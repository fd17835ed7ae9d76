"""Batched decode on a ``(data, model)`` mesh against the reference's
one-device decode, on the CPU.

Specs: the port's ``kv_cache.cache_axes`` / ``cache_specs`` against the
reference's on ``AbstractMesh``es (2, 4), (1, 4) and (pod 2, data 16, model
16), for every configuration's full-size cache (sketch signatures and
whisper's 1500-frame cross cache included) at B = 1 and B = 128.

Decode, float32, every branch on a 2 x 2 mesh of CPU entries: one numpy
tree (`torch_parity.lm_tree_np`) and one cache with a random prefix of
``start`` tokens (random k / v / latents and block signatures; random
Mamba2 states and conv tails) go to the reference's one-device
``make_serve_step``, to the port's one-device step and to the port's mesh
step (weights placed by ``param_specs``, the cache by ``cache_specs``).
gemma3-4b with the sketch at B = 1 (the sequence over ``(data, model)``:
four blocks of one sketch block each, the 32-token windows crossing from
one rank's block into the next's, two ranks empty), qwen3-4b at B = 4 (the
batch over ``data``), internvl2-76b with the sketch (every layer global),
deepseek-moe-16b (GQA, ``moe_ep``) and deepseek-v3-671b (MLA, B = 1),
zamba2-2.7b (Mamba2 heads over ``model``), xlstm-125m (replicated states)
and whisper-large-v3 (its 32-frame cross cache split over ``model``).
Bounds: logits within 1e-5 of their largest value at every step; every
float cache leaf within 1e-5 of its largest value (as the one-device tests
hold it), and k / v and latents within 3e-6 of the port's one-device
cache, the bfloat16 cross cache within one bf16 ulp; block signatures equal; the
mesh's ``last_live`` equal to the port's one-device lists.  The partials'
plain versions merged over 1, 2 and 4 ranks (a rank with nothing live, a
rank with only the current block) against the reference's
``decode_attention``, and the refusals (unplaced weights, a rank's block
of the sequence that is not whole sketch blocks, a full cache); the train
step on a mesh, which refused five families before they trained there,
builds for each of them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jregistry
from repro.serve import kv_cache as jkv
from repro.serve import serve_step as jserve
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ops, ref
from repro_torch.kernels.sketch_decode_attn import block_mask, compact_live
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as tmodel
from repro_torch.optim import adam as tadam
from repro_torch.parallel import param_specs, sharding
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import serve_step as tserve
from repro_torch.train import train_step as tts

from torch_parity import assert_rel, fast_jit, lm_tree_np, port_model_cfg

STEPS = 3
SPEC_MESHES = (((2, 4), ("data", "model")), ((1, 4), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")))
# (arch, B, s_max, start): every decode branch
RUNS = {
    "dense": [("gemma3-4b", 1, 2048, 1534), ("qwen3-4b", 4, 64, 30)],
    "vlm": [("internvl2-76b", 2, 2048, 1022)],
    "moe": [("deepseek-moe-16b", 2, 64, 30), ("deepseek-v3-671b", 1, 64, 30)],
    "recurrent": [("zamba2-2.7b", 2, 64, 30), ("xlstm-125m", 2, 64, 0)],
    "encdec": [("whisper-large-v3", 2, 64, 30)],
}
SEQ = ("k", "v", "dk", "dv", "c", "kr")


def test_cache_specs_match_reference_on_every_config():
    for sizes, names in SPEC_MESHES:
        jmesh = AbstractMesh(sizes, names)
        tmesh = sharding.Mesh(("cpu",) * int(np.prod(sizes)),
                              axis_names=names, axis_sizes=sizes)
        for arch in tregistry.ARCH_IDS:
            cfg = jregistry.get_config(arch)
            tcfg = tregistry.get_config(arch)
            for B in (1, 128):
                ja, jsa = jkv.cache_axes(cfg, B, jmesh)
                assert tkv.cache_axes(tcfg, B, tmesh) == (ja, jsa)
                shapes = jax.eval_shape(
                    lambda: jkv.init_cache(cfg, B, 8192, sketch=True))
                want = {k: tuple(v.spec) for k, v in
                        jkv.cache_specs(shapes, cfg, B, jmesh).items()}
                meta = tkv.init_cache(tcfg, B, 8192, sketch=True,
                                      device="meta")
                assert tkv.cache_specs(meta, tcfg, B, tmesh) == want, \
                    (arch, B, sizes)
    # whisper's cross cache splits at model 2 and 4 (1500 frames), not 16
    cfg = tregistry.get_config("whisper-large-v3")
    for sizes, split in (((1, 2), "model"), ((1, 4), "model"),
                         ((1, 16), None)):
        mesh = sharding.Mesh(("cpu",) * sizes[1], ("data", "model"), sizes)
        spec = tkv.leaf_spec("xk", (32, 8, 1500, 20, 64), cfg, 8, mesh)
        assert spec == (None, "data", split, None, None)
    # init on a mesh: each rank's block a tensor of its own, replicas too
    cfg = tregistry.get_smoke_config("zamba2-2.7b")
    mesh = make_test_mesh(2, 2, "cpu")
    cache = tkv.init_cache(cfg, 2, 64, mesh=mesh)
    one = tkv.init_cache(cfg, 2, 64, device="cpu")
    for name, leaf in cache.items():
        if name == "length":
            continue
        assert leaf.shape == tuple(one[name].shape)
        ptrs = {s.data_ptr() for s in leaf.shards}
        assert len(ptrs) == mesh.size, name
    assert tkv.cache_bytes(cache) == tkv.cache_bytes(one)
    # a one-device cache placed with its leaves in any order: a key-sorted
    # tree puts conv_buf, whose dim 1 is attn_every, first
    for B, sizes in ((1, (2, 2)), (4, (4, 1))):
        mesh = make_test_mesh(*sizes, "cpu")
        one = dict(sorted(tkv.init_cache(cfg, B, 64, device="cpu").items()))
        assert next(iter(one)) == "conv_buf" and cfg.attn_every != B
        placed = tkv.shard_cache(one, cfg, mesh)
        want = tkv.cache_specs(one, cfg, B, mesh)
        for name, leaf in placed.items():
            if name != "length":
                assert leaf.spec == want[name], (name, B, sizes)


def _inject(cache: dict, start: int, rng) -> dict:
    """The zero reference cache with a random prefix of ``start`` tokens."""
    out = {}
    for name, v in cache.items():
        v = np.array(v)
        if name in SEQ and start:
            v[:, :, :start] = rng.normal(size=v[:, :, :start].shape)
        elif name == "block_sigs":
            nb = start // tkv.SKETCH_BLOCK + 1
            v[:, :, :nb] = rng.random(v[:, :, :nb].shape) < 0.5
        elif name in ("ssm_state", "conv_buf") and start:
            v[...] = rng.normal(size=v.shape)
        elif name == "length":
            v = np.int32(start)
        out[name] = v
    return out


def _one_run(arch, B, s_max, start):
    cfg = dataclasses.replace(jregistry.get_smoke_config(arch),
                              param_dtype="float32")
    tcfg = port_model_cfg(cfg)
    sketch = cfg.family in ("dense", "vlm") and s_max >= 2048
    rng = np.random.default_rng(11)
    tree = lm_tree_np(cfg, 12)
    cache = _inject(jax.tree.map(np.asarray, jkv.init_cache(
        cfg, B, s_max, sketch=sketch)), start, rng)
    mesh = make_test_mesh(2, 2, "cpu")
    params_j = jax.tree.map(jnp.asarray, tree)
    params_1 = convert.lm_params_from_numpy(tree, "cpu")
    params_m = param_specs.shard_params(params_1.to_dict(), mesh)
    cache_j = jax.tree.map(jnp.asarray, cache)
    cache_1 = convert.lm_cache_from_numpy(cache, "cpu")
    cache_m = convert.lm_cache_from_numpy(cache, mesh=mesh, cfg=tcfg)
    assert cache_m["length"] == start
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, cfg.enc_frames, cfg.d_model)).astype(
            np.float32)
        cache_j = fast_jit(lambda p, f, c: jserve.encode_cross_cache(
            p, cfg, f, c))(params_j, frames, cache_j)
        cache_1 = tserve.encode_cross_cache(params_1, tcfg,
                                            torch.from_numpy(frames), cache_1)
        cache_m = tserve.encode_cross_cache(params_m, tcfg,
                                            torch.from_numpy(frames), cache_m)
        assert cache_m["xk"].spec[2] == "model"
    step_j = fast_jit(jserve.make_serve_step(cfg, sketch=sketch))
    step_1 = tserve.make_serve_step(tcfg, sketch=sketch)
    step_m = tserve.make_serve_step(tcfg, sketch=sketch, mesh=mesh)
    tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    for _ in range(STEPS):
        lj, cache_j = step_j(params_j, cache_j, tok)
        _, cache_1 = step_1(params_1, cache_1, torch.from_numpy(tok))
        lm, cache_m = step_m(params_m, cache_m, torch.from_numpy(tok))
        lj = np.asarray(lj)
        assert lm.shape == lj.shape == (B, 1, cfg.vocab)
        assert lm.dtype == torch.float32
        assert_rel(lm, lj, 1e-5)
        assert len(step_m.last_live) == len(step_1.last_live)
        for (ia, na), (ib, nb) in zip(step_m.last_live, step_1.last_live):
            assert torch.equal(na, nb) and torch.equal(ia, ib)
        tok = lj.argmax(-1).astype(np.int32)
    if sketch:
        assert len(step_m.last_live) == sum(
            w == 0 for w in tmodel.window_pattern(tcfg))
    got = convert.lm_cache_to_numpy(cache_m)
    one = convert.lm_cache_to_numpy(cache_1)
    assert got.pop("length") == int(cache_j["length"]) == start + STEPS
    for name, w in cache_j.items():
        if name == "length":
            continue
        w, g = np.asarray(w), got[name]
        assert g.shape == w.shape, name
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name in ("xk", "xv"):      # bfloat16 in both: one ulp
            w = w.astype(np.float32)
            assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w)).all(), name
        else:
            fin = np.isfinite(w)
            assert (np.isfinite(g) == fin).all(), name
            assert_rel(g[fin], w[fin].astype(np.float32), 1e-5)
            # against the port's one device: the written rows at 3e-6
            assert_rel(g[fin], one[name][fin], 3e-6 if name in SEQ else 1e-5)
    if cfg.family == "ssm":         # the replicas stay equal, bit for bit
        for name in ("mlstm_C", "slstm_h"):
            shards = cache_m[name].shards
            assert all(torch.equal(s, shards[0]) for s in shards[1:])


@pytest.mark.parametrize("group", list(RUNS))
def test_mesh_decode_matches_reference(group):
    for run in RUNS[group]:
        _one_run(*run)


def test_partials_merged_match_reference_decode_attention():
    rng = np.random.default_rng(5)
    B, S, Hkv, G, dh, blk = 2, 64, 2, 2, 16, 16
    q = rng.normal(size=(B, 1, Hkv * G, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    length = 50                         # current block 3
    live = np.zeros((B, S // blk), bool)
    live[:, 0] = live[:, 3] = True      # blocks 1, 2 pruned
    live[1, 0] = False                  # row 1: only the current block
    extra = np.repeat(live, blk, axis=1)[:, None, None, :]
    decode = jax.jit(jserve.decode_attention,
                     static_argnames=("window", "softcap"))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    for window, mask, softcap in ((0, extra, 0.0), (0, extra, 30.0),
                                  (20, None, 0.0)):
        want = np.asarray(decode(q, k, v, jnp.int32(length), window=window,
                                 softcap=softcap, extra_mask=mask))
        for n in (1, 2, 4):
            mesh = sharding.Mesh(("cpu",) * n, ("model",))
            size = S // n
            parts = []
            for r in range(n):
                s0 = r * size
                kr, vr = kt[:, s0:s0 + size], vt[:, s0:s0 + size]
                if mask is None:
                    parts.append(tserve.decode_attention_partial(
                        qt, kr, vr, length, s0, window=window,
                        softcap=softcap))
                    continue
                ids, n_live = compact_live(torch.from_numpy(
                    live[:, s0 // blk:(s0 + size) // blk]))
                kv_len = min(max(length + 1 - s0, 0), size)
                o, lse = ops.sketch_decode_attn_partial(
                    qt.reshape(B, Hkv, G, dh), kr, vr, ids, n_live, kv_len,
                    blk, softcap)
                if n == 4 and r in (1, 2):      # nothing live
                    assert torch.isneginf(lse).all() and not o.any()
                parts.append((o, lse))
            got = sharding.merge_partials(parts, mesh, "model")
            for t in got:
                assert_rel(t.reshape(B, 1, -1), want, 2e-6)
    # the plain version over the whole cache equals the merged partials
    whole = ref.sketch_decode_attn_ref(
        qt.reshape(B, Hkv, G, dh), kt, vt, torch.from_numpy(live),
        length + 1, blk)
    o, lse = ref.sketch_decode_attn_partial_ref(
        qt.reshape(B, Hkv, G, dh), kt, vt, torch.from_numpy(live),
        length + 1, blk)
    torch.testing.assert_close(o, whole, rtol=1e-6, atol=1e-6)
    assert torch.isfinite(lse).all()
    assert block_mask(*compact_live(torch.from_numpy(live)),
                      S // blk).numpy().tolist() == live.tolist()


def test_mesh_refusals():
    mesh = make_test_mesh(2, 2, "cpu")
    for arch in ("zamba2-2.7b", "xlstm-125m", "whisper-large-v3",
                 "internvl2-76b", "deepseek-v3-671b"):
        step, init = tts.make_train_step(tregistry.get_smoke_config(arch),
                                         tadam.adamw(), mesh)
        assert callable(step) and callable(init)
    # a rank's sketch block must be whole 512-token blocks
    cfg = dataclasses.replace(tregistry.get_smoke_config("gemma3-4b"),
                              param_dtype="float32")
    cache = tkv.init_cache(cfg, 1, 1024, sketch=True, mesh=mesh)
    tree = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = tserve.make_serve_step(cfg, sketch=True, mesh=mesh)
    tok = torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="shard_params"):
        step(tree, cache, tok)
    params = param_specs.shard_params(tree, mesh)
    with pytest.raises(ValueError, match="sketch blocks"):
        step(params, cache, tok)
    # a full cache has no room for another token
    cache = tkv.init_cache(cfg, 2, 8, mesh=mesh)
    cache["length"] = 8
    with pytest.raises(ValueError, match="no room"):
        tserve.make_serve_step(cfg, mesh=mesh)(
            params, cache, torch.zeros((2, 1), dtype=torch.int64))
