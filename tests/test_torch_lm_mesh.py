"""LM training on a (data, model) mesh against the reference, on the CPU.

A mesh here is `launch.mesh.make_test_mesh(n_data, n_model, "cpu")`: every
rank on the CPU, one controller.  Weights and inputs are drawn with numpy
(`torch_parity.lm_tree_np`); no reference ``init_model`` runs.

* the qwen3-4b smoke step (fp32, ``seq_parallel=True``, B 8 x S 32,
  AdamW) on a 2 x 4 mesh (``wq`` / ``wo`` split on whole heads, ``wk`` /
  ``wv`` mid-head: their columns of the heads needed gathered) and on a
  1 x 3 mesh (no split falls on whole heads or FFN columns: every weight
  gathered) against the reference's single-device step at the reference's
  own bounds (``tests/test_distributed.py``): loss within 2e-4, every
  parameter within ``rtol 2e-4, atol 2e-5``, at a learning rate (1e-3, no
  warmup) whose one step moves a parameter 50 times ``atol``; the
  gradients (AdamW's first moment after one step, ``(1 - b1) g``) leaf by
  leaf within 1e-4 of each leaf's largest.  Where the two gradients differ
  by more than half the reference's (their signs may differ) or the
  reference's is under 100 eps, the step's update ``g / (|g| + eps)`` may
  take either sign, and the parameter is held within the bound plus
  ``2 lr``;
* the deepseek-moe-16b smoke step (cut to one MoE layer, capacity loose
  enough that nothing drops) on the 2 x 4 mesh (``moe_ep``) against
  the reference's single-device step: the cross-entropy within 2e-4; the
  aux loss against the per-shard estimate (the reference's ``_route`` on
  every rank's own MoE input, averaged over the ranks; within 1e-6
  relative); the gradients within 2e-2 of each leaf's largest (the
  ranks' bf16 combine, at ``moe_ep``'s bf16 bound; the router's within
  1e-1: it takes the gradient of the per-shard aux, an estimate of the
  global one the reference holds within 5e-2); the parameters as above;
* Adam8bit on the 2 x 4 mesh, two updates of given gradients, equal bit
  for bit to the port's single-device update and against the reference's:
  equal int8 codes, scales within two float32 roundings, parameters
  within 1e-6 of each leaf's largest, on a leaf whose split falls on whole
  64-element quantisation blocks (updated rank by rank) and on leaves
  whose split falls inside one (updated whole);
* ``moe_ep`` against the reference's ``moe_dense`` at ``capacity_factor``
  64 and its bf16 bounds (``rtol / atol 2e-2``, mean error < 5e-3, aux
  within 5e-2) (on a model axis of 1, ``moe`` runs ``moe_dense`` over the
  whole batch: within 1e-5), and at a binding capacity (factor 1) against the
  reference's ``_dispatch_compute_combine`` called per rank with that
  rank's ``e_lo``, the ranks' outputs added in bf16: the same (token,
  slot) pairs dropped, outputs within one bf16 rounding;
* ``compressed_pmean`` against the reference's under ``jax.vmap(...,
  axis_name="data")`` on one CPU device: equal int8 codes, reduced values
  within 1e-6, the reference's 20-step error-feedback bound and byte
  ratio;
* a `Trainer` (Adam8bit) interrupted on a 2 x 2 mesh and resumed from
  its gathered checkpoint, bit-identical to an unbroken run on the mesh
  (which, at ``ckpt_every`` 0, writes no checkpoint);
* the refusals: the `Trainer` (which feeds tokens only) refuses the
  families whose batches also hold a frontend's outputs (whisper's frames,
  internvl2's patches; they train on a mesh through ``make_train_step``,
  `tests/test_torch_lm_mesh_families.py`); a mesh of more cards than are
  visible raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import moe as jmoe
from repro.models import layers as jlayers
from repro.optim import adam as jadam
from repro.optim import compress as jcompress
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe as tmoe
from repro_torch.optim import adam as tadam
from repro_torch.optim import compress as tcompress
from repro_torch.parallel import param_specs as tspecs
from repro_torch.parallel.sharding import Mesh, make_ctx, shard_tensor
from repro_torch.train import train_step as tts
from repro_torch.train import trainer as ttrainer

from torch_parity import assert_rel, fast_jit, lm_tree_np, port_model_cfg

LR = 1e-3


def _cfg(arch, **kw):
    return dataclasses.replace(jregistry.get_smoke_config(arch),
                               param_dtype="float32", **kw)


def _ref_state(tree):
    params = jax.tree.map(jnp.asarray, tree)
    return jts.TrainState(params=params,
                          opt_state=jadam.adamw(lr=LR, warmup=1).init(params),
                          step=jnp.zeros((), jnp.int32))


_REF_STEP: dict = {}


def _ref_step(cfg):
    if cfg not in _REF_STEP:
        _REF_STEP[cfg] = fast_jit(jts.make_train_step(
            cfg, jadam.adamw(lr=LR, warmup=1))[0])
    return _REF_STEP[cfg]


def _mesh_step(cfg, tree, tokens, mesh):
    """The port's one AdamW step of the reference's initial state on
    ``mesh``: (gathered state as numpy, metrics)."""
    step, _ = tts.make_train_step(port_model_cfg(cfg),
                                  tadam.adamw(lr=LR, warmup=1), mesh)
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, _ref_state(tree)), mesh=mesh)
    state, m = step(state, {"tokens": torch.from_numpy(tokens)})
    return convert.train_state_to_numpy(state), m


def _sign_free(ga, gb):
    """Where one AdamW step's update ``g / (|g| + eps)`` may differ
    between two gradients (first moments) ``ga`` and ``gb``: their
    difference over half of ``|gb|`` (the signs may differ), or ``|gb|``
    under 1e-7 (a gradient under 100 eps).  Elsewhere the two updates lie
    within 1e-2 of each other, 1e-5 of a parameter at lr 1e-3."""
    return (np.abs(ga - gb) > 0.5 * np.abs(gb)) | (np.abs(gb) <= 1e-7)


def _assert_step_close(got, jstate, gtol):
    """The gradients (AdamW's first moment after one step) leaf by leaf
    within ``gtol(name)`` of each leaf's largest; the parameters within
    the reference's ``rtol 2e-4, atol 2e-5``, but where the update's sign
    is free (`_sign_free`) within that bound plus ``2 LR``."""
    want = jax.tree.map(np.asarray, {"params": jstate.params,
                                     "m": jstate.opt_state.m})
    for (k, a), (_, b), (_, ga), (_, gb) in zip(
            tckpt._flatten(got["params"]), tckpt._flatten(want["params"]),
            tckpt._flatten(got["opt_state"]["m"]),
            tckpt._flatten(want["m"])):
        top = np.abs(gb).max()
        assert np.abs(ga - gb).max() <= gtol(k) * top, k
        free = _sign_free(ga, gb)
        bound = 2e-5 + 2e-4 * np.abs(b) + np.where(free, 2 * LR, 0.0)
        assert (np.abs(a - b) <= bound).all(), k


@pytest.mark.parametrize("shape", [(2, 4), (1, 3)])
def test_sharded_qwen_step_matches_reference(shape):
    cfg = _cfg("qwen3-4b", seq_parallel=True)
    tree = lm_tree_np(cfg, 0)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (8, 32)).astype(
        np.int32)
    jstate, jm = _ref_step(cfg)(_ref_state(tree), {"tokens": tokens})
    mesh = make_test_mesh(*shape, "cpu")
    assert tspecs.param_shardings(convert.train_params_from_numpy(tree, "cpu"),
                                  mesh)["blocks"]["attn"]["wk"] == (
        (None, "data", "model") if shape == (2, 4) else (None, "data", None))
    got, m = _mesh_step(cfg, tree, tokens, mesh)
    assert abs(float(m["loss"]) - float(jm["loss"])) < 2e-4
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    _assert_step_close(got, jstate, lambda k: 1e-4)


def test_sharded_moe_step_ce_and_per_shard_aux(monkeypatch):
    cfg = _cfg("deepseek-moe-16b", capacity_factor=64.0, n_layers=1,
               n_dense_layers=0)
    tree = lm_tree_np(cfg, 2)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (8, 32)).astype(
        np.int32)
    jstate, jm = _ref_step(cfg)(_ref_state(tree), {"tokens": tokens})

    inputs = []
    moe_ranks = tmoe.moe_ranks

    def capture(params, xs, mesh, **kw):
        inputs.append([x.detach().numpy().reshape(-1, x.shape[-1])
                       for x in xs])
        return moe_ranks(params, xs, mesh, **kw)

    monkeypatch.setattr(tmoe, "moe_ranks", capture)
    got, m = _mesh_step(cfg, tree, tokens, make_test_mesh(2, 4, "cpu"))
    assert abs(float(m["ce"]) - float(jm["ce"])) < 2e-4
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    _assert_step_close(got, jstate,
                       lambda k: 1e-1 if k.endswith("router") else 2e-2)

    nm = cfg.n_layers - cfg.n_dense_layers
    assert len(inputs) >= nm            # the backward recomputes them too
    route = fast_jit(lambda r, x: jmoe._route(r, x, cfg.moe_topk)[2])
    routers = tree["moe_blocks"]["moe"]["router"]
    aux = sum(np.mean([float(route(routers[i], x)) for x in inputs[i]])
              for i in range(nm))
    want = aux * cfg.moe_aux_coef / nm
    np.testing.assert_allclose(float(m["moe_aux"]), want, rtol=1e-6)


def test_adam8bit_on_mesh_matches_reference():
    rng = np.random.default_rng(9)
    n = lambda *s: (rng.normal(size=s) * 0.02).astype(np.float32)
    tree = {"blocks": {"mlp": {"w_up": n(2, 64, 512), "w_down": n(2, 512, 64)},
                       "attn": {"wk": n(2, 64, 96)}},
            "embedding": {"embed": n(256, 64)}}
    mesh = make_test_mesh(2, 4, "cpu")
    jopt = jadam.adam8bit(lr=LR, warmup=1)
    topt = tadam.adam8bit(lr=LR, warmup=1)
    params = tspecs.shard_params(convert.train_params_from_numpy(tree, "cpu"),
                                 mesh)
    # w_up splits its last axis into 128 columns a rank: whole blocks,
    # updated rank by rank; w_down's 32 and wk's 24 fall inside a block
    straddles = {k: tadam._straddles_blocks([x]) for k, x in tckpt._flatten(
        params)}
    assert straddles == {"blocks/attn/wk": True, "blocks/mlp/w_down": True,
                         "blocks/mlp/w_up": False, "embedding/embed": False}
    assert params["blocks"]["mlp"]["w_up"].shards[0].shape[-1] == 128
    state = tadam.init_on_mesh(topt, params)
    one = convert.train_params_from_numpy(tree, "cpu")
    one_state = topt.init(one)
    jparams, jstate = tree, fast_jit(jopt.init)(tree)
    upd = fast_jit(jopt.update)
    for step in range(2):
        # the second step's gradients of another scale
        g = jax.tree.map(lambda x: (rng.normal(size=x.shape) * (
            1e-3 if step else 1.0)).astype(np.float32), tree)
        jparams, jstate = upd(g, jstate, jparams)
        gt = convert.train_params_from_numpy(g, "cpu")
        params, state = topt.update(tspecs.shard_params(
            gt, mesh, tspecs.specs_of(params)), state, params)
        one, one_state = topt.update(gt, one_state, one)
    assert int(state.step) == int(jstate.step) == 2
    got = convert.train_state_to_numpy(tts.TrainState(params, state,
                                                      state.step))
    # the mesh's update is the port's single-device update, bit for bit
    single = convert.train_state_to_numpy(tts.TrainState(one, one_state,
                                                         one_state.step))
    for (k, a), (_, b) in zip(tckpt._flatten(got), tckpt._flatten(single)):
        np.testing.assert_array_equal(a, b, err_msg=k)
    # and the reference's: the same codes, scales within two float32
    # roundings (the port's single-device update's distance too)
    for (k, a), (_, b) in zip(tckpt._flatten(got["params"]),
                              tckpt._flatten(jax.tree.map(np.asarray,
                                                          jparams))):
        assert_rel(a, b, 1e-6)
    for field in ("m_codes", "v_codes", "m_scale", "v_scale"):
        for (k, a), (_, b) in zip(
                tckpt._flatten(got["opt_state"][field]),
                tckpt._flatten(jax.tree.map(np.asarray,
                                            getattr(jstate, field)))):
            assert a.dtype == b.dtype, (field, k)
            if field.endswith("_scale"):
                np.testing.assert_allclose(a, b, rtol=2.0 ** -22, atol=0,
                                           err_msg=f"{field} {k}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{field} {k}")


def _moe_layer(seed, d=32, E=8, f=16):
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32)
    return {"router": n(d, E), "w_gate": n(E, d, f), "w_up": n(E, d, f),
            "w_down": n(E, f, d),
            "shared": {"w_up": n(d, f), "w_gate": n(d, f), "w_down": n(f, d)}}


def test_moe_ep_matches_reference_dense_and_per_rank_dispatch():
    p = _moe_layer(0)
    k, E, M = 2, 8, 4
    x = np.random.default_rng(1).normal(size=(4, 16, 32)).astype(np.float32)
    mesh = make_test_mesh(2, M, "cpu")
    ctx = make_ctx(mesh)
    sh = tspecs.shard_params(convert.train_params_from_numpy(
        {"moe": p}, "cpu"), mesh)["moe"]
    assert sh["w_gate"].spec == ("model", "data", None)
    assert sh["w_down"].spec == ("model", None, "data")
    xs = ctx.constrain(torch.from_numpy(x), "batch", None, None)

    # dropless: against moe_dense at the reference's bf16 bounds
    y_d, aux_d = fast_jit(lambda p, x: jmoe.moe_dense(
        p, x, topk=k, capacity_factor=64.0))(p, x)
    y, aux = tmoe.moe(sh, xs, topk=k, capacity_factor=64.0, ctx=ctx)
    y = y.full("cpu").numpy()
    np.testing.assert_allclose(y, np.asarray(y_d), rtol=2e-2, atol=2e-2)
    assert np.abs(y - np.asarray(y_d)).mean() < 5e-3
    np.testing.assert_allclose(float(aux), float(aux_d), rtol=5e-2)
    # a model axis of 1: moe_dense over the whole batch on every rank
    dmesh = make_test_mesh(2, 1, "cpu")
    dctx = make_ctx(dmesh)
    y1, aux1 = tmoe.moe(tspecs.shard_params(convert.train_params_from_numpy(
        {"moe": p}, "cpu"), dmesh)["moe"],
        dctx.constrain(torch.from_numpy(x), "batch", None, None),
        topk=k, capacity_factor=64.0, ctx=dctx)
    np.testing.assert_allclose(y1.full("cpu").numpy(), np.asarray(y_d),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux1), float(aux_d), rtol=1e-6)

    # binding capacity: each rank's dispatch as the reference's
    cf, E_l = 1.0, E // M
    y, _ = tmoe.moe(sh, xs, topk=k, capacity_factor=cf, ctx=ctx)
    y = y.full("cpu").numpy()
    route = fast_jit(lambda r, x: jmoe._route(r, x, k))
    C = int(np.ceil(x.shape[1] * 2 * k / E * cf))
    dispatch = fast_jit(lambda pl, x, w, idx, e_lo: jmoe._dispatch_compute_combine(
        pl, x, w, idx, e_lo, E_l, C))
    shared = fast_jit(jlayers.mlp)
    dropped = 0
    for d in range(2):
        xd = x[2 * d:2 * d + 2].reshape(-1, 32)
        w, idx, _ = route(p["router"], xd)
        _, idx_t, _ = tmoe._route(torch.from_numpy(p["router"]),
                                  torch.from_numpy(xd), k)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx))
        acc = None
        for m in range(M):
            pl = {n: p[n][m * E_l:(m + 1) * E_l]
                  for n in ("w_gate", "w_up", "w_down")}
            part = dispatch(pl, xd, w, idx, jnp.int32(m * E_l))
            part = part.astype(jnp.bfloat16)
            acc = part if acc is None else acc + part
            # kept pairs: one slot's weight 1, the rest 0; a dropped pair
            # reads the dump row (zeros)
            kept = np.stack([np.abs(np.asarray(dispatch(
                pl, xd, jnp.eye(k, dtype=jnp.float32)[j][None].repeat(
                    xd.shape[0], 0), idx, jnp.int32(m * E_l))))
                .sum(-1) > 0 for j in range(k)], 1)
            local = (np.asarray(idx) >= m * E_l) & (np.asarray(idx) < (m + 1) * E_l)
            _, _, ok = tmoe._capacity_slots(idx_t, m * E_l, E_l, C)
            np.testing.assert_array_equal(ok.numpy().reshape(-1, k), kept & local)
            dropped += int((local & ~kept).sum())
        want = np.asarray(acc.astype(jnp.float32)) + np.asarray(
            shared(p["shared"], xd))
        np.testing.assert_allclose(y[2 * d:2 * d + 2].reshape(-1, 32), want,
                                   rtol=2e-2, atol=2e-2)
        assert np.abs(y[2 * d:2 * d + 2].reshape(-1, 32) - want).mean() < 1e-3
    assert dropped > 0                  # the capacity binds


def test_compressed_pmean_matches_reference():
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 4, 130)))
    ref = fast_jit(jax.vmap(lambda g, e: (
        *jcompress.compressed_psum_leaf(g, e, "data"),
        jcompress._q(g + e)[0]), axis_name="data"))
    mesh = Mesh(("cpu",) * 8, axis_names=("data",))
    err_t = tcompress.init_error_state([{"w": torch.tensor(x)} for x in g])
    err_j = np.zeros_like(g)
    tot_t = np.zeros_like(g[0])
    tot_exact = np.zeros_like(g[0])
    for i in range(20):
        gi = (g * (1 + 0.01 * i)).astype(np.float32)
        red_j, err_j2, codes_j = ref(gi, err_j)
        codes_t = [tcompress._q(torch.from_numpy(gi[r]) + e["w"])[0]
                   for r, e in enumerate(err_t.err)]
        np.testing.assert_array_equal(np.stack([c.numpy() for c in codes_t]),
                                      np.asarray(codes_j))
        red_t, err_t = tcompress.compressed_pmean(
            [{"w": torch.from_numpy(x)} for x in gi], err_t, mesh, "data")
        red = np.stack([r["w"].numpy() for r in red_t])
        np.testing.assert_allclose(red, np.asarray(red_j), rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.stack([e["w"].numpy() for e in err_t.err]),
                                   np.asarray(err_j2), rtol=0, atol=1e-6)
        err_j = np.asarray(err_j2)
        tot_t += red[0]
        tot_exact += gi.mean(0)
    rel = np.abs(tot_t - tot_exact).max() / np.abs(tot_exact).max()
    assert rel < 0.02
    exact_b, comp_b = tcompress.bytes_saved_per_step({"w": torch.from_numpy(g[0])})
    assert (exact_b, comp_b) == jcompress.bytes_saved_per_step({"w": g[0]})
    assert comp_b < 0.3 * exact_b


def test_trainer_resumes_on_mesh_bit_exact(tmp_path):
    cfg = port_model_cfg(_cfg("qwen3-4b", n_layers=2))
    data = DataConfig(vocab=cfg.vocab, batch=4, seq=16)
    mesh = make_test_mesh(2, 2, "cpu")
    tree = lm_tree_np(_cfg("qwen3-4b", n_layers=2), 4)

    def run(d, steps, every):
        t = ttrainer.Trainer(cfg, data, ttrainer.TrainerConfig(
            steps=steps, ckpt_every=every, ckpt_dir=str(d),
            optimizer="adam8bit", lr=LR, log_every=100, monitor_drift=False),
            mesh=mesh, log_fn=lambda s: None)
        return t.run(init=tree)

    whole = run(tmp_path / "a", 2, 0)       # writes no checkpoint
    assert tckpt.latest_step(tmp_path / "a") is None
    run(tmp_path / "b", 1, 1)
    resumed = run(tmp_path / "b", 2, 1)
    assert [h["step"] for h in resumed["history"]] == [2]
    assert resumed["history"][0]["loss"] == whole["history"][-1]["loss"]
    a = convert.train_state_to_numpy(whole["state"])
    b = convert.train_state_to_numpy(resumed["state"])
    for (k, x), (_, y) in zip(tckpt._flatten(a), tckpt._flatten(b)):
        np.testing.assert_array_equal(x, y, err_msg=k)
    # the checkpoint is the gathered tree in the reference's layout
    like = {"state": tspecs.meta_like(whole["state"]),
            "stream": ttrainer.TokenStream(data).state()}
    got, step = tckpt.restore(tmp_path / "b" / "step_2", like, "cpu")
    assert step == 2
    np.testing.assert_array_equal(
        got["state"].params["blocks"]["attn"]["wq"].numpy(),
        a["params"]["blocks"]["attn"]["wq"])


def test_mesh_refusals(tmp_path):
    mesh = make_test_mesh(2, 2, "cpu")
    for arch in ("whisper-large-v3", "internvl2-76b"):
        cfg = port_model_cfg(_cfg(arch))
        with pytest.raises(ValueError, match="feeds tokens only"):
            ttrainer.Trainer(cfg, DataConfig(vocab=cfg.vocab, batch=4, seq=16),
                             ttrainer.TrainerConfig(ckpt_dir=str(tmp_path)),
                             mesh=mesh, log_fn=lambda s: None)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="cards"):
            make_test_mesh(2, 2)
    ctx = make_ctx(mesh)
    assert ctx.spec("batch", "seq_sp", "heads") == ("data", "model", "model")
    assert ctx.named("batch", None).spec == ("data", None)
    x = torch.arange(24.0).reshape(4, 6)
    s = ctx.constrain(x, "batch", "heads")
    assert s.spec == ("data", "model")
    assert torch.equal(s.shards[3], x[2:4, 3:6])
    t = ctx.constrain(s, "batch", None)
    assert torch.equal(t.shards[3], x[2:4]) and torch.equal(t.full(), x)
    with pytest.raises(ValueError, match="split"):
        shard_tensor(torch.zeros(3, 4), ("data", None), mesh)
