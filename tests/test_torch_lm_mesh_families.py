"""Training on a (data, model) mesh for the five families beyond the dense
and the GQA MoE ones, against the reference, on the CPU.

deepseek-v3-671b (MLA split by heads, the MoE layers expert-parallel, the
MTP head), zamba2-2.7b (Mamba2 split by heads, the shared block),
xlstm-125m (the mLSTM split by heads, the sLSTM gathered),
whisper-large-v3 (the encoder, the decoder's cross-attention from each
rank's encoder rows) and internvl2-76b (each rank's patches before its
text): each family's smoke config in float32, the tree drawn with numpy
(`torch_parity.lm_tree_np`), frames and patches bfloat16 as
``launch/inputs.py`` gives them, B 4 x 32 text tokens.  The port's loss and
gradients (`train_step.grads_and_metrics`) on a 2 x 2 mesh of CPU entries
are held against the reference's single-device ``jax.value_and_grad`` of
``train_step.loss_fn`` (compiled once a config, `torch_parity.XLA_FAST`):

* ``ce`` and ``mtp_ce`` within 2e-4 (the reference's own mesh bound,
  ``tests/test_distributed.py``); every gradient leaf within 1e-4 of its
  largest entry;
* zamba2's within one bfloat16 ulp of the largest, 2^-8 (the intra-chunk
  scores are rounded to bfloat16 in both packages: a score whose float32
  value moves in its last bit, as another product shape may move it,
  rounds one ulp apart);
* deepseek-v3's MoE layers run dropless (capacity factor n_experts / topk)
  and expert-parallel (`moe.moe_ep`), whose ranks sum their combine in
  bfloat16 as the reference's do: every gradient within 2e-2 of its
  largest (the router's 1e-1: it takes the gradient of the per-shard aux
  loss, an estimate of the reference's global one), and the aux loss
  equal to the per-shard estimate (the reference's ``_route`` on every
  rank's own MoE input, averaged over the ranks) within 1e-6 relative.

On a 1 x 3 mesh no head count splits three ways: deepseek-v3 (MLA, and
``moe_dense`` over the whole batch: 8 experts), zamba2 and xlstm gather
their weights and run every head on every rank, held at the same bounds
(the MoE's at 1e-4 and its aux at 1e-6 of the reference's own).

Microbatches on a mesh: whisper's step with ``grad_microbatches = 2`` on
a batch of 8 rows already split over the 2 x 2 mesh (tokens and frames)
against the reference's two microbatches' gradients averaged as its scan
does, through AdamW's first moment after one step.  The `Trainer` on the
mesh for the token-only families (hybrid, ssm, moe with MLA and MTP; two
microbatches): its first step's loss and state equal `make_train_step`'s
on the stream's first batch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import inputs as jinputs
from repro.models import moe as jmoe
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.optim import adam as tadam
from repro_torch.parallel import param_specs as tspecs
from repro_torch.parallel.sharding import make_ctx
from repro_torch.train import train_step as tts
from repro_torch.train import trainer as ttrainer

from torch_parity import assert_rel, fast_jit, flat, lm_tree_np, port_model_cfg

ARCHS = ("deepseek-v3-671b", "zamba2-2.7b", "xlstm-125m",
         "whisper-large-v3", "internvl2-76b")
BF16_TOL = 2.0 ** -8
B, TEXT = 4, 32


def _cfg(arch, **kw):
    cfg = dataclasses.replace(jregistry.get_smoke_config(arch),
                              param_dtype="float32", **kw)
    if cfg.family == "moe":       # dropless on the mesh's ranks too
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.moe_topk)
    return cfg


def _batch(cfg, seed, b=B):
    """tokens (and bfloat16 frames or patches) at the reference's shapes."""
    rng = np.random.default_rng(seed)
    seq = TEXT + (cfg.n_patches if cfg.family == "vlm" else 0)
    out = {}
    for name, (shape, _) in jinputs.batch_shapes(cfg, b, seq).items():
        if name == "tokens":
            out[name] = rng.integers(0, cfg.vocab, shape).astype(np.int32)
        else:
            out[name] = np.asarray(0.02 * rng.normal(size=shape), jnp.bfloat16)
    return out


_JREF: dict = {}


def _jref(cfg):
    """The reference's ``(metrics, grads)`` of ``loss_fn`` on one device,
    compiled once a config."""
    if cfg not in _JREF:
        ctx = jts.make_ctx(None)

        def f(params, batch):
            (_, m), g = jax.value_and_grad(
                lambda p: jts.loss_fn(p, cfg, batch, ctx), has_aux=True)(params)
            return m, g
        _JREF[cfg] = fast_jit(f)
    return _JREF[cfg]


def _mesh_grads(cfg, tree, batch, mesh, monkeypatch):
    """The port's metrics and gathered gradients on ``mesh``, and every
    rank's MoE input of each layer's forward (as numpy rows)."""
    inputs = []
    moe_ranks = tmoe.moe_ranks

    def capture(params, xs, mesh, **kw):
        inputs.append([x.detach().numpy().reshape(-1, x.shape[-1])
                       for x in xs])
        return moe_ranks(params, xs, mesh, **kw)

    monkeypatch.setattr(tmoe, "moe_ranks", capture)
    params = tspecs.shard_params(convert.train_params_from_numpy(tree, "cpu"),
                                 mesh)
    grads, m = tts.grads_and_metrics(
        params, port_model_cfg(cfg),
        convert.train_params_from_numpy(batch, "cpu"), make_ctx(mesh))
    return m, flat(tspecs.gather_params(grads, "cpu")), inputs


def _check(arch, shape, monkeypatch):
    cfg = _cfg(arch)
    tree, batch = lm_tree_np(cfg, 11), _batch(cfg, 12)
    jm, jg = _jref(cfg)(tree, batch)
    mesh = make_test_mesh(*shape, "cpu")
    m, got, inputs = _mesh_grads(cfg, tree, batch, mesh, monkeypatch)
    assert ("mtp_ce" in m) == bool(cfg.mtp_depth) == ("mtp_ce" in jm)
    for k in ("ce", "mtp_ce"):
        if k in jm:
            assert abs(float(m[k]) - float(jm[k])) < 2e-4, k
    ep = cfg.family == "moe" and tmoe._use_ep(
        {"router": torch.empty(1, cfg.n_experts)}, mesh)
    want = flat(jax.tree.map(np.asarray, jg))
    assert got.keys() == want.keys()
    for k in want:
        tol = (1e-1 if k.endswith("router") else 2e-2) if ep else \
            BF16_TOL if cfg.family == "hybrid" else 1e-4
        assert_rel(got[k], want[k], tol)
    if cfg.family != "moe":
        return
    nm = cfg.n_layers - cfg.n_dense_layers
    if not ep:              # moe_dense over the whole batch on every rank
        np.testing.assert_allclose(float(m["moe_aux"]), float(jm["moe_aux"]),
                                   rtol=1e-6)
        return
    route = fast_jit(lambda r, x: jmoe._route(r, x, cfg.moe_topk)[2])
    routers = tree["moe_blocks"]["moe"]["router"]
    aux = sum(np.mean([float(route(routers[i], x)) for x in inputs[i]])
              for i in range(nm))
    np.testing.assert_allclose(float(m["moe_aux"]),
                               aux * cfg.moe_aux_coef / nm, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_mesh_loss_and_grads_match_reference(arch, monkeypatch):
    _check(arch, (2, 2), monkeypatch)


def test_heads_that_do_not_split_gather_on_1x3(monkeypatch):
    for arch in ("deepseek-v3-671b", "zamba2-2.7b", "xlstm-125m"):
        _check(arch, (1, 3), monkeypatch)


LR = 1e-3


def test_microbatches_on_mesh_match_reference():
    # the reference's loss gradient of B rows (compiled for the family
    # test) on each of two microbatches of a 2 B batch
    ref_cfg = _cfg("whisper-large-v3")
    cfg = dataclasses.replace(ref_cfg, grad_microbatches=2)
    tree, batch = lm_tree_np(cfg, 13), _batch(cfg, 14, b=2 * B)
    ms, gs = zip(*(_jref(ref_cfg)(tree, {k: v[i * B:(i + 1) * B]
                                         for k, v in batch.items()})
                   for i in range(2)))
    # the reference's scan: float32 sums of the microbatches' gradients
    # and metrics, divided by their count
    want = {k: (a + b) / 2 for (k, a), (_, b) in zip(
        flat(jax.tree.map(np.asarray, gs[0])).items(),
        flat(jax.tree.map(np.asarray, gs[1])).items())}
    mesh = make_test_mesh(2, 2, "cpu")
    step, _ = tts.make_train_step(port_model_cfg(cfg),
                                  tadam.adamw(lr=LR, warmup=1), mesh)
    params = tspecs.shard_params(convert.train_params_from_numpy(tree, "cpu"),
                                 mesh)
    state = tts.TrainState(params, tadam.init_on_mesh(tadam.adamw(lr=LR),
                                                      params),
                           torch.zeros((), dtype=torch.int32))
    placed = tmodel.shard_batch(convert.train_params_from_numpy(batch, "cpu"),
                                mesh)
    assert placed["frames"].spec == ("data", None, None)
    state, m = step(state, placed)
    np.testing.assert_allclose(float(m["loss"]),
                               (float(ms[0]["loss"]) + float(ms[1]["loss"])) / 2,
                               rtol=1e-5)
    got = flat(tspecs.gather_params(state.opt_state.m, "cpu"))
    assert got.keys() == want.keys()
    for k in want:                      # AdamW's first moment: (1 - b1) g
        assert_rel(got[k] / 0.1, want[k], 1e-4)


def test_trainer_on_mesh_runs_token_only_families(tmp_path):
    mesh = make_test_mesh(2, 2, "cpu")
    for arch in ("zamba2-2.7b", "xlstm-125m", "deepseek-v3-671b"):
        cfg = port_model_cfg(_cfg(arch, grad_microbatches=2))
        tree = lm_tree_np(_cfg(arch), 15)
        data = DataConfig(vocab=cfg.vocab, batch=B, seq=TEXT // 2, seed=16)
        out = ttrainer.Trainer(cfg, data, ttrainer.TrainerConfig(
            steps=1, ckpt_every=0, ckpt_dir=str(tmp_path), lr=LR,
            log_every=100, monitor_drift=False), mesh=mesh,
            log_fn=lambda s: None).run(init=tree)
        step, _ = tts.make_train_step(cfg, tadam.adamw(lr=LR), mesh)
        params = tspecs.shard_params(
            convert.train_params_from_numpy(tree, "cpu"), mesh)
        state = tts.TrainState(params, tadam.init_on_mesh(
            tadam.adamw(lr=LR), params), torch.zeros((), dtype=torch.int32))
        tokens = TokenStream(data).next_batch()
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        assert out["history"][0]["loss"] == float(m["loss"]), arch
        for (k, a), (_, b) in zip(
                flat(tspecs.gather_params(out["state"].params, "cpu")).items(),
                flat(tspecs.gather_params(state.params, "cpu")).items()):
            np.testing.assert_array_equal(a, b, err_msg=f"{arch} {k}")
