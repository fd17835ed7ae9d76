"""The port's optimizers, train step and resumable `Trainer` against the
reference's, on the CPU.

The model is ``gemma3-4b``'s smoke config cut to 2 layers, float32, its
parameter tree drawn with numpy (`torch_parity.lm_tree_np`).  The
reference's train step compiles once at XLA's lowest backend optimisation
level; its optimizers' updates compile with XLA's default options, under
which XLA contracts ``a * x + y`` into one multiply-add, as the port
computes it.

Tolerances:

* the optimizers, given identical gradients: AdamW's moments and
  Adam8bit's int8 codes bit for bit, Adam8bit's block scales within one
  float32 ulp (XLA picks which product of ``b * v + (1 - b) * g * g`` it
  fuses per fusion, so a moment may round one ulp apart, which its
  absmax scale shows and its rounded code absorbs); parameters within
  1e-6 of the largest (one or two ulps); Adafactor within 1e-5 (its
  factored means sum in another order);
* train steps and the `Trainer`: losses within 1e-5 relative, grad norms
  within 1e-4 relative, parameters within 1e-5 absolute (an Adam step
  moves a parameter by at most lr = 1e-3 times its warmup fraction).  An
  element past that is allowed only where one package's gradient was at
  most 1e-6 and the two gradients' signs differ: there Adam's ``m / sqrt(v)``
  is ±1 whatever the gradient's size, so the two packages move it in
  opposite directions.
"""
import dataclasses
import shutil
import time

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.optim import adam as jadam
from repro.train import train_step as jts
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adam as tadam
from repro_torch.train import train_step as tts
from repro_torch.train import trainer as ttrainer

from torch_parity import (GEMMA_2L, LM_B, LM_S, assert_rel, fast_jit, flat,
                          jloss_grad, lm_tokens, lm_tree_np, np_,
                          port_model_cfg)

LR = 1e-3


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _small_tree(rng):
    return {"blocks": {"w": rng.normal(size=(5, 6, 70)).astype(np.float32),
                       "b": rng.normal(size=(5, 6)).astype(np.float32)},
            "bias": rng.normal(size=(3,)).astype(np.float32),
            "mat": rng.normal(size=(9, 130)).astype(np.float32)}


@pytest.mark.parametrize("name", ["adamw", "adam8bit", "adafactor"])
def test_optimizers_match_reference(name, monkeypatch):
    """Three updates of a small tree given the same gradients, each leaf
    in pieces: the reference's large-leaf layer blocks and the port's row
    pieces are both cut at 100 elements."""
    monkeypatch.setattr(jadam, "_CHUNK_THRESHOLD", 100)
    monkeypatch.setattr(tadam, "_PIECE", {"cpu": 100, "cuda": 100})
    rng = np.random.default_rng(7)
    tree = _small_tree(rng)
    kw = {} if name == "adafactor" else dict(warmup=2)
    jopt, topt = jadam.OPTIMIZERS[name](lr=LR, **kw), tadam.OPTIMIZERS[name](lr=LR, **kw)
    jstate = jax.jit(jopt.init)(tree)
    jparams = tree
    params = convert.train_params_from_numpy(tree, "cpu")
    state = topt.init(params)
    upd = jax.jit(jopt.update)          # XLA's default options
    for step in range(3):
        g = jax.tree.map(lambda x: (rng.normal(size=x.shape)
                                    * (1e-3 if step else 1.0)).astype(np.float32),
                         tree)
        jparams, jstate = upd(g, jstate, jparams)
        params, state = topt.update(convert.train_params_from_numpy(g, "cpu"),
                                    state, params)
    assert int(state.step) == int(jstate.step) == 3
    for a, b in zip(tckpt.tree_leaves(params), jax.tree.leaves(jparams)):
        assert_rel(a, b, 1e-5 if name == "adafactor" else 1e-6)
    for field in state._fields[1:]:
        got = tckpt.tree_leaves(getattr(state, field))
        want = jax.tree.leaves(getattr(jstate, field))
        for a, b in zip(got, want):
            a, b = np_(a), np.asarray(b)
            assert a.dtype == b.dtype, field
            if name == "adafactor":
                np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=field)
            elif field.endswith("_scale"):
                np.testing.assert_allclose(a, b, rtol=2.0 ** -23, atol=0,
                                           err_msg=field)
            else:
                np.testing.assert_array_equal(a, b, err_msg=field)


# ---------------------------------------------------------------------------
# the train step and the trainer
# ---------------------------------------------------------------------------

_JSTEP: dict = {}


def _jstep(cfg, opt_name="adamw"):
    key = (cfg, opt_name)
    if key not in _JSTEP:
        step, _ = jts.make_train_step(cfg, jadam.OPTIMIZERS[opt_name](lr=LR))
        _JSTEP[key] = fast_jit(step)
    return _JSTEP[key]


def _jstate(tree):
    """The reference's starting AdamW state: zero moments, step 0."""
    zeros = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), tree)
    return jts.TrainState(
        params=tree, opt_state=jadam.AdamState(step=np.zeros((), np.int32),
                                               m=zeros, v=zeros),
        step=np.zeros((), np.int32))


def _grad_sign_explained(got, want, grads_j, grads_t, tol):
    """Elements of ``got`` past ``tol`` of ``want`` must sit where the two
    packages' gradients were both tiny or of opposite signs."""
    bad = np.abs(got - want) > tol
    if bad.any():
        gj, gt = grads_j[bad], grads_t[bad]
        assert np.all((np.minimum(np.abs(gj), np.abs(gt)) <= 1e-6)
                      & (np.sign(gj) != np.sign(gt))), (got[bad], want[bad])


def _check_params(got_tree, want_tree, tol=1e-5):
    got, want = flat(got_tree), flat(jax.tree.map(np.asarray, want_tree))
    assert got.keys() == want.keys()
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    return got, want, worst


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(micro):
    cfg = dataclasses.replace(GEMMA_2L, grad_microbatches=micro)
    tree = lm_tree_np(cfg, 8)
    jstep = _jstep(cfg)
    jstate = _jstate(tree)
    tstep, _ = tts.make_train_step(port_model_cfg(cfg), tadam.adamw(lr=LR))
    params = convert.train_params_from_numpy(tree, "cpu")
    state = tts.TrainState(params, tadam.adamw(lr=LR).init(params),
                           torch.zeros((), dtype=torch.int32))
    for i in range(2):
        tokens = lm_tokens(cfg, 9 + i)    # the Trainer's batch shape: one compile
        before = (jax.tree.map(np.asarray, jstate.params),
                  {k: v.clone() for k, v in tckpt._flatten(state.params)})
        jstate, jm = jstep(jstate, {"tokens": tokens})
        state, m = tstep(state, {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        got, want, worst = _check_params(state.params, jstate.params)
        if worst > 1e-5:      # explained only by tiny gradients of either sign
            assert micro == 1, worst
            prev = tckpt.tree_unflatten(state.params, list(before[1].values()))
            g_t, _ = tts.grads_and_metrics(prev, port_model_cfg(cfg),
                                           {"tokens": torch.from_numpy(tokens)})
            _, g_j = jloss_grad(cfg)(before[0], tokens)
            gj, gt = flat(jax.tree.map(np.asarray, g_j)), flat(g_t)
            for k in want:
                _grad_sign_explained(got[k], want[k], gj[k], gt[k], 1e-5)
    assert int(state.step) == int(jstate.step) == 2


def _trainer_cfgs(tmp, steps, ckpt_every=2, monitor=True, opt="adamw"):
    dkw = dict(vocab=GEMMA_2L.vocab, batch=LM_B, seq=LM_S, seed=3)
    tcfg = dict(steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(tmp),
                optimizer=opt, lr=LR, log_every=100, monitor_drift=monitor)
    return dkw, tcfg


def _port_trainer(tmp, steps, **kw):
    dkw, tcfg = _trainer_cfgs(tmp, steps, **kw)
    return ttrainer.Trainer(port_model_cfg(GEMMA_2L), DataConfig(**dkw),
                            ttrainer.TrainerConfig(**tcfg), device="cpu",
                            log_fn=lambda s: None)


def test_trainer_matches_reference_train_steps(tmp_path):
    """The port's `Trainer` (drift monitor on) over 4 steps against the
    reference's jitted train step on the same batches: losses step by step,
    then the parameters."""
    tree = lm_tree_np(GEMMA_2L, 10)
    out = _port_trainer(tmp_path, 4).run(init=tree)
    stream = JTokenStream(JDataConfig(**_trainer_cfgs(tmp_path, 4)[0]))
    jstate, losses = _jstate(tree), []
    for _ in range(4):
        jstate, jm = _jstep(GEMMA_2L)(jstate, {"tokens": stream.next_batch()})
        losses.append(float(jm["loss"]))
    hist = out["history"]
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    assert set(hist[0]) == {"step", "loss", "grad_norm", "dt", "straggler", "drift"}
    np.testing.assert_allclose([h["loss"] for h in hist], losses, rtol=1e-5)
    _, _, worst = _check_params(out["state"].params, jstate.params)
    assert worst <= 1e-5, worst
    assert int(out["state"].step) == 4


def test_trainer_resumes_bit_exact_from_its_own_checkpoint(tmp_path,
                                                           monkeypatch):
    """Run 'a' checkpoints at step 2 and at step 4; the step-2 write is held
    back until step 3 has updated the state in place, so the checkpoint
    holds step 2's values only if the writer copied them first.  Run 'b'
    stops at step 2 and resumes; run 'c' resumes from 'a's mid-run
    checkpoint.  Both end bit-identical to 'a'."""
    write, done = tckpt._write, []

    def late_write(path, keys, arrays, dtypes, step, fsync):
        deadline = time.monotonic() + 60
        while step < 4 and len(done) <= step and time.monotonic() < deadline:
            time.sleep(0.005)
        write(path, keys, arrays, dtypes, step, fsync)

    monkeypatch.setattr(tckpt, "_write", late_write)
    tree = lm_tree_np(GEMMA_2L, 11)
    tr = _port_trainer(tmp_path / "a", 4, opt="adam8bit")
    step_fn = tr._step_fn

    def counted(state, batch):
        out = step_fn(state, batch)
        done.append(1)
        return out

    tr._step_fn = counted
    whole = tr.run(init=tree)
    assert len(done) == 4
    _port_trainer(tmp_path / "b", 2, opt="adam8bit").run(init=tree)
    shutil.copytree(tmp_path / "a" / "step_2", tmp_path / "c" / "step_2")
    want = convert.train_state_to_numpy(whole["state"])
    for run in ("b", "c"):
        resumed = _port_trainer(tmp_path / run, 4,
                                opt="adam8bit").run(init=tree)
        assert [h["step"] for h in resumed["history"]] == [3, 4]
        got = convert.train_state_to_numpy(resumed["state"])
        for (ka, x), (kb, y) in zip(tckpt._flatten(want), tckpt._flatten(got)):
            assert ka == kb
            np.testing.assert_array_equal(x, y, err_msg=f"{run}: {ka}")
        assert [h["loss"] for h in whole["history"][2:]] == \
            [h["loss"] for h in resumed["history"]]


def test_trainer_resumes_from_a_reference_checkpoint(tmp_path):
    """The reference's `Trainer` runs 2 steps and checkpoints; the port's
    restores that state bit for bit and continues to the losses the
    reference's train step gives from it."""
    tree = lm_tree_np(GEMMA_2L, 12)
    dkw, tcfg = _trainer_cfgs(tmp_path, 2, monitor=False)
    jt = jtrainer.Trainer(GEMMA_2L, JDataConfig(**dkw), jtrainer.TrainerConfig(**tcfg),
                          log_fn=lambda s: None)
    jt._init_fn = lambda key: _jstate(tree)
    jt._step_jit = _jstep(GEMMA_2L)
    jout = jt.run()
    saved = jax.tree.map(np.asarray, jout["state"])
    port = _port_trainer(tmp_path, 4, monitor=False)
    restored, step = tckpt.restore(
        tmp_path / "step_2",
        {"state": port._start_state(0, tree), "stream": {"i": 0}}, "cpu")
    assert step == 2 and int(restored["stream"]["i"]) == 2
    for (k, x), (_, y) in zip(tckpt._flatten(convert.train_state_to_numpy(
            restored["state"])), tckpt._flatten(convert.train_state_to_numpy(
            convert.train_state_from_numpy(saved, "cpu")))):
        np.testing.assert_array_equal(x, y, err_msg=k)
    out = port.run(init=tree)
    assert [h["step"] for h in out["history"]] == [3, 4]
    stream = JTokenStream(JDataConfig(**dkw))
    stream.restore({"i": 2})
    jstate, losses = jout["state"], []
    for _ in range(2):
        jstate, jm = _jstep(GEMMA_2L)(jstate, {"tokens": stream.next_batch()})
        losses.append(float(jm["loss"]))
    np.testing.assert_allclose([h["loss"] for h in out["history"]], losses,
                               rtol=1e-5)
    shutil.rmtree(tmp_path)
