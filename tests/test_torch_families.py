"""``forward``, ``loss_fn`` and every gradient leaf of the other model
families against the reference's, on the CPU, float32.

One config a family, the reference's ``smoke()`` config in float32 (remat
on, as published): deepseek-moe-16b (1 dense + 2 MoE layers, GQA),
deepseek-v3-671b (1 dense + 3 MoE layers with MLA, and the MTP head),
zamba2-2.7b (2 groups of 2 Mamba2 layers and the shared block),
xlstm-125m (2 mLSTM/sLSTM pairs), whisper-large-v3 (2 + 2 layers over 32
synthetic frames) and internvl2-76b (3 layers, 8 patches before 64 text
tokens).  The tree is drawn with numpy (`torch_parity.lm_tree_np`); the
frontends' frames and patches are bfloat16, as ``launch/inputs.py`` gives
them.  The reference's forward and loss gradient compile once a config.

Tolerances, as ``tests/test_torch_model.py`` holds the dense family (fp32
sums in another order): logits (and deepseek-v3's MTP logits) within 2e-5
of their largest value; ``ce``, ``moe_aux``, ``mtp_ce`` and ``loss``
within 1e-6 relative; every gradient leaf within 5e-5 of its largest
entry.  zamba2's Mamba2 layers round their intra-chunk scores to bfloat16
in both packages (`tests/test_torch_mamba_mla.py`): a score whose float32
value differs in its last bit between the packages rounds one bfloat16 ulp
apart, so zamba2's logits and gradients are held to one bfloat16 ulp of
their largest value, 2^-8 (seen: logits 8.6e-6, gradients 9.7e-5 on
``dt_bias``).

Then the port's `Trainer` (AdamW, drift monitor on) on deepseek-moe-16b's
smoke config over 4 steps of the reference's token stream against the
reference's train step on the same batches, its two halves compiled apart
(the loss gradient, shared with the family test, and AdamW's update):
losses within 1e-5 relative step by step (the aux loss part of each),
then the parameters within 1e-5 absolute (an Adam step moves a parameter
by at most lr = 1e-3 times its warmup fraction), as
``tests/test_torch_train.py`` holds the dense family.  A run stopped after
2 steps and resumed from its checkpoint ends bit-identical to the
uninterrupted one (Adam8bit: parameters, int8 moments, scales, step).

Each family also checks ``launch.inputs``' shapes and dtypes against the
reference's, and a bf16 train state (AdamW) crossing from the reference's
numpy tree with every leaf's dtype kept.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.launch import inputs as jinputs
from repro.models import model as jmodel
from repro.optim import adam as jadam
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import inputs as tinputs
from repro_torch.models import model as tmodel
from repro_torch.train import train_step as tts
from repro_torch.train import trainer as ttrainer

from torch_parity import (LM_B, LM_S, assert_rel, fast_jit, flat, lm_tree_np,
                          port_model_cfg)

ARCHS = ("deepseek-moe-16b", "deepseek-v3-671b", "zamba2-2.7b", "xlstm-125m",
         "whisper-large-v3", "internvl2-76b")
BF16_TOL = 2.0 ** -8


def _batch(cfg, seed, B=2, text=64):
    """tokens (and bfloat16 frames or patches) at the reference's shapes."""
    rng = np.random.default_rng(seed)
    seq = text + (cfg.n_patches if cfg.family == "vlm" else 0)
    out = {}
    for name, (shape, _) in jinputs.batch_shapes(cfg, B, seq).items():
        if name == "tokens":
            out[name] = rng.integers(0, cfg.vocab, shape).astype(np.int32)
        else:
            out[name] = np.asarray(0.02 * rng.normal(size=shape), jnp.bfloat16)
    return out


_JREF: dict = {}


def _jref(cfg):
    """The reference's (logits, MTP logits, loss metrics, gradients),
    compiled once a config."""
    if cfg not in _JREF:
        ctx = jts.make_ctx(None)

        def f(params, batch):
            logits, aux = jmodel.forward(params, cfg, batch)
            (_, m), g = jax.value_and_grad(
                lambda p: jts.loss_fn(p, cfg, batch, ctx), has_aux=True)(params)
            return logits, aux.get("mtp_logits"), m, g
        _JREF[cfg] = fast_jit(f)
    return _JREF[cfg]


def _cfg(arch):
    return dataclasses.replace(jregistry.get_smoke_config(arch),
                               param_dtype="float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_family_forward_loss_and_grads_match_reference(arch):
    cfg = _cfg(arch)
    tree, batch = lm_tree_np(cfg, 1), _batch(cfg, 2)
    logits, mtp_logits, metrics, grads = _jref(cfg)(tree, batch)
    tcfg = port_model_cfg(cfg)
    params = convert.train_params_from_numpy(tree, "cpu")
    tb = convert.train_params_from_numpy(batch, "cpu")
    with torch.no_grad():
        got_l, aux = tmodel.forward(params, tcfg, tb)
    got_g, got_m = tts.grads_and_metrics(params, tcfg, tb)
    tol = BF16_TOL if cfg.family == "hybrid" else 2e-5
    assert got_l.shape == (2, 64, cfg.vocab) and got_l.dtype == torch.float32
    assert_rel(got_l, np.asarray(logits), tol)
    assert ("mtp_logits" in aux) == (mtp_logits is not None)
    if mtp_logits is not None:
        assert_rel(aux["mtp_logits"], np.asarray(mtp_logits), tol)
    assert got_m.keys() == metrics.keys()
    for k in metrics:
        np.testing.assert_allclose(float(got_m[k]), float(metrics[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)
    want, got = flat(jax.tree.map(np.asarray, grads)), flat(got_g)
    assert got.keys() == want.keys()
    tol = BF16_TOL if cfg.family == "hybrid" else 5e-5
    for name in want:
        assert_rel(got[name], want[name], tol)

    # the port's input shapes and random batches are the reference's
    seq = 64 + (cfg.n_patches if cfg.family == "vlm" else 0)
    jshapes = jinputs.batch_shapes(cfg, 2, seq)
    tshapes = tinputs.batch_shapes(tcfg, 2, seq)
    assert {k: (shp, jnp.dtype(dt).name) for k, (shp, dt) in jshapes.items()} \
        == {k: (shp, str(dt).removeprefix("torch."))
            for k, (shp, dt) in tshapes.items()}
    made = tinputs.make_batch(tcfg, 2, seq, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in made.items()} == \
        {k: v for k, v in tshapes.items()}
    assert 0 <= int(made["tokens"].min()) and int(made["tokens"].max()) < cfg.vocab

    # a bf16 train state of this family crosses packages leaf for leaf
    # (the stacked leaves, the hybrid's (groups, layers, ...) ones, and
    # the leaves kept in float32)
    tree16 = lm_tree_np(dataclasses.replace(cfg, param_dtype="bfloat16"), 3)
    moments = jax.tree.map(lambda x: np.full(x.shape, 0.5, np.float32), tree16)
    st = convert.train_state_from_numpy(jts.TrainState(
        params=tree16, opt_state=jadam.AdamState(
            step=np.int32(2), m=moments, v=moments), step=np.int32(2)), "cpu")
    back = convert.train_state_to_numpy(st)
    for (k, x), (_, y) in zip(tckpt._flatten(st.params),
                              tckpt._flatten(tree16)):
        assert x.dtype == (torch.float32 if y.dtype == np.float32
                           else torch.bfloat16), k
    np.testing.assert_array_equal(flat(back["params"])["embedding/embed"],
                                  np.asarray(tree16["embedding"]["embed"],
                                             np.float32))
    assert int(back["step"]) == 2


LR = 1e-3


def _trainer(tmp, steps, opt, data):
    tcfg = ttrainer.TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=str(tmp),
                                  optimizer=opt, lr=LR, log_every=100)
    return ttrainer.Trainer(port_model_cfg(_cfg("deepseek-moe-16b")),
                            DataConfig(**data), tcfg, device="cpu",
                            log_fn=lambda s: None)


def test_moe_trainer_matches_reference_and_resumes(tmp_path):
    cfg = _cfg("deepseek-moe-16b")
    data = dict(vocab=cfg.vocab, batch=LM_B, seq=LM_S, seed=5)
    tree = lm_tree_np(cfg, 20)
    out = _trainer(tmp_path / "adamw", 4, "adamw", data).run(init=tree)
    opt = jadam.adamw(lr=LR)
    update = jax.jit(opt.update)          # XLA's default options
    params, opt_state = tree, jax.jit(opt.init)(tree)
    stream, losses = JTokenStream(JDataConfig(**data)), []
    for _ in range(4):
        *_, m, g = _jref(cfg)(params, {"tokens": stream.next_batch()})
        params, opt_state = update(g, opt_state, params)
        losses.append(float(m["loss"]))
        assert float(m["moe_aux"]) > 0
    hist = out["history"]
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    assert all("drift" in h for h in hist)
    np.testing.assert_allclose([h["loss"] for h in hist], losses, rtol=1e-5)
    got, want = flat(out["state"].params), flat(jax.tree.map(np.asarray, params))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)

    # stopped after 2 steps, resumed from its checkpoint: bit for bit
    whole = _trainer(tmp_path / "a", 4, "adam8bit", data).run(init=tree)
    _trainer(tmp_path / "b", 2, "adam8bit", data).run(init=tree)
    resumed = _trainer(tmp_path / "b", 4, "adam8bit", data).run(init=tree)
    assert [h["step"] for h in resumed["history"]] == [3, 4]
    want = convert.train_state_to_numpy(whole["state"])
    got = convert.train_state_to_numpy(resumed["state"])
    for (ka, x), (kb, y) in zip(tckpt._flatten(want), tckpt._flatten(got)):
        assert ka == kb
        np.testing.assert_array_equal(x, y, err_msg=ka)
    assert [h["loss"] for h in whole["history"][2:]] == \
        [h["loss"] for h in resumed["history"]]
