"""The port's dense ``forward``, loss and gradients against the
reference's, on the CPU.

Configurations: ``gemma3-4b``'s smoke config cut to 2 layers (sliding
window 32 on both layers, qk-norm, sandwich norms, gelu, scaled embedding)
and ``qwen3-4b``'s smoke config (3 global layers, silu), float32 unless a
test says otherwise; the reference's parameter tree is drawn with numpy
(`torch_parity.lm_tree_np`) and crosses to the port as numpy.

Tolerances: the two frameworks sum matrix products and softmax rows in
other orders, so values agree to a few float32 ulps of the largest entry
per operation, and the error grows with depth: ``forward`` logits and
hidden states within 2e-5 of the largest (seen: 1.1e-6); the loss 1e-6
relative and each gradient leaf 5e-5 of its largest entry (seen: equal
losses, 2.2e-6); in bfloat16 every product and sum rounds to 8 bits in an
order of its framework's choosing, so the loss is held to 1e-3 relative
(seen: 4.2e-5) and each gradient leaf to 5e-2 of its largest entry (seen:
2.1e-2); ``cross_entropy`` within 1e-6.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import model as jmodel
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.models import model as tmodel
from repro_torch.train import train_step as tts

from torch_parity import (GEMMA_2L, QWEN, assert_rel, fast_jit, flat,
                          jloss_grad, lm_tokens, lm_tree_np, port_model_cfg)


def _jforward(cfg):
    def f(params, tokens):
        hidden, _ = jmodel.forward(params, cfg, {"tokens": tokens},
                                   return_hidden=True)
        logits, _ = jmodel.forward(params, cfg, {"tokens": tokens})
        return hidden, logits
    return fast_jit(f)


@pytest.mark.parametrize("cfg", [GEMMA_2L, QWEN], ids=["gemma3", "qwen3"])
def test_forward_matches_reference(cfg):
    tree, tokens = lm_tree_np(cfg, 1), lm_tokens(cfg, 2)
    hidden, logits = _jforward(cfg)(tree, tokens)
    params = convert.train_params_from_numpy(tree, "cpu")
    tcfg = port_model_cfg(cfg)
    with torch.no_grad():
        got_h, aux = tmodel.forward(params, tcfg, {"tokens": torch.from_numpy(tokens)},
                                    return_hidden=True)
        got_l, _ = tmodel.forward(convert.lm_params_from_numpy(tree, "cpu"), tcfg,
                                  {"tokens": torch.from_numpy(tokens)})
    assert got_l.dtype == torch.float32 and float(aux["moe_aux"]) == 0.0
    assert_rel(got_h, hidden, 2e-5)
    assert_rel(got_l, logits, 2e-5)


@pytest.mark.parametrize("dtype,loss_tol,grad_tol",
                         [("float32", 1e-6, 5e-5), ("bfloat16", 1e-3, 5e-2)],
                         ids=["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype, loss_tol, grad_tol):
    cfg = dataclasses.replace(GEMMA_2L, param_dtype=dtype)
    tree, tokens = lm_tree_np(cfg, 4), lm_tokens(cfg, 5)
    metrics, grads = jloss_grad(cfg)(tree, tokens)
    params = convert.train_params_from_numpy(tree, "cpu")
    got_g, got_m = tts.grads_and_metrics(params, port_model_cfg(cfg),
                                         {"tokens": torch.from_numpy(tokens)})
    for k in ("ce", "loss"):
        np.testing.assert_allclose(float(got_m[k]), float(metrics[k]),
                                   rtol=loss_tol, err_msg=k)
    want = flat(jax.tree.map(np.asarray, grads))
    got = flat(got_g)
    assert got.keys() == want.keys()
    assert {g.dtype for g in tckpt.tree_leaves(got_g)} == {getattr(torch, dtype)}
    for name in want:
        assert_rel(got[name], want[name], grad_tol)
    # gradient accumulation order must not leak into the parameters
    np.testing.assert_array_equal(flat(params)["embedding/embed"],
                                  np.asarray(tree["embedding"]["embed"], np.float32))


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(13)
    logits = (3 * rng.normal(size=(2, 5, 40))).astype(np.float32)
    targets = rng.integers(0, 40, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    want = fast_jit(lambda l, t, m: (jts.cross_entropy(l, t),
                                  jts.cross_entropy(l, t, m)))(logits, targets, mask)
    t = [torch.from_numpy(x) for x in (logits, targets, mask)]
    got = (tts.cross_entropy(t[0], t[1]), tts.cross_entropy(*t))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
