"""The port's MoE and MLA layers against the reference's, on the CPU.

``moe_dense`` at S > 1 in float32, with capacity factor 1.0 (tokens
dropped) and 8.0: outputs within 1e-5 of their largest value (fp32 sums in
another order), route ids equal except at a detected near tie (two
probabilities within 1e-6 of each other; the outputs are then compared on
the tokens before the first such tie, whose routes and capacity ranks do
not depend on it), aux loss within 1e-6 relative.  MLA: ``mla_latent`` and
``mla_queries`` within 1e-6 of their largest value, and 8 steps of the
absorbed decode block (the reference's ``_mla_decode_block``, the port's
``_mla_block`` on one rank) with its latent cache within 1e-5.  A bfloat16 MoE decode (deepseek-moe-16b's smoke config, 4 steps)
within the reference's own bf16 bound, 3e-2 of the largest logit
(tests/test_serve.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.serve import kv_cache as jkv
from repro.serve import serve_step as jserve
from repro_torch import convert
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import serve_step as tserve

from torch_parity import assert_rel, f32, fast_jit, lm_tree_np, port_model_cfg

_T = torch.from_numpy
TIE = 1e-6


def _moe_params(seed, d=64, E=8, f=32, shared=1):
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32)
    p = {"router": n(d, E), "w_gate": n(E, d, f), "w_up": n(E, d, f),
         "w_down": n(E, f, d)}
    if shared:
        p["shared"] = {"w_up": n(d, shared * f), "w_gate": n(d, shared * f),
                       "w_down": n(shared * f, d)}
    return p


def _first_tie(ids_t, ids_j, probs):
    """The first token whose route differs between the packages (len if
    none); every difference must be a near tie of the two experts'
    probabilities."""
    rows, cols = np.nonzero(ids_t != ids_j)
    for t, j in zip(rows, cols):
        a, b = probs[t, ids_t[t, j]], probs[t, ids_j[t, j]]
        assert abs(a - b) <= TIE, f"route differs at ({t}, {j}) without a tie"
    return int(rows.min()) if len(rows) else ids_t.shape[0]


@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_moe_dense_matches_reference(cf):
    p = _moe_params(0)
    B, S, k, E = 2, 16, 2, 8
    x = np.random.default_rng(1).normal(size=(B, S, 64)).astype(np.float32)
    y_j, aux_j = fast_jit(lambda p, x: jmoe.moe_dense(
        p, x, topk=k, capacity_factor=cf))(p, x)
    w_j, ids_j, _ = fast_jit(lambda r, x: jmoe._route(r, x, k))(
        p["router"], x.reshape(B * S, 64))
    pt = convert.train_params_from_numpy(p, "cpu")
    y_t, aux_t = tmoe.moe_dense(pt, _T(x), topk=k, capacity_factor=cf)
    w_t, ids_t, _ = tmoe._route(pt["router"], _T(x).reshape(B * S, 64), k)

    probs = torch.softmax(_T(x).reshape(B * S, 64).double()
                          @ _T(p["router"]).double(), -1).numpy()
    ids_t, ids_j = ids_t.numpy(), np.asarray(ids_j)
    first = _first_tie(ids_t, ids_j, probs)
    assert first == B * S                  # no near tie on this seed
    assert_rel(w_t, np.asarray(w_j), 1e-6)
    C = int(np.ceil(B * S * k / E * cf))
    counts = np.bincount(ids_j.reshape(-1), minlength=E)
    assert (counts > C).any() == (cf == 1.0)      # cf 1.0 drops tokens
    y_j = np.asarray(y_j).reshape(B * S, 64)[:first]
    assert_rel(y_t.reshape(B * S, 64)[:first], y_j, 1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    # without a mesh the entry point is the dense path (a mesh runs moe_ep:
    # tests/test_torch_lm_mesh.py)
    y_e, aux_e = tmoe.moe(pt, _T(x), topk=k, capacity_factor=cf)
    assert torch.equal(y_e, y_t) and torch.equal(aux_e, aux_t)


def test_mla_latent_queries_and_decode_block_match_reference():
    cfg = dataclasses.replace(jregistry.get_smoke_config("deepseek-v3-671b"),
                              param_dtype="float32")
    tcfg = port_model_cfg(cfg)
    tree = lm_tree_np(cfg, 3)
    blk = {k: v for k, v in tree["moe_blocks"].items() if k != "moe"}
    blk = {"ln1": blk["ln1"][0], "attn": {k: v[0] for k, v in
                                          blk["attn"].items()}}
    B, S, steps = 2, 16, 8
    r, theta = cfg.mla_rope_dim, cfg.rope_theta
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 5, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.array([0, 3, 100, 511, 4095], np.int32), (B, 1))
    kw = dict(rope_dim=r, rope_theta=theta, norm_eps=cfg.norm_eps)
    qkw = dict(n_heads=cfg.n_heads, head_dim=cfg.resolved_head_dim, **kw)
    want = fast_jit(lambda p, x, s: (jmla.mla_latent(p, x, s, **kw),
                                     jmla.mla_queries(p, x, s, **qkw)))(
        blk["attn"], x, pos)
    pt = convert.train_params_from_numpy(blk, "cpu")
    got = (tmla.mla_latent(pt["attn"], _T(x), _T(pos), **kw),
           tmla.mla_queries(pt["attn"], _T(x), _T(pos), **qkw))
    for g, w in zip(sum(got, ()), sum(want, ())):
        assert_rel(g, np.asarray(w), 1e-6)

    step_j = fast_jit(lambda p, x, cc, kr, n: jserve._mla_decode_block(
        p, x, cc, kr, n, cfg))
    cc_j = jnp.zeros((B, S, cfg.mla_d_c)), jnp.zeros((B, S, r))
    cc_t = torch.zeros(B, S, cfg.mla_d_c), torch.zeros(B, S, r)
    xs = rng.normal(size=(steps, B, 1, cfg.d_model)).astype(np.float32)
    for n in range(steps):
        y_j, *cc_j = step_j(blk, xs[n], *cc_j, jnp.int32(n))
        y_t = tserve._mla_block(pt, [_T(xs[n])], *cc_t, n, tcfg,
                                tserve._Ranks(tcfg, None, B))[0]
        assert_rel(y_t, np.asarray(y_j), 1e-5)
    for g, w in zip(cc_t, cc_j):
        assert_rel(g, np.asarray(w), 1e-5)


def test_moe_bf16_decode_within_reference_bound():
    cfg = jregistry.get_smoke_config("deepseek-moe-16b")
    tcfg = port_model_cfg(cfg)
    tree = lm_tree_np(cfg, 5)
    B, steps = 2, 4
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (B, steps))
    step_j = fast_jit(jserve.make_serve_step(cfg))
    cache_j = jkv.init_cache(cfg, B, 64)
    step_t = tserve.make_serve_step(tcfg)
    params_t = convert.lm_params_from_numpy(tree, "cpu")
    cache_t = tkv.init_cache(tcfg, B, 64, device="cpu")
    params_j = {k: v for k, v in tree.items()}
    for t in range(steps):
        lj, cache_j = step_j(params_j, cache_j, tokens[:, t:t + 1])
        lt, cache_t = step_t(params_t, cache_t, _T(tokens[:, t:t + 1]))
        lj = np.asarray(lj)
        assert np.isfinite(f32(lt)).all()
        assert np.abs(f32(lt) - lj).max() < 3e-2 * max(np.abs(lj).max(), 1.0)
    assert cache_t["k"].dtype == torch.bfloat16
    assert cache_t["length"] == int(cache_j["length"]) == steps
