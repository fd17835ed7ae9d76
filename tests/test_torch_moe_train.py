"""The MoE layer's training route against the reference's, on the CPU,
float32.

The port has two routes with the reference's values: the capacity buffer
(the reference's ``moe_dense``: kept pairs scattered into an ``(E * C + 1,
d)`` buffer, every expert over its C rows of the stacked weights) and the
gathered pairs (each kept pair on its expert's gathered weights, the
decode's).  ``moe_dense`` picks the buffer at training sizes; here it is
held to the reference's ``moe_dense`` (output within 1e-5 of its largest
value, aux loss 1e-6 relative, gradients of ``sum(y * r) + 0.37 aux`` with
respect to the input and every weight within 5e-5 of their largest: fp32
sums in another order) at capacity factor 1.0 and 1.25, the configs'
training value; both drop pairs at this seed.  The two routes (``_capacity_buffer``, ``_gathered_pairs``) are held
against each other and against the reference's
``_dispatch_compute_combine`` given the same weights and expert ids (no
routing ties to detect), with gradients, and a dropped pair must give
exactly zero gradient to its weight, and a token whose every pair is
dropped to its row.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.models import moe as tmoe

from torch_parity import assert_rel, fast_jit, flat

_T = torch.from_numpy
B, S, D, E, F_, K = 2, 32, 64, 8, 32, 2


def _moe_params(seed, shared=1):
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32)
    p = {"router": n(D, E), "w_gate": n(E, D, F_), "w_up": n(E, D, F_),
         "w_down": n(E, F_, D)}
    if shared:
        p["shared"] = {"w_up": n(D, shared * F_), "w_gate": n(D, shared * F_),
                       "w_down": n(shared * F_, D)}
    return p


def _leaves(tree):
    t = convert.train_params_from_numpy(tree, "cpu")
    for leaf in jax.tree.leaves(t, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        leaf.requires_grad_()
    return t


def _grads(tree):
    return {k: _grads(v) if isinstance(v, dict) else v.grad
            for k, v in tree.items()}


@pytest.mark.parametrize("cf", [1.0, 1.25])
def test_moe_buffer_route_matches_reference(cf):
    p = _moe_params(0)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    r = rng.normal(size=(B, S, D)).astype(np.float32)

    def jf(p, x):
        def loss(p, x):
            y, aux = jmoe.moe_dense(p, x, topk=K, capacity_factor=cf)
            return (y * r).sum() + 0.37 * aux, (y, aux)
        (_, out), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, x)
        return out, g

    (y_j, aux_j), (gp_j, gx_j) = fast_jit(jf)(p, x)
    assert B * S * K >= E                    # moe_dense takes the buffer
    pt, xt = _leaves(p), _T(x).requires_grad_()
    y_t, aux_t = tmoe.moe_dense(pt, xt, topk=K, capacity_factor=cf)
    ((y_t * _T(r)).sum() + 0.37 * aux_t).backward()

    _, idx, _ = tmoe._route(pt["router"], xt.detach().reshape(B * S, D), K)
    C = int(np.ceil(B * S * K / E * cf))
    _, _, ok = tmoe._capacity_slots(idx, 0, E, C)
    assert bool((~ok).any())                 # both capacities drop pairs
    assert_rel(y_t, np.asarray(y_j), 1e-5)
    np.testing.assert_allclose(float(aux_t.detach()), float(aux_j), rtol=1e-6)
    want, got = flat(jax.tree.map(np.asarray, gp_j)), flat(_grads(pt))
    assert got.keys() == want.keys()
    for name in want:
        assert_rel(got[name], want[name], 5e-5)
    assert_rel(xt.grad, np.asarray(gx_j), 5e-5)


def test_moe_routes_agree_and_drop_gradients():
    """T = 64 tokens, k = 2, C = 12: tokens 0-29 all pick experts 0 and 1,
    and 30-63 pick two of the others in turn (at most 12 pairs an expert),
    so experts 0 and 1 drop 18 pairs each (tokens 12-29 lose both).  The same weights ``w``,
    ids and rows through both routes and the reference's dispatch: outputs
    within 1e-6 of their largest, gradients with respect to the rows, the
    weights and every expert weight within 5e-5; dropped pairs' weights and
    fully dropped tokens' rows take exactly zero."""
    p = {k: v for k, v in _moe_params(2, shared=0).items() if k != "router"}
    rng = np.random.default_rng(3)
    T, C = B * S, 12
    x = rng.normal(size=(T, D)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=(T, K)).astype(np.float32)
    t = np.arange(30, T)
    idx = np.stack([np.r_[np.zeros(30), 2 + t % 6],
                    np.r_[np.ones(30), 2 + (t + 1) % 6]], 1).astype(np.int32)
    r = rng.normal(size=(T, D)).astype(np.float32)

    def jf(p, x, w):
        def loss(p, x, w):
            y = jmoe._dispatch_compute_combine(p, x, w, idx, 0, E, C)
            return (y * r).sum(), y
        (_, y), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(p, x, w)
        return y, g

    y_j, (gp_j, gx_j, gw_j) = fast_jit(jf)(p, x, w)
    want_p = flat(jax.tree.map(np.asarray, gp_j))
    _, _, ok = tmoe._capacity_slots(_T(idx).long(), 0, E, C)
    assert int((~ok).sum()) == 36
    le, pos, _ = tmoe._capacity_slots(_T(idx).long(), 0, E, C)
    routes = {"buffer": lambda p, x, w: tmoe._capacity_buffer(p, x, w, pos, E, C),
              "gather": lambda p, x, w: tmoe._gathered_pairs(p, x, w, le, ok)}
    outs = {}
    for route, run in routes.items():
        pt = _leaves(p)
        xt, wt = _T(x).requires_grad_(), _T(w).requires_grad_()
        y = run(pt, xt, wt)
        (y * _T(r)).sum().backward()
        assert_rel(y, np.asarray(y_j), 1e-6)
        assert_rel(xt.grad, np.asarray(gx_j), 5e-5)
        assert_rel(wt.grad, np.asarray(gw_j), 5e-5)
        got_p = flat(_grads(pt))
        for name in want_p:
            assert_rel(got_p[name], want_p[name], 5e-5)
        assert torch.equal(wt.grad[~ok.reshape(T, K)], torch.zeros(36))
        assert torch.equal(xt.grad[12:30], torch.zeros(18, D))
        outs[route] = (y.detach(), xt.grad, wt.grad, got_p)
    assert_rel(outs["gather"][0], outs["buffer"][0].numpy(), 1e-6)
    for a, b in zip(outs["gather"][1:3], outs["buffer"][1:3]):
        assert_rel(a, b.numpy(), 1e-6)
