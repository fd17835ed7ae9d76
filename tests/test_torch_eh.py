"""Exponential Histograms: repro_torch.core.eh against repro.core.eh.

The port runs a batch of cells at once; the reference runs one cell per
``vmap`` lane and one ``lax.scan`` step per add.  Every state after every
step is bit-identical, dead ring slots included, for `eh_add`,
`eh_add_ref`, `eh_step`, `sum_eh_add` and `sum_eh_add_ref`; `eh_merge` is
bit-identical and commutative.  (The reference's own `sum_eh_add` and
`sum_eh_add_ref` agree on the live state only — its docstring says the
dead slots may differ — so the port holds each to its reference
counterpart bit for bit, and the two to each other on the live state.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import eh as jeh
from repro_torch import convert
from repro_torch.core import eh as teh

from torch_parity import assert_state_equal

CELLS, T = 12, 150


def _reference_trace(fn, init, clocks, arg):
    """Every intermediate state of ``fn(state, t, a)`` scanned over
    ``(clocks, arg)`` of shape (CELLS, T), one vmap lane per cell."""
    def one(ts, a):
        def step(s, x):
            s2 = fn(s, x[0], x[1])
            return s2, s2
        return lax.scan(step, init, (ts, a))[1]
    out = jax.jit(jax.vmap(one))(jnp.asarray(clocks), jnp.asarray(arg))
    return [jeh.EHState(out.ts[:, i], out.num[:, i]) for i in range(T)]


def _port_trace(fn, base, clocks, arg):
    st = teh.EHState(
        ts=torch.full((CELLS, base.levels, base.slots), -1, dtype=torch.int32),
        num=torch.zeros((CELLS, base.levels), dtype=torch.int32))
    out = []
    for i in range(T):
        st = fn(st, torch.from_numpy(clocks[:, i].copy()),
                torch.from_numpy(arg[:, i].copy()))
        out.append(st)
    return out


@pytest.fixture(scope="module")
def stream():
    """Gappy clocks (ring wrap, carries and expiry at window 40) and bits."""
    rng = np.random.default_rng(0)
    clocks = np.cumsum(rng.integers(0, 12, size=(CELLS, T)), 1).astype(np.int32)
    bits = (rng.random((CELLS, T)) < 0.7).astype(np.int32)
    return clocks, bits


@pytest.mark.parametrize("name", ["eh_add", "eh_add_ref", "eh_step"])
def test_eh_updates_bit_exact_every_step(stream, name):
    clocks, bits = stream
    cfg_j, cfg_t = jeh.EHConfig.create(40, 0.2), teh.EHConfig.create(40, 0.2)
    assert vars(cfg_t) == vars(cfg_j)
    fj, ft = getattr(jeh, name), getattr(teh, name)
    if name == "eh_step":
        ref = _reference_trace(lambda s, t, b: fj(s, t, b, cfg_j),
                               jeh.eh_init(cfg_j), clocks, bits)
        got = _port_trace(lambda s, t, b: ft(s, t, b, cfg_t), cfg_t, clocks, bits)
    else:
        ref = _reference_trace(lambda s, t, b: fj(s, t, cfg_j),
                               jeh.eh_init(cfg_j), clocks, bits)
        got = _port_trace(lambda s, t, b: ft(s, t, cfg_t), cfg_t, clocks, bits)
    for g, r in zip(got, ref):
        assert_state_equal(g, r)
    assert int(got[-1].num.sum(-1).max()) > cfg_t.max_buckets_per_level


def test_eh_add_closed_form_equals_cascade(stream):
    clocks, _ = stream
    cfg = teh.EHConfig.create(40, 0.2)
    ones = np.ones_like(clocks)
    a = _port_trace(lambda s, t, b: teh.eh_add(s, t, cfg), cfg, clocks, ones)
    b = _port_trace(lambda s, t, b: teh.eh_add_ref(s, t, cfg), cfg, clocks, ones)
    for x, y in zip(a, b):
        assert_state_equal(x, y)


def test_eh_merge_bit_exact_and_commutative(stream):
    clocks, bits = stream
    cfg_j, cfg_t = jeh.EHConfig.create(40, 0.2), teh.EHConfig.create(40, 0.2)
    a = _port_trace(lambda s, t, b: teh.eh_add(s, t, cfg_t), cfg_t, clocks, bits)[-1]
    b = _port_trace(lambda s, t, b: teh.eh_step(s, t, b, cfg_t), cfg_t,
                    clocks[::-1].copy(), bits)[-1]
    t = int(clocks.max())
    merge_j = jax.jit(jax.vmap(lambda x, y: jeh.eh_merge(x, y, jnp.int32(t), cfg_j)))
    ref = merge_j(jeh.EHState(jnp.asarray(a.ts.numpy()), jnp.asarray(a.num.numpy())),
                  jeh.EHState(jnp.asarray(b.ts.numpy()), jnp.asarray(b.num.numpy())))
    got = teh.eh_merge(a, b, t, cfg_t)
    assert_state_equal(got, ref)
    assert_state_equal(teh.eh_merge(b, a, t, cfg_t), got)
    assert int(got.num.sum()) > 0
    # a merge with an empty EH is the expired input
    empty = teh.EHState(torch.full_like(a.ts, -1), torch.zeros_like(a.num))
    alone = teh.eh_merge(a, empty, t, cfg_t)
    np.testing.assert_array_equal(teh.eh_query(alone, t, cfg_t).numpy(),
                                  teh.eh_query(a, t, cfg_t).numpy())
    assert teh.eh_exact_upper(cfg_t) == jeh.eh_exact_upper(cfg_j)


@pytest.mark.parametrize("name", ["sum_eh_add", "sum_eh_add_ref"])
def test_sum_eh_bit_exact_every_step(name):
    rng = np.random.default_rng(1)
    cfg_j = jeh.SumEHConfig.create(16, 0.25, 5)
    cfg_t = teh.SumEHConfig.create(16, 0.25, 5)
    assert (cfg_t.base.levels, cfg_t.base.slots, cfg_t.max_buckets) == \
        (cfg_j.base.levels, cfg_j.base.slots, cfg_j.max_buckets)
    vals = rng.integers(0, 6, size=(CELLS, T)).astype(np.int32)
    vals[:, ::7] = 0                                 # untouched steps
    clocks = np.tile(np.arange(T, dtype=np.int32), (CELLS, 1))
    fj, ft = getattr(jeh, name), getattr(teh, name)
    ref = _reference_trace(lambda s, t, v: fj(s, t, v, cfg_j),
                           jeh.sum_eh_init(cfg_j), clocks, vals)
    got = _port_trace(lambda s, t, v: ft(s, t, v, cfg_t), cfg_t.base, clocks, vals)
    for g, r in zip(got, ref):
        assert_state_equal(g, r)
    q = teh.sum_eh_query(got[-1], T - 1, cfg_t).numpy()
    np.testing.assert_array_equal(
        q, np.asarray(jax.vmap(lambda s: jeh.sum_eh_query(s, T - 1, cfg_j))(ref[-1])))


def test_sum_eh_closed_form_equals_replay_on_live_state():
    rng = np.random.default_rng(2)
    cfg = teh.SumEHConfig.create(16, 0.25, 5)
    vals = rng.integers(0, 6, size=(CELLS, T)).astype(np.int32)
    clocks = np.tile(np.arange(T, dtype=np.int32), (CELLS, 1))
    a = _port_trace(lambda s, t, v: teh.sum_eh_add(s, t, v, cfg), cfg.base,
                    clocks, vals)
    b = _port_trace(lambda s, t, v: teh.sum_eh_add_ref(s, t, v, cfg), cfg.base,
                    clocks, vals)
    slot = torch.arange(cfg.base.slots)
    for x, y in zip(a, b):
        assert torch.equal(x.num, y.num)
        live = slot < x.num[..., None]
        assert torch.equal(torch.where(live, x.ts, -1), torch.where(live, y.ts, -1))


def test_eh_state_convert_round_trip(stream):
    clocks, bits = stream
    cfg = teh.EHConfig.create(40, 0.2)
    st = _port_trace(lambda s, t, b: teh.eh_step(s, t, b, cfg), cfg, clocks, bits)[-1]
    back = convert.eh_state_from_numpy(convert.to_numpy(st), device="cpu")
    assert_state_equal(back, st)
    one = teh.eh_init(cfg, device="cpu")
    assert one.ts.shape == (cfg.levels, cfg.slots) and int(one.num.sum()) == 0
