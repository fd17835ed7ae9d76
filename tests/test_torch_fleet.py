"""The port's multi-tenant fleets (repro_torch.core.fleet and
repro_torch.serve.tenant_fleet) against the reference's, on the CPU.

Inputs are made with numpy from a seed on a 1/16 grid and the reference's
parameters on a 1/8 grid cross over (`convert.params_from_numpy`), so both
packages compute the same hash codes.  Then:

* every `core.fleet` ingest leaves a stacked state bit-identical to the
  reference's (RACE; SW-AKDE with expiry at tenant boundaries; S-ANN with
  ring wrap and eviction), and every fleet query gives the reference's
  answers: RACE and SW-AKDE estimates equal, S-ANN ids equal and distances
  within `batch_score_topk`'s tolerance (rtol 1e-5, atol 1e-6);
* `route_chunk` gives the reference's plan, and `convert` carries stacked
  states (a leading T on every leaf) both ways;
* `TenantFleet` against the reference's: LRU spill and reactivation (every
  tenant's row bit-identical), op splits, queries, and WAL + snapshot +
  spill recovery of a fleet directory written by either package.

The reference's functions are jitted once per module.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as jfleet
from repro.core import lsh as jlsh
from repro.core import race as jrace
from repro.core import swakde as jswakde
from repro.serve.tenant_fleet import TenantFleet as JFleet
from repro.serve.tenant_fleet import TenantFleetConfig as JFleetCfg
from repro_torch import convert
from repro_torch.core import fleet, prng, race, sann, swakde
from repro_torch.serve.tenant_fleet import TenantFleet, TenantFleetConfig

from torch_parity import (ATOL, RTOL, assert_state_equal, exact_params,
                          fields, grid_data, np_, port_params)

D = 6


def _tids(T, n, seed, probs=None):
    return np.random.default_rng(seed).choice(T, size=n, p=probs).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _stacked_equal(port, ref):
    assert_state_equal(port, ref)


def _converts(port, ref, from_numpy):
    """`convert` carries stacked fleet states (a leading T on every leaf)
    both ways: the reference's into the port's, and back."""
    assert_state_equal(from_numpy(fields(ref), "cpu"), ref)
    back = convert.to_numpy(port)
    for name in port._fields:
        np.testing.assert_array_equal(back[name], np.asarray(getattr(ref, name)))


# --------------------------------------------------------------------------
# core.fleet
# --------------------------------------------------------------------------

def test_route_chunk_matches_reference():
    tids = np.array([2, 0, 2, 1, 0, 2, 5, -1, 1, 2], np.int32)  # 5, -1 dropped
    want = jax.jit(jfleet.route_chunk, static_argnums=(1, 2))(
        jnp.asarray(tids), 3, 4)
    got = fleet.route_chunk(_t(tids), 3, 4)
    np.testing.assert_array_equal(np_(got.counts), np.asarray(want.counts))
    np.testing.assert_array_equal(np_(got.valid), np.asarray(want.valid))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(np_(got.take)[v], np.asarray(want.take)[v])
    assert np_(got.take)[2, :4].tolist() == [0, 2, 5, 9]     # stream order


def test_stack_row_set_broadcast_helpers():
    a = race.race_init(3, 4, "cpu")
    b = race.RACEState(counts=a.counts + 1, n=a.n + 5)
    st = fleet.fleet_stack([a, b])
    assert st.counts.shape == (2, 3, 4) and st.n.tolist() == [0, 5]
    assert_state_equal(fleet.fleet_row(st, 1), b)
    st2 = fleet.fleet_set_row(st, 0, b)
    assert st.n.tolist() == [0, 5] and st2.n.tolist() == [5, 5]
    bc = fleet.fleet_broadcast(b, 3)
    assert bc.counts.shape == (3, 3, 4) and bc.n.tolist() == [5, 5, 5]


_RACE_J = jax.jit(jfleet.race_fleet_ingest)
_RACE_Q = jax.jit(jfleet.race_fleet_query)
_RACE_K = jax.jit(jfleet.race_fleet_kde, static_argnums=(4,))


def test_race_fleet_matches_reference():
    T, L, W = 4, 5, 32
    pj = exact_params("srp", 0, D, L, 3, W)
    pt = port_params(pj)
    sj = jfleet.fleet_broadcast(jrace.race_init(L, W), T)
    st = fleet.fleet_broadcast(race.race_init(L, W, "cpu"), T)
    for chunk in range(3):
        xs = grid_data(70, D, seed=chunk)
        tids = _tids(T + 1, 70, chunk) - (chunk == 1)        # -1 and T dropped
        sj = _RACE_J(sj, pj, jnp.asarray(xs), jnp.asarray(tids))
        st = fleet.race_fleet_ingest(st, pt, _t(xs), _t(tids))
    _stacked_equal(st, sj)
    _converts(st, sj, convert.race_state_from_numpy)
    assert int(st.n.sum()) < 3 * 70                           # drops counted
    qs, qt = grid_data(25, D, seed=99), _tids(T, 25, 99)
    np.testing.assert_array_equal(
        np_(fleet.race_fleet_query(st, pt, _t(qs), _t(qt))),
        np.asarray(_RACE_Q(sj, pj, jnp.asarray(qs), jnp.asarray(qt))))
    np.testing.assert_array_equal(
        np_(fleet.race_fleet_kde(st, pt, _t(qs), _t(qt), 2)),
        np.asarray(_RACE_K(sj, pj, jnp.asarray(qs), jnp.asarray(qt), 2)))


# The SW-AKDE and S-ANN configurations shared by the core and the
# TenantFleet tests: the core tests drive the reference's own jitted fleet
# ingest (the one its TenantFleet builds) at the shapes the TenantFleet
# tests use (2 slots; every operation two tenants x PER rows, one cap), so
# each compiles once per module.
_SW_FLEET = dict(dim=D, hot_slots=2, L=4, k=2, W=32, window=48, eh_eps=0.2,
                 seed=13)
_SW_PARAMS = exact_params("pstable", 5, D, 4, 2, 32, 1.0)
_SW_CAP, _SW_PER = 32, 20
_SANN_FLEET = dict(dim=D, hot_slots=2, n_max=16, eta=0.3, r=0.5, c=2.0,
                   w=1.0, L=4, k=2, seed=17)
_SANN_CFG = sann.SANNConfig(dim=D, n_max=16, eta=0.3, r=0.5, c=2.0, w=1.0,
                            L=4, k=2).resolved()
_SANN_PARAMS = exact_params("pstable", 6, D, _SANN_CFG.L, _SANN_CFG.k,
                            _SANN_CFG.n_buckets, 1.0)
_SANN_CAP, _SANN_PER = 8, 8


def test_swakde_fleet_matches_reference_with_expiry():
    """Window 48: tenant 0 (30 rows a chunk) expires, tenant 1 (10) does
    not; the stacked states and grid tables are bit-identical."""
    ref = _ref_fleet("swakde", _SW_PARAMS, **_SW_FLEET)
    ingest = ref._get_ingest(_SW_CAP)
    ct = swakde.SWAKDEConfig(L=4, W=32, window=48, eh_eps=0.2)
    pt = port_params(_SW_PARAMS)
    sj = jfleet.fleet_broadcast(ref._empty, 2)
    st = fleet.fleet_broadcast(swakde.swakde_init(ct, "cpu"), 2)
    tids = np.tile([0, 0, 0, 1], 2 * _SW_PER // 4).astype(np.int32)
    for chunk in range(2):
        xs = grid_data(len(tids), D, seed=10 + chunk)
        sj = ingest(sj, jnp.asarray(xs), jnp.asarray(tids))
        st = fleet.swakde_fleet_ingest(st, pt, _t(xs), _t(tids), ct, _SW_CAP)
    _stacked_equal(st, sj)
    _converts(st, sj, convert.swakde_state_from_numpy)
    t = np_(st.t)
    assert t[0] > ct.window > t[1]                 # hot expires, cold not
    # (the per-request queries: test_tenant_fleet_swakde_matches_reference)
    np.testing.assert_array_equal(
        np_(fleet.swakde_fleet_grid(st, ct)),
        np.asarray(jax.jit(jfleet.swakde_fleet_grid, static_argnums=(1,))(
            sj, ref._scfg)))
    ref.close()


def test_sann_fleet_matches_reference_with_ring_wrap():
    """~80 kept points a tenant in a 64-slot ring: the rings wrap and evict;
    the per-tenant keys are ``fold_in(fold_in(base, seq), tenant)``, and the
    stacked states are bit-identical."""
    ref = _ref_fleet("sann", _SANN_PARAMS, **_SANN_FLEET)
    ingest = ref._get_ingest(_SANN_CAP)
    pt = port_params(_SANN_PARAMS)
    sj = jfleet.fleet_broadcast(ref._empty, 2)
    st = fleet.fleet_broadcast(sann.sann_empty_state(_SANN_CFG, "cpu"), 2)
    base = prng.fold_in(prng.PRNGKey(_SANN_FLEET["seed"], "cpu"), 1)
    np.testing.assert_array_equal(convert.key_to_numpy(base),
                                  np.asarray(ref._base_key))
    exts = np.array([7, 12], np.int64)
    tids = np.tile([0, 1], _SANN_PER).astype(np.int32)
    for chunk in range(24):
        xs = grid_data(len(tids), D, seed=20 + chunk, scale=0.5)
        sj = ingest(sj, jnp.asarray(xs), jnp.asarray(tids), jnp.int32(chunk),
                    jnp.asarray(exts, jnp.int32))
        kt = fleet.sann_fleet_keys(prng.fold_in(base, chunk), _t(exts))
        st = fleet.sann_fleet_ingest(st, pt, _t(xs), _t(tids), kt, _SANN_CFG,
                                     _SANN_CAP)
    _stacked_equal(st, sj)
    _converts(st, sj, convert.sann_state_from_numpy)
    assert (np_(st.n_stored) == _SANN_CFG.capacity).all()   # rings full ...
    assert (np_(st.write_ptr) > 0).all()                     # ... and lapped
    # (the queries: test_tenant_fleet_sann_split_ops_match_reference)
    ref.close()


# --------------------------------------------------------------------------
# serve.tenant_fleet
# --------------------------------------------------------------------------

_REF_JITS: dict = {}


def _ref_fleet(kind, ref_params, **kw):
    """The reference's TenantFleet with ``ref_params`` (its own draw is
    skipped: it would compile JAX's samplers for parameters the test
    replaces).  Fleets of one configuration share the first one's jitted
    functions (they read its params and sketch config, identical across
    them)."""
    draw = lambda *a, **k: ref_params
    cfg = JFleetCfg(kind=kind, **kw)
    with mock.patch.object(jlsh, "init_srp", draw), \
            mock.patch.object(jlsh, "init_pstable", draw):
        ref = JFleet(cfg)
    key = (dataclasses.replace(cfg, snapshot_dir=None, snapshot_every=64),
           id(ref_params))
    ref._ingest_jit, ref._query_jit = _REF_JITS.setdefault(key, ({}, {}))
    return ref


def _pair(kind, ref_params, **kw):
    """The reference's TenantFleet and the port's, sharing ``ref_params``."""
    port = TenantFleet(TenantFleetConfig(kind=kind, **kw), device="cpu",
                       params=port_params(ref_params))
    return _ref_fleet(kind, ref_params, **kw), port


def _rows_equal(port, ref, tenants):
    for t in tenants:
        ref._activate([t])
        assert_state_equal(port.tenant_state(t),
                           jfleet.fleet_row(ref._stacked, ref._slots[t]))


def _churn(fleets, chunks, n, seed, T, hot):
    rng = np.random.default_rng(seed)
    for chunk in range(chunks):
        active = [(chunk + j) % T for j in range(hot)]
        xs = grid_data(n, D, seed=seed + chunk)
        tids = rng.choice(active, size=n)
        for f in fleets:
            f.ingest(xs, tids)


def _pattern(pairs, per):
    """Tenant ids: each group of tenants interleaved ``per`` times, so every
    operation (or query block) gives each of its tenants ``per`` rows: one
    block size, one compile of each of the reference's jitted functions."""
    return np.concatenate([np.tile(p, per) for p in pairs])


_RACE_FLEET = dict(dim=D, hot_slots=3, L=4, k=3, W=32, seed=11)


def test_tenant_fleet_lru_spill_reactivate_matches_reference():
    """6 tenants through 3 hot slots: every chunk evicts somebody; every
    tenant's row (spilled, reactivated) equals the reference's bit for bit
    and the queries agree."""
    pj = exact_params("srp", 4, D, 4, 3, 32)
    ref, port = _pair("race", pj, **_RACE_FLEET)
    _churn((ref, port), 8, 45, 42, 6, 3)
    assert port.spills == ref.spills > 0
    assert port.activations == ref.activations
    assert port.hot_tenants == ref.hot_tenants
    qt = _pattern([(0, 1, 2), (3, 4, 5)], 5)   # blocks of one size
    qs = grid_data(len(qt), D, seed=3)
    np.testing.assert_array_equal(port.query(qs, qt), np.asarray(ref.query(qs, qt)))
    np.testing.assert_array_equal(port.density(qs, qt),
                                  np.asarray(ref.density(qs, qt)))
    _rows_equal(port, ref, range(6))
    ref.close()
    port.close()


def test_tenant_fleet_swakde_matches_reference():
    """SW-AKDE with expiry (window 48) through 2 hot slots over 4 tenants:
    tenant rows bit-identical to the reference's, estimates and densities
    equal."""
    ref, port = _pair("swakde", _SW_PARAMS, **_SW_FLEET)
    for call, pair in enumerate([(0, 1), (0, 2), (0, 3), (1, 2)]):
        tids = _pattern([pair], _SW_PER)
        xs = grid_data(len(tids), D, seed=40 + call)
        ref.ingest(xs, tids)
        port.ingest(xs, tids)
    assert port.spills == ref.spills > 0
    qt = _pattern([(0, 1), (2, 3)], 4)
    qs = grid_data(len(qt), D, seed=8)
    np.testing.assert_array_equal(port.query(qs, qt), np.asarray(ref.query(qs, qt)))
    np.testing.assert_array_equal(port.density(qs, qt),
                                  np.asarray(ref.density(qs, qt)))
    _rows_equal(port, ref, range(4))
    assert int(port.tenant_state(0).t) > 48 > int(port.tenant_state(3).t)
    ref.close()
    port.close()


def test_tenant_fleet_sann_split_ops_match_reference():
    """S-ANN calls touching 4 tenants with 2 hot slots: each call splits
    into 4 operations, each drawing its tenants' keep decisions from
    ``fold_in(fold_in(base, seq), tenant)``.  Tenant rows bit-identical,
    (c, r) answers equal, top-k ids equal, distances within (RTOL, ATOL)."""
    ref, port = _pair("sann", _SANN_PARAMS, **_SANN_FLEET)
    tids = _pattern([(0, 1), (2, 3), (1, 2), (3, 0)], _SANN_PER)
    for call in range(3):
        xs = grid_data(len(tids), D, seed=30 + call, scale=0.5)
        ref.ingest(xs, tids)
        port.ingest(xs, tids)
    assert port.splits == ref.splits == 9 and port.seq == ref.seq == 12
    qt = _pattern([(0, 1), (2, 3)], 4)
    qs = grid_data(len(qt), D, seed=9, scale=0.5)
    rt, rj = port.query(qs, qt), ref.query(qs, qt)
    for f in ("index", "found", "n_candidates"):
        np.testing.assert_array_equal(getattr(rt, f),
                                      np.asarray(getattr(rj, f)), err_msg=f)
    np.testing.assert_allclose(rt.distance, np.asarray(rj.distance),
                               rtol=RTOL, atol=ATOL)
    assert rt.found.any()
    it, dt = port.query_topk(qs, qt, topk=6)
    ij, dj = ref.query_topk(qs, qt, topk=6)
    np.testing.assert_array_equal(it, np.asarray(ij))
    np.testing.assert_allclose(dt, np.asarray(dj), rtol=RTOL, atol=ATOL)
    _rows_equal(port, ref, range(4))
    ref.close()
    port.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tenant_fleet_recovery_crosses_packages(tmp_path, writer):
    """One package writes a durable fleet (snapshots every 5 ops, spills of
    cold tenants, a WAL tail) and stops; a fresh fleet of the other package
    recovers it: every tenant's row bit-identical, the same answers, and
    both go on ingesting identically."""
    pj = exact_params("srp", 7, D, 4, 3, 32)
    dur = dict(_RACE_FLEET, snapshot_dir=str(tmp_path), snapshot_every=5)
    ref, port = _pair("race", pj, **dur)
    w, live = (port, ref) if writer == "port" else (ref, port)
    live.close()
    vol_ref, vol_port = _pair("race", pj, **_RACE_FLEET)
    _churn((w, vol_ref, vol_port), 8, 30, 23, 6, 3)
    seq = w.seq
    w.close()
    r_ref, r_port = _pair("race", pj, **dur)
    reader = r_ref if writer == "port" else r_port
    (r_port if writer == "port" else r_ref).close()
    with pytest.raises(RuntimeError, match="recover"):
        reader.ingest(grid_data(2, D), [0, 1])
    assert reader.recover() > 0 and reader.seq == seq
    assert reader.known_tenants == set(range(6))
    qt = _pattern([(0, 1, 2), (3, 4, 5)], 5)   # the LRU test's block size
    qs = grid_data(len(qt), D, seed=4)
    np.testing.assert_array_equal(np.asarray(reader.query(qs, qt)),
                                  vol_port.query(qs, qt))
    mt = _pattern([(4, 0, 2)], 10)             # one operation, B = 30
    more = grid_data(len(mt), D, seed=99)
    reader.ingest(more, mt)
    vol_ref.ingest(more, mt)
    vol_port.ingest(more, mt)
    for t in range(6):
        rr = reader.tenant_state(t) if reader is r_port else None
        if rr is None:
            reader._activate([t])
            rr = jfleet.fleet_row(reader._stacked, reader._slots[t])
        assert_state_equal(vol_port.tenant_state(t), rr)
    _rows_equal(vol_port, vol_ref, range(6))
    for f in (reader, vol_ref, vol_port):
        f.close()


def test_tenant_fleet_hands_out_states_that_stay():
    """A tenant's state and the stacked state, once handed out, do not
    change when that tenant is evicted and its slot refilled, nor when
    later operations commit."""
    pj = exact_params("srp", 4, D, 4, 3, 32)
    fl = TenantFleet(TenantFleetConfig(kind="race", **dict(_RACE_FLEET,
                                                          hot_slots=2)),
                     device="cpu", params=port_params(pj))
    fl.ingest(grid_data(20, D, seed=1), np.tile([0, 1], 10))
    held, peeked, stacked = fl.tenant_state(0), fl.peek_state(1), fl.stacked
    want = [type(s)(*(x.clone() for x in s)) for s in (held, peeked, stacked)]
    fl.ingest(grid_data(20, D, seed=2), np.tile([2, 3], 10))   # evicts 0, 1
    fl.ingest(grid_data(20, D, seed=3), np.tile([0, 2], 10))   # 0 comes back
    assert fl.spills >= 2
    for got, w in zip((held, peeked, stacked), want):
        assert_state_equal(got, w)
    assert not torch.equal(fl.tenant_state(0).counts, held.counts)
    fl.close()


def test_tenant_fleet_recover_refuses_another_bucket_cap(tmp_path):
    """An S-ANN fleet directory written at one ``bucket_cap`` is refused,
    naming it, by a fleet configured with another (the reference's fleets
    use 16)."""
    cfg = TenantFleetConfig(kind="sann", dim=D, hot_slots=2, n_max=32, L=2,
                            k=2, eta=0.5, bucket_cap=4, seed=3,
                            snapshot_dir=str(tmp_path), snapshot_every=1)
    fl = TenantFleet(cfg, device="cpu")
    fl.ingest(grid_data(8, D, seed=5), np.tile([0, 1], 4))
    fl.close()
    other = TenantFleet(dataclasses.replace(cfg, bucket_cap=16), device="cpu")
    with pytest.raises(ValueError, match="bucket_cap 4"):
        other.recover()
    other.close()
    same = TenantFleet(cfg, device="cpu")
    assert same.recover() == 0 and same.seq == 1
    same.close()


def test_tenant_fleet_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only box")
    with pytest.raises(RuntimeError, match="CUDA"):
        TenantFleet(TenantFleetConfig(kind="race", dim=4))
    with pytest.raises(ValueError):
        TenantFleetConfig(kind="nope", dim=4)
