"""The port's sketch sharding (repro_torch.parallel) against the reference's
single-device functions, on the CPU, in this process.

The reference's own ``tests/test_distributed.py`` holds its 8-device
sharded calls bit-identical to its single-device functions, so the port's
sharded functions are held to those single-device functions here, with no
JAX mesh and no subprocess.  A port mesh is ``("cpu",) * n`` for n in
{2, 4, 8}: one process, each shard's state its own tensors.  Inputs are
made with numpy from a seed on a 1/16 grid and the reference's parameters
on a 1/8 grid cross over, so both packages hash alike.  Then:

* RACE (SRP, turnstile, `median_of_means` 0 and 4), SW-AKDE (p-stable, an
  uneven last chunk, window expiry, the row-sharded grid and its reads)
  and S-ANN (insert, prepare/commit, delete, merge, (c, r) and top-k): the
  gathered sharded state equals the reference's bit for bit, estimates
  are equal, S-ANN ids equal and distances within `batch_score_topk`'s
  tolerance (rtol 1e-5, atol 1e-6);
* the three fleets split by tenant (T = 16): stacked states bit-identical,
  answers as above, the S-ANN top-k's -1 / inf padding through the
  owner-masked sum;
* the three services at ``num_shards=8``: a sharded port service
  recovers a directory the reference's single-device service wrote, the
  reference recovers the sharded port service's, and both end in the same
  state with the same answers; a sharded S-ANN service recovers from its
  own crash onto the mesh;
* the refusals: ``L % num_shards``, too few cards, a mesh of another type
  or without a "shard" axis.

The reference's functions are jitted once per module and compiled at
XLA's lowest backend optimisation level with its older loop emitters
(`_jit`, `torch_parity.XLA_FAST`): these shapes are tiny, so compiling
dominates, and neither option changes a result (XLA keeps IEEE semantics
at every level, and on these grids every sum is exact); with ``_FAST =
{}`` (XLA's default options) the file passes as well.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as jfleet
from repro.core import lsh as jlsh
from repro.core import race as jrace
from repro.core import sann as jsann
from repro.core import swakde as jswakde
from repro.serve.kde_service import KDEService as JKDE
from repro.serve.kde_service import KDEServiceConfig as JKDECfg
from repro.serve.race_service import RACEService as JRACE
from repro.serve.race_service import RACEServiceConfig as JRACECfg
from repro.serve.retrieval import RetrievalConfig as JRetrCfg
from repro.serve.retrieval import RetrievalService as JRetr
from repro_torch import convert
from repro_torch.core import fleet, lsh, prng, race, sann, swakde
from repro_torch.kernels import _build
from repro_torch.parallel import sketch_sharding as ss
from repro_torch.parallel.sharding import Mesh
from repro_torch.serve.kde_service import KDEService, KDEServiceConfig
from repro_torch.serve.race_service import RACEService, RACEServiceConfig
from repro_torch.serve.retrieval import RetrievalConfig, RetrievalService

from torch_parity import (ATOL, RTOL, XLA_FAST, assert_state_equal,
                          exact_params, grid_data, np_, port_params)

D = 8
SHARDS = (2, 4, 8)


_FAST = XLA_FAST


def _fast(jitted, static_argnums=()):
    """``jitted`` compiled once per static arguments and input signature
    with the `_FAST` options."""
    compiled = {}

    def call(*args):
        dyn = [a for i, a in enumerate(args) if i not in static_argnums]
        leaves, tree = jax.tree.flatten(dyn)
        key = (tuple(args[i] for i in static_argnums), tree,
               tuple((np.shape(x), jnp.result_type(x)) for x in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options=_FAST)
        return compiled[key](*dyn)

    return call


def _jit(fn, static_argnums=()):
    return _fast(jax.jit(fn, static_argnums=static_argnums), static_argnums)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ctx(n):
    return ss.make_sketch_ctx(ss.make_sketch_mesh(n, "cpu"))


def _queries(n, seed):
    return grid_data(n, D, seed=seed) + np.float32(1 / 32)


def _same_result(got, want):
    """S-ANN (c, r) results: ids, found and counts exact, distances within
    `batch_score_topk`'s tolerance."""
    for name in ("index", "found", "n_candidates"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(np_(got.distance), np.asarray(want.distance),
                               rtol=RTOL, atol=ATOL)


def _same_topk(got, want):
    np.testing.assert_array_equal(np_(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np_(got[1]), np.asarray(want[1]), rtol=RTOL,
                               atol=ATOL)


# --------------------------------------------------------------------------
# row- and table-sharded sketches
# --------------------------------------------------------------------------
#
# Each sketch runs at its service's configuration, chunk and query block
# (`SVC` below), so the reference services reuse these compiled functions.

_SANN = dict(dim=D, n_max=64, eta=0.1, r=0.4, c=2.0, w=1.0, L=8, k=3,
             bucket_cap=4)          # 168 slots: the ring wraps by chunk 5
SVC = {
    "retrieval": (RetrievalConfig, RetrievalService, JRetrCfg, JRetr,
                  dict(_SANN, ingest_chunk=64, query_block=16, topk=8)),
    "kde": (KDEServiceConfig, KDEService, JKDECfg, JKDE,
            dict(dim=D, L=8, W=32, window=150, eh_eps=0.2, ingest_chunk=50,
                 query_block=16, hash_family="pstable", k=2, w=2.0)),
    "race": (RACEServiceConfig, RACEService, JRACECfg, JRACE,
             dict(dim=D, L=8, W=32, ingest_chunk=64, query_block=16,
                  hash_family="srp", k=2, median_of_means=4)),
}
QB = 16


def _svc_params(kind):
    kw = SVC[kind][4]
    if kind == "retrieval":
        cfg = jsann.SANNConfig(**_SANN).resolved()
        return exact_params("pstable", 20, D, cfg.L, cfg.k, cfg.n_buckets,
                            w=cfg.w)
    return exact_params(kw["hash_family"], 21, D, 8, 2, 32, w=kw.get("w"))


_RACE_PREP = _jit(jrace.race_prepare_chunk, static_argnums=(2,))
_RACE_COMMIT = _jit(jrace.race_commit_chunk, static_argnums=(2,))
_RACE_Q = _jit(jrace.race_query_batch, static_argnums=(3,))


@pytest.fixture(scope="module")
def race_ref():
    pj = _svc_params("race")
    xs = grid_data(256, D, seed=1)
    st = jrace.race_init(8, 32)
    for i in range(0, 256, 64):
        st = _RACE_COMMIT(st, _RACE_PREP(pj, jnp.asarray(xs[i:i + 64]), 32), 1)
    st = _RACE_COMMIT(st, _RACE_PREP(pj, jnp.asarray(xs[:64]), 32), -1)
    qs = jnp.asarray(_queries(QB, 2))
    return pj, xs, qs, st, {m: _RACE_Q(st, pj, qs, m) for m in (0, 4)}


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_race_matches_reference(race_ref, n):
    pj, xs, qs, want, answers = race_ref
    ctx = _ctx(n)
    st, p = ss.shard_race(race.race_init(8, 32, "cpu"), port_params(pj), ctx)
    assert len(st) == n and st[0].counts.shape == (8 // n, 32)
    assert all(sh.L == 8 // n and sh.proj.shape == (D, 2 * 8 // n)
               for sh in p)
    st = ss.sharded_race_update_batch(st, p, _t(xs[:64]), ctx)
    for i in range(64, 256, 64):
        prep = ss.sharded_race_prepare_chunk(p, _t(xs[i:i + 64]), 32, ctx)
        st = ss.sharded_race_commit_chunk(st, prep, ctx)
    st = ss.sharded_race_update_batch(st, p, _t(xs[:64]), ctx, sign=-1)
    assert_state_equal(ss.gather_state(st, ctx), want)
    for mom, a in answers.items():
        np.testing.assert_array_equal(
            np_(ss.sharded_race_query_batch(st, p, _t(qs), ctx, mom)),
            np.asarray(a))


_SW_PREP = _jit(jswakde.swakde_prepare_chunk, static_argnums=(2,))
_SW_COMMIT = _jit(jswakde.swakde_commit_chunk, static_argnums=(2,))
_SW_GRID = _jit(jswakde.swakde_grid_estimates, static_argnums=(1,))
_SW_GQ = _jit(jswakde.swakde_query_from_grid, static_argnums=(3,))
_SW_Q = _jit(jswakde.swakde_query_batch, static_argnums=(3,))
_SW_N = 230                         # 4 chunks of 50, then an uneven 30


def _sw_cfg(pkg):
    kw = SVC["kde"][4]
    return pkg.SWAKDEConfig(L=kw["L"], W=kw["W"], window=kw["window"],
                            eh_eps=kw["eh_eps"])


@pytest.fixture(scope="module")
def swakde_ref():
    cfg = _sw_cfg(jswakde)
    pj = _svc_params("kde")
    xs = grid_data(_SW_N, D, seed=4)
    st = jswakde.swakde_init(cfg)
    for i in range(0, _SW_N, 50):
        st = _SW_COMMIT(st, _SW_PREP(pj, jnp.asarray(xs[i:i + 50]), cfg), cfg)
    qs = jnp.asarray(_queries(QB, 5))
    grid = _SW_GRID(st, cfg)
    return (pj, xs, qs, st, grid, _SW_Q(st, pj, qs, cfg),
            _SW_GQ(grid, pj, qs, cfg))


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_swakde_matches_reference(swakde_ref, n):
    pj, xs, qs, want, grid_want, q_want, gq_want = swakde_ref
    np.testing.assert_array_equal(np.asarray(q_want), np.asarray(gq_want))
    cfg = _sw_cfg(swakde)
    ctx = _ctx(n)
    st, p = ss.shard_swakde(swakde.swakde_init(cfg, "cpu"), port_params(pj),
                            ctx)
    # chunk 0 fused, the rest prepared ahead of their commits
    st = ss.sharded_swakde_update_chunk(st, p, _t(xs[:50]), cfg, ctx)
    preps = [ss.sharded_swakde_prepare_chunk(p, _t(xs[i:i + 50]), cfg, ctx)
             for i in range(50, _SW_N, 50)]
    for prep in preps:
        st = ss.sharded_swakde_commit_chunk(st, prep, cfg, ctx)
    assert all(int(sh.t) == _SW_N > cfg.window for sh in st)
    assert_state_equal(ss.gather_state(st, ctx), want)
    grid = ss.sharded_swakde_grid_estimates(st, cfg, ctx)
    assert len(grid) == n and grid[0].shape == (cfg.L // n, cfg.W)
    np.testing.assert_array_equal(np_(torch.cat(grid)), np.asarray(grid_want))
    for got in (ss.sharded_swakde_query_from_grid(grid, p, _t(qs), cfg, ctx),
                ss.sharded_swakde_query_batch(st, p, _t(qs), cfg, ctx)):
        np.testing.assert_array_equal(np_(got), np.asarray(q_want))


_SANN_PREP = _jit(jsann.sann_prepare_chunk, static_argnums=(3,))
_SANN_COMMIT = _jit(jsann.sann_commit_chunk, static_argnums=(2,))
_SANN_DEL = _jit(jsann.sann_delete, static_argnums=(3,))
_SANN_MERGE = _jit(jsann.sann_merge, static_argnums=(3,))
_SANN_Q = _jit(jsann.sann_query_batch, static_argnums=(3,))
_SANN_TOPK = _jit(jsann.sann_query_topk_batch, static_argnums=(3, 4))
_SANN_N = 320                       # ~211 kept points in 168 slots


@pytest.fixture(scope="module")
def sann_ref():
    cfg = jsann.SANNConfig(**_SANN).resolved()
    pj = _svc_params("retrieval")
    xs = grid_data(_SANN_N, D, seed=7)
    keys = [jax.random.PRNGKey(10 + i) for i in range(_SANN_N // 64)]

    def insert(st, lo, key):
        prep = _SANN_PREP(pj, jnp.asarray(xs[lo:lo + 64]), key, cfg)
        return _SANN_COMMIT(st, prep, cfg)

    empty = jsann.sann_empty_state(cfg)
    st = empty
    for i, k in enumerate(keys):
        st = insert(st, 64 * i, k)
    st = _SANN_DEL(st, pj, jnp.asarray(xs[-5]), cfg)
    merged = _SANN_MERGE(insert(empty, 0, keys[0]), insert(empty, 64, keys[1]),
                         pj, cfg)
    qs = jnp.asarray(np.concatenate([xs[-8:], _queries(QB - 8, 8)]))
    return dict(pj=pj, xs=xs, st=st, merged=merged, qs=qs,
                cr=_SANN_Q(st, pj, qs, cfg), topk=_SANN_TOPK(st, pj, qs, cfg,
                                                             8))


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_sann_matches_reference(sann_ref, n):
    r = sann_ref
    cfg = sann.SANNConfig(**_SANN).resolved()
    ctx = _ctx(n)
    st0, p = ss.shard_sann(sann.sann_empty_state(cfg, "cpu"),
                           port_params(r["pj"]), ctx)
    assert st0[0].tables.shape[0] == cfg.L // n
    assert all(s.tables.is_contiguous() and s.tables.data_ptr() % 16 == 0
               for s in st0)
    xs = _t(r["xs"])
    keys = [prng.PRNGKey(10 + i, "cpu") for i in range(_SANN_N // 64)]
    st = ss.sharded_sann_insert_batch(st0, p, xs[:64], keys[0], cfg, ctx)
    for i in range(1, len(keys)):
        prep = ss.sharded_sann_prepare_chunk(p, xs[64 * i:64 * (i + 1)],
                                             keys[i], cfg, ctx)
        st = ss.sharded_sann_commit_chunk(st, prep, cfg, ctx)
    st = ss.sharded_sann_delete(st, p, xs[-5], cfg, ctx)
    single = ss.gather_state(st, ctx)
    assert int(single.write_ptr) != int(single.n_stored)        # wrapped
    assert_state_equal(single, r["st"])
    qs = _t(r["qs"])
    _same_result(ss.sharded_sann_query_batch(st, p, qs, cfg, ctx), r["cr"])
    assert np.asarray(r["cr"].found).any()
    _same_topk(ss.sharded_sann_query_topk_batch(st, p, qs, cfg, ctx, topk=8),
               r["topk"])
    a = ss.sharded_sann_insert_batch(st0, p, xs[:64], keys[0], cfg, ctx)
    b = ss.sharded_sann_insert_batch(st0, p, xs[64:128], keys[1], cfg, ctx)
    assert_state_equal(
        ss.gather_state(ss.sharded_sann_merge(a, b, p, cfg, ctx), ctx),
        r["merged"])


def test_topk_merge_drops_duplicates_and_breaks_ties_by_column():
    ids = torch.tensor([[3, 5, -1, 5, 3, 7]], dtype=torch.int32)
    d = torch.tensor([[1.0, 2.0, float("inf"), 2.0, 1.0, 1.0]])
    got_ids, got_d = ss._topk_merge(ids, d, 5)
    assert got_ids.tolist() == [[3, 7, 5, -1, -1]]
    assert got_d.tolist() == [[1.0, 1.0, 2.0, float("inf"), float("inf")]]


# --------------------------------------------------------------------------
# tenant-sharded fleets, against the reference's unsharded fleet functions
# --------------------------------------------------------------------------
#
# T = 16 tenants with skewed shares (tenant t's weight 1/(t+1)) in 6 mixed
# chunks, a few ids out of range (dropped): the heavy tenants' SW-AKDE
# windows expire and their S-ANN rings wrap, the light tenants' do not.

T = 16
_FLEET_B, _FLEET_CHUNKS = 320, 6
_FLEET_SW = dict(L=4, W=32, window=64, eh_eps=0.2)
_FLEET_SANN = dict(dim=D, n_max=16, eta=0.3, r=0.5, c=2.0, w=1.0, L=4, k=2)

_RF_INGEST = _jit(jfleet.race_fleet_ingest)
_RF_Q = _jit(jfleet.race_fleet_query, static_argnums=(4,))
_SF_INGEST = _jit(jfleet.swakde_fleet_ingest, static_argnums=(4, 5))
_SF_Q = _jit(jfleet.swakde_fleet_query, static_argnums=(4,))
_AF_INGEST = _jit(jfleet.sann_fleet_ingest, static_argnums=(5, 6))
_AF_TOPK = _jit(jfleet.sann_fleet_query_topk, static_argnums=(4, 5))
_AF_Q = _jit(jfleet.sann_fleet_query, static_argnums=(4,))


def _fleet_keys(chunk):
    return fleet.sann_fleet_keys(prng.fold_in(prng.PRNGKey(5, "cpu"), chunk),
                                 torch.arange(T))


@pytest.fixture(scope="module")
def fleet_ref():
    rng = np.random.default_rng(11)
    n = _FLEET_B * _FLEET_CHUNKS
    w = 1.0 / np.arange(1, T + 1)
    tids = rng.choice(T, size=n, p=w / w.sum()).astype(np.int32)
    tids[rng.choice(n, size=12, replace=False)] = rng.choice([-1, T], 12)
    xs = grid_data(n, D, seed=12)
    chunks = [(i, xs[i:i + _FLEET_B], tids[i:i + _FLEET_B])
              for i in range(0, n, _FLEET_B)]
    cap = max(int(np.bincount(t[t >= 0], minlength=T + 1)[:T].max())
              for _, _, t in chunks)
    q_t = rng.integers(0, T, size=30).astype(np.int32)
    qs, own = _queries(30, 13), np.flatnonzero((tids >= 0) & (tids < T))[-30:]
    r = dict(xs=xs, tids=tids, cap=cap, qs=qs, qt=q_t, own=own)

    rp = exact_params("srp", 14, D, 6, 3, 32)
    st = jfleet.fleet_broadcast(jrace.race_init(6, 32), T)
    for _, x, t in chunks:
        st = _RF_INGEST(st, rp, jnp.asarray(x), jnp.asarray(t))
    r["race"] = (rp, st, _RF_Q(st, rp, jnp.asarray(qs), jnp.asarray(q_t), 2))

    cfg = jswakde.SWAKDEConfig(**_FLEET_SW)
    sp = exact_params("pstable", 15, D, 4, 2, 32, w=1.0)
    st = jfleet.fleet_broadcast(jswakde.swakde_init(cfg), T)
    for _, x, t in chunks:
        st = _SF_INGEST(st, sp, jnp.asarray(x), jnp.asarray(t), cfg, cap)
    t_end = np.asarray(st.t)
    assert (t_end > cfg.window).any() and (t_end <= cfg.window).any()
    r["swakde"] = (sp, st, _SF_Q(st, sp, jnp.asarray(qs), jnp.asarray(q_t),
                                 cfg))

    acfg = jsann.SANNConfig(**_FLEET_SANN).resolved()
    ap = exact_params("pstable", 16, D, acfg.L, acfg.k, acfg.n_buckets,
                      w=1.0)
    st = jfleet.fleet_broadcast(jsann.sann_empty_state(acfg), T)
    for c, (_, x, t) in enumerate(chunks):
        keys = jnp.asarray(convert.key_to_numpy(_fleet_keys(c)))
        st = _AF_INGEST(st, ap, jnp.asarray(x), jnp.asarray(t), keys, acfg,
                        cap)
    wrapped = np.asarray(st.write_ptr) != np.asarray(st.n_stored)
    assert wrapped.any() and not wrapped.all()
    r["sann"] = (ap, st, _AF_TOPK(st, ap, jnp.asarray(qs), jnp.asarray(q_t),
                                  acfg, 40),
                 _AF_Q(st, ap, jnp.asarray(xs[own]), jnp.asarray(tids[own]),
                       acfg))
    return r


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_fleets_match_unsharded(fleet_ref, n):
    """Each tenant-sharded fleet over n shards against the reference's
    unsharded fleet on the same chunks: stacked states bit-identical,
    estimates equal, S-ANN ids equal and distances within the scorer's
    tolerance, the top-k's -1 / inf padding through the owner-masked sum."""
    r = fleet_ref
    ctx = _ctx(n)
    xs, tids, cap = _t(r["xs"]), _t(r["tids"]), r["cap"]
    qs, qt = _t(r["qs"]), _t(r["qt"])
    chunks = [(xs[i:i + _FLEET_B], tids[i:i + _FLEET_B])
              for i in range(0, xs.shape[0], _FLEET_B)]

    rp, want, q_want = r["race"]
    st, p = ss.shard_fleet(fleet.fleet_broadcast(race.race_init(6, 32, "cpu"),
                                                 T), port_params(rp), ctx)
    assert st[0].counts.shape == (T // n, 6, 32) and p[0].L == 6
    for x, t in chunks:
        st = ss.sharded_race_fleet_ingest(st, p, x, t, ctx)
    assert_state_equal(ss.gather_fleet(st, ctx), want)
    np.testing.assert_array_equal(
        np_(ss.sharded_race_fleet_query(st, p, qs, qt, ctx, 2)),
        np.asarray(q_want))

    cfg = swakde.SWAKDEConfig(**_FLEET_SW)
    sp, want, q_want = r["swakde"]
    st, p = ss.shard_fleet(fleet.fleet_broadcast(swakde.swakde_init(cfg, "cpu"),
                                                 T), port_params(sp), ctx)
    for x, t in chunks:
        st = ss.sharded_swakde_fleet_ingest(st, p, x, t, cfg, cap, ctx)
    assert_state_equal(ss.gather_fleet(st, ctx), want)
    np.testing.assert_array_equal(
        np_(ss.sharded_swakde_fleet_query(st, p, qs, qt, cfg, ctx)),
        np.asarray(q_want))

    acfg = sann.SANNConfig(**_FLEET_SANN).resolved()
    ap, want, topk_want, cr_want = r["sann"]
    st, p = ss.shard_fleet(fleet.fleet_broadcast(
        sann.sann_empty_state(acfg, "cpu"), T), port_params(ap), ctx)
    for c, (x, t) in enumerate(chunks):
        st = ss.sharded_sann_fleet_ingest(st, p, x, t, _fleet_keys(c), acfg,
                                          cap, ctx)
    assert_state_equal(ss.gather_fleet(st, ctx), want)
    got = ss.sharded_sann_fleet_query_topk(st, p, qs, qt, acfg, ctx, topk=40)
    assert (got[0] == -1).any() and torch.isinf(got[1]).any()   # padding
    _same_topk(got, topk_want)
    own = torch.from_numpy(r["own"])
    got = ss.sharded_sann_fleet_query(st, p, xs[own], tids[own], acfg, ctx)
    assert np.asarray(cr_want.found).any() and got.found.dtype == torch.bool
    _same_result(got, cr_want)


# --------------------------------------------------------------------------
# the services at num_shards = 8, durable across packages
# --------------------------------------------------------------------------

def _port_svc(kind, **extra):
    cfg_cls, cls, *_ = SVC[kind]
    return cls(cfg_cls(**SVC[kind][4], **extra), device="cpu",
               params=port_params(_svc_params(kind)))


def _ref_svc(kind, **extra):
    """A reference single-device service with the exact params, its jitted
    functions replaced by this module's compiled ones of the same core
    functions (what its closures call on one device)."""
    *_, cfg_cls, cls, kw = SVC[kind]
    pj = _svc_params(kind)
    draw = lambda *a, **k: pj                               # noqa: E731
    with mock.patch.object(jlsh, "init_srp", draw), \
            mock.patch.object(jlsh, "init_pstable", draw):
        svc = cls(cfg_cls(**kw, **extra))
    assert svc.params is pj
    if kind == "retrieval":
        c = svc.cfg
        svc._prepare_fn = lambda xs, key: _SANN_PREP(pj, xs, key, c)
        svc._commit_fn = lambda st, prep: _SANN_COMMIT(st, prep, c)
        svc._query_fn = lambda st, qs: _SANN_Q(st, pj, qs, c)
        svc._topk_fn = lambda st, qs: _SANN_TOPK(st, pj, qs, c, kw["topk"])
        svc._delete_fn = lambda st, x: _SANN_DEL(st, pj, x, c)
    elif kind == "kde":
        c = svc.sketch_cfg
        svc._prepare_fn = lambda xs: _SW_PREP(pj, xs, c)
        svc._commit_fn = lambda st, prep: _SW_COMMIT(st, prep, c)
        svc._query_fn = lambda st, qs: _SW_Q(st, pj, qs, c)
        svc._grid_fn = lambda st: _SW_GRID(st, c)
        svc._grid_query_fn = lambda g, qs: _SW_GQ(g, pj, qs, c)
    else:
        svc._prepare_fn = lambda xs: _RACE_PREP(pj, xs, kw["W"])
        svc._commit_fn = lambda st, prep: _RACE_COMMIT(st, prep, 1)
        svc._delete_commit_fn = lambda st, prep: _RACE_COMMIT(st, prep, -1)
        svc._query_fn = lambda st, qs: _RACE_Q(st, pj, qs,
                                               kw["median_of_means"])
    return svc


def _head(kind, svc, data):
    """Four chunks (the snapshot), the logged mutation, one chunk."""
    chunk = SVC[kind][4]["ingest_chunk"]
    svc.ingest(data[:4 * chunk])
    if kind == "retrieval":
        svc.delete(data[10])
    elif kind == "race":
        svc.delete(data[:chunk])
    else:
        svc.advance_clock(svc.steps + 30)
    svc.ingest(data[4 * chunk:_tail(kind)])


def _tail(kind):
    return 5 * SVC[kind][4]["ingest_chunk"]


@pytest.mark.parametrize("kind", sorted(SVC))
def test_sharded_services_recover_across_packages(tmp_path, kind):
    """The reference's single-device service writes a directory that a
    port service on 8 shards recovers, and the other way round; both take
    the rest of the stream and end in the same state (the port's gathered)
    with the same answers."""
    n = 8 * SVC[kind][4]["ingest_chunk"]        # whole chunks
    data = grid_data(n, D, seed=22)
    dur = dict(snapshot_every=4)
    w = _ref_svc(kind, snapshot_dir=str(tmp_path / "ref"), **dur)
    _head(kind, w, data)
    w.close()
    p8 = _port_svc(kind, num_shards=8, snapshot_dir=str(tmp_path / "ref"),
                   **dur)
    assert p8.num_shards == 8 and len(p8.state) == 8
    assert p8.recover() == 2             # the mutation and one chunk
    p8.ingest(data[_tail(kind):])
    w8 = _port_svc(kind, num_shards=8, snapshot_dir=str(tmp_path / "port"),
                   **dur)
    _head(kind, w8, data)
    w8.close()
    r = _ref_svc(kind, snapshot_dir=str(tmp_path / "port"), **dur)
    assert r.recover() == 2
    r.ingest(data[_tail(kind):])
    assert_state_equal(p8.gather_state(p8.state), r.state)
    qs = _queries(QB, 23)
    if kind == "retrieval":
        assert p8.stored == r.stored
        _same_result(p8.query(qs), r.query(qs))
        _same_topk(p8.query_topk(qs), r.query_topk(qs))
    elif kind == "race":
        assert p8.count == r.count == n - 64
        np.testing.assert_array_equal(p8.query(qs), np.asarray(r.query(qs)))
        np.testing.assert_array_equal(p8.kde(qs), np.asarray(r.kde(qs)))
    else:
        assert p8.steps == r.steps == n + 30
        np.testing.assert_array_equal(p8.query(qs), np.asarray(r.query(qs)))
        np.testing.assert_array_equal(p8.density(qs),
                                      np.asarray(r.density(qs)))
    p8.close()
    r.close()


def test_sharded_sann_recovery_matches_single_run(tmp_path):
    """A table-sharded durable service crash-recovers onto the mesh
    (`_place_state` re-shards the restored snapshot) bit-identically to
    the uninterrupted sharded run, and its snapshots are the single-device
    service's byte for byte."""
    data = grid_data(384, D, seed=24)
    live = _port_svc("retrieval", num_shards=8)
    live.ingest(data)
    one = _port_svc("retrieval", snapshot_dir=str(tmp_path / "one"),
                    snapshot_every=2)
    one.ingest(data)
    one.close()
    a = _port_svc("retrieval", num_shards=8, snapshot_dir=str(tmp_path / "a"),
                  snapshot_every=2)
    a.ingest(data)                       # the crash point: WAL + snapshots
    a.close()
    for step in ("step_4", "step_6"):
        for f in (tmp_path / "one" / step).iterdir():
            assert f.read_bytes() == (tmp_path / "a" / step / f.name
                                      ).read_bytes(), (step, f.name)
    b = _port_svc("retrieval", num_shards=8, snapshot_dir=str(tmp_path / "a"),
                  snapshot_every=2)
    assert b.recover() < 384 // 64       # the snapshot was used
    assert len(b.state) == 8
    assert_state_equal(b.gather_state(b.state), live.gather_state(live.state))
    qs = data[-6:] + np.float32(1 / 32)
    for x, y in zip(b.query(qs), live.query(qs)):
        np.testing.assert_array_equal(x, y)
    b.close()
    live.close()


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def test_sharding_refusals():
    cfg = jsann.SANNConfig(**_SANN).resolved()
    with pytest.raises(ValueError, match="L=8 not divisible by num_shards=3"):
        ss.shard_sann(sann.sann_empty_state(sann.SANNConfig(**_SANN)
                                            .resolved(), "cpu"),
                      port_params(exact_params("pstable", 6, D, cfg.L, cfg.k,
                                               cfg.n_buckets, w=cfg.w)),
                      _ctx(3))
    with pytest.raises(ValueError, match="not divisible by num_shards=3"):
        _port_svc("race", num_shards=3)
    too_many = (torch.cuda.device_count() if torch.cuda.is_available()
                else 0) + 1
    with pytest.raises(ValueError, match="devices visible"):
        ss.make_sketch_mesh(too_many, "cuda")
    with pytest.raises(ValueError, match="'shard'"):
        ss.make_sketch_ctx(Mesh(("cpu",) * 2, axis_names=("data",)))
    with pytest.raises(TypeError, match="Mesh"):
        ss.make_sketch_ctx(("cpu", "cpu"))
    with pytest.raises(ValueError, match="one type"):
        Mesh(("cpu", "meta"))
    assert ss.ctx_num_shards(ss.make_service_ctx(None, 1, "cpu")) == 1
    mesh = ss.make_sketch_mesh(4, "cpu")
    assert mesh.shape["shard"] == 4 and set(mesh.devices) == {
        torch.device("cpu")}
    # a p-stable row block holds the whole projection and names its rows;
    # a projection of the wrong width is refused
    pp = port_params(exact_params("pstable", 6, D, 8, 3, 32, w=1.0))
    blocks = ss.shard_params(pp, _ctx(4))
    assert [b.row0 for b in blocks] == [0, 2, 4, 6]
    assert all(b.proj.shape == (D, 24) and b.bias.shape == (6,)
               for b in blocks)
    x = torch.from_numpy(grid_data(3, D, seed=9))
    assert torch.equal(torch.cat([lsh.pstable_hash(b, x) for b in blocks], 1),
                       lsh.pstable_hash(pp, x))
    with pytest.raises(ValueError, match=r"24 columns; .* \[0, 12\)"):
        lsh.pstable_hash(pp._replace(L=4, bias=pp.bias[:12]), x)
    with pytest.raises(ValueError, match=r"\[24, 30\)"):
        lsh.pstable_hash(blocks[3]._replace(row0=8), x)
    with pytest.raises(ValueError, match="no tensor on a card"):
        _build.launch("race_hist", "race_hist_launch", torch.zeros(2), 1)
