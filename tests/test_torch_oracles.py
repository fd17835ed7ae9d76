"""The per-point oracle paths of the port against the reference on the CPU:
S-ANN `sann_insert_stream` / `sann_query` / `sann_query_topk`, RACE
`race_update` / `race_query` / `race_kde`, SW-AKDE `swakde_stream` /
`swakde_query` / `swakde_kde`, `swakde_merge` and the Corollary-4.2
`BatchSWAKDE`.

Each package hashes on its own (the reference's params cross over through
`convert`) and draws its own keep decisions from the same key.  Integer
state is bit-exact; distances agree within (1e-5, 1e-6), the summation
order of the fp32 scorer; ids are equal (no near-ties at these inputs);
KDE estimates are equal floats (the same integer reductions, then the same
float operations).  Reference streams run under one jitted ``lax.scan``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import race as jrace
from repro.core import sann as jsann
from repro.core import swakde as jswakde
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.core import race as trace
from repro_torch.core import sann as tsann
from repro_torch.core import swakde as tswakde

from torch_parity import RTOL, ATOL, assert_state_equal, fields, np_, ref_pstable, ref_srp

DIM = 8
# keep_prob 0.55 into 109 slots: 200 points wrap the ring, so kept points
# evict live slots and tombstone their table entries.
SANN = dict(dim=DIM, n_max=400, eta=0.1, r=3.0, c=1.5, w=4.0, L=4, k=2,
            bucket_cap=4, capacity_slack=0.5)


@pytest.fixture(scope="module")
def sann_built():
    cfg_j, cfg_t = jsann.SANNConfig(**SANN).resolved(), tsann.SANNConfig(**SANN).resolved()
    params_j = ref_pstable(0, DIM, cfg_j.L, cfg_j.k, cfg_j.w, cfg_j.n_buckets)
    params_t = convert.params_from_numpy(fields(params_j), device="cpu")
    xs = np.random.default_rng(1).normal(size=(200, DIM)).astype(np.float32)
    st_j = jax.jit(jsann.sann_insert_stream, static_argnums=(4,))(
        jsann.sann_empty_state(cfg_j), params_j, jnp.asarray(xs),
        jax.random.PRNGKey(3), cfg_j)
    st_t = tsann.sann_insert_stream(tsann.sann_empty_state(cfg_t, "cpu"),
                                    params_t, torch.from_numpy(xs),
                                    prng.PRNGKey(3), cfg_t)
    return cfg_j, cfg_t, params_j, params_t, xs, st_j, st_t


def test_sann_insert_stream_matches_reference_with_eviction(sann_built):
    cfg_j, cfg_t, _, params_t, xs, st_j, st_t = sann_built
    assert_state_equal(st_t, st_j)
    kept = int(prng.bernoulli(tsann.sann_row_keys(prng.PRNGKey(3), 200),
                              cfg_t.keep_prob).sum())
    assert kept > cfg_t.capacity and int(st_t.n_stored) == cfg_t.capacity
    # the batched path under the same key is bit-identical
    batch = tsann.sann_insert_batch(tsann.sann_empty_state(cfg_t, "cpu"),
                                    params_t, torch.from_numpy(xs),
                                    prng.PRNGKey(3), cfg_t)
    assert_state_equal(batch, st_t)


def test_sann_insert_one_point_matches_reference(sann_built):
    cfg_j, cfg_t, params_j, params_t, xs, st_j, st_t = sann_built
    one_j = jax.jit(jsann.sann_insert, static_argnums=(4,))
    for seed in range(6):                  # keep_prob 0.55: both branches
        kj = jax.random.PRNGKey(seed)
        got = tsann.sann_insert(st_t, params_t, torch.from_numpy(xs[seed]),
                                convert.key_from_numpy(np.asarray(kj), "cpu"),
                                cfg_t)
        assert_state_equal(got, one_j(st_j, params_j, jnp.asarray(xs[seed]),
                                      kj, cfg_j))


def test_sann_insert_chunked_matches_reference(sann_built):
    cfg_j, cfg_t, params_j, params_t, xs, _, _ = sann_built
    ref = jax.jit(jsann.sann_insert_chunked, static_argnums=(4, 5))(
        jsann.sann_empty_state(cfg_j), params_j, jnp.asarray(xs),
        jax.random.PRNGKey(5), cfg_j, 64)
    got = tsann.sann_insert_chunked(tsann.sann_empty_state(cfg_t, "cpu"),
                                    params_t, torch.from_numpy(xs),
                                    prng.PRNGKey(5), cfg_t, chunk=64)
    assert_state_equal(got, ref)


def _sann_queries(xs, n=16):
    """Near copies of stream points, the last four moved far away (NULL)."""
    rng = np.random.default_rng(2)
    qs = xs[rng.choice(len(xs), n, replace=False)] \
        + 0.05 * rng.normal(size=(n, DIM))
    qs[-4:] += 6.0
    return qs.astype(np.float32)


def test_sann_query_matches_reference_and_batch(sann_built):
    cfg_j, cfg_t, params_j, params_t, xs, st_j, st_t = sann_built
    qs = _sann_queries(xs)
    ref = jax.jit(jax.vmap(jsann.sann_query, in_axes=(None, None, 0, None)),
                  static_argnums=(3,))(st_j, params_j, jnp.asarray(qs), cfg_j)
    batch = tsann.sann_query_batch(st_t, params_t, torch.from_numpy(qs), cfg_t)
    for i, q in enumerate(qs):
        r = tsann.sann_query(st_t, params_t, torch.from_numpy(q), cfg_t)
        assert r.index.dtype == torch.int32 and r.n_candidates.dtype == torch.int32
        for name in ("index", "found", "n_candidates"):
            assert np_(getattr(r, name)) == np.asarray(getattr(ref, name))[i], name
            assert np_(getattr(r, name)) == np_(getattr(batch, name))[i], name
        np.testing.assert_allclose(np_(r.distance), np.asarray(ref.distance)[i],
                                   rtol=RTOL, atol=ATOL)
    assert np.asarray(ref.found).any() and not np.asarray(ref.found).all()


def test_sann_query_topk_matches_reference(sann_built):
    cfg_j, cfg_t, params_j, params_t, xs, st_j, st_t = sann_built
    qs = _sann_queries(xs)
    ids_j, d_j = jax.jit(jax.vmap(jsann.sann_query_topk,
                                  in_axes=(None, None, 0, None, None)),
                         static_argnums=(3, 4))(st_j, params_j, jnp.asarray(qs),
                                                cfg_j, 16)
    for i, q in enumerate(qs):
        ids, d = tsann.sann_query_topk(st_t, params_t, torch.from_numpy(q),
                                       cfg_t, topk=16)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j)[i])
        np.testing.assert_allclose(d.numpy(), np.asarray(d_j)[i], rtol=RTOL,
                                   atol=ATOL)
    assert (np.asarray(ids_j) == -1).any() and (np.asarray(ids_j) >= 0).any()


@pytest.fixture(scope="module")
def kde_built():
    L, W = 6, 16
    params_j = ref_srp(4, DIM, L, 2, W)
    params_t = convert.params_from_numpy(fields(params_j), device="cpu")
    kw = dict(L=L, W=W, window=40, eh_eps=0.2)
    cfg_j, cfg_t = jswakde.SWAKDEConfig(**kw), tswakde.SWAKDEConfig(**kw)
    xs = np.random.default_rng(5).normal(size=(120, DIM)).astype(np.float32)
    xs[::3] = xs[0]                                  # a hot cell per row
    sw_j = jax.jit(jswakde.swakde_stream, static_argnums=(3,))(
        jswakde.swakde_init(cfg_j), params_j, jnp.asarray(xs), cfg_j)
    sw_t = tswakde.swakde_stream(tswakde.swakde_init(cfg_t, "cpu"), params_t,
                                 torch.from_numpy(xs), cfg_t)

    def race_scan(state, params, xs, signs):
        def step(s, xsg):
            return jrace.race_update(s, params, xsg[0], xsg[1]), None
        return jax.lax.scan(step, state, (xs, signs))[0]
    signs = np.where(np.arange(120) % 5 == 4, -1, 1).astype(np.int32)
    rc_j = jax.jit(race_scan)(jrace.race_init(L, W), params_j, jnp.asarray(xs),
                              jnp.asarray(signs))
    rc_t = trace.race_init(L, W, device="cpu")
    for x, sg in zip(xs, signs):
        rc_t = trace.race_update(rc_t, params_t, torch.from_numpy(x), int(sg))
    return cfg_j, cfg_t, params_j, params_t, xs, sw_j, sw_t, rc_j, rc_t


def test_swakde_stream_matches_reference_and_chunks(kde_built):
    cfg_j, cfg_t, _, params_t, xs, sw_j, sw_t, _, _ = kde_built
    assert_state_equal(sw_t, sw_j)
    assert int(sw_t.t) == 120 > cfg_t.window
    chunked = tswakde.swakde_stream_batched(tswakde.swakde_init(cfg_t, "cpu"),
                                            params_t, torch.from_numpy(xs),
                                            cfg_t, chunk=50)
    assert_state_equal(chunked, sw_t)


def test_race_update_matches_reference_turnstile(kde_built):
    *_, xs, _, _, rc_j, rc_t = kde_built
    assert_state_equal(rc_t, rc_j)
    assert int(rc_t.n) == 120 - 2 * 24


def test_per_query_kde_matches_reference_and_batch(kde_built):
    cfg_j, cfg_t, params_j, params_t, xs, sw_j, sw_t, rc_j, rc_t = kde_built
    qs = np.concatenate([xs[:3], np.random.default_rng(6).normal(
        size=(5, DIM))]).astype(np.float32)
    vq = lambda f, *static: jax.jit(jax.vmap(f, in_axes=(None, None, 0) + (None,) * len(static)),
                                    static_argnums=tuple(range(3, 3 + len(static))))
    sw_q = np.asarray(vq(jswakde.swakde_query, cfg_j)(sw_j, params_j, jnp.asarray(qs), cfg_j))
    sw_k = np.asarray(vq(jswakde.swakde_kde, cfg_j)(sw_j, params_j, jnp.asarray(qs), cfg_j))
    rc_q = np.asarray(vq(jrace.race_query, 3)(rc_j, params_j, jnp.asarray(qs), 3))
    rc_k = np.asarray(vq(jrace.race_kde, 0)(rc_j, params_j, jnp.asarray(qs), 0))
    batch_sw = tswakde.swakde_query_batch(sw_t, params_t, torch.from_numpy(qs), cfg_t)
    batch_rc = trace.race_query_batch(rc_t, params_t, torch.from_numpy(qs), 3)
    for i, q in enumerate(torch.from_numpy(qs)):
        got = tswakde.swakde_query(sw_t, params_t, q, cfg_t)
        assert got.dtype == torch.float32
        assert float(got) == sw_q[i] == float(batch_sw[i])
        assert float(tswakde.swakde_kde(sw_t, params_t, q, cfg_t)) == sw_k[i]
        assert float(trace.race_query(rc_t, params_t, q, 3)) == rc_q[i] == \
            float(batch_rc[i])
        assert float(trace.race_kde(rc_t, params_t, q)) == rc_k[i]
    assert (sw_q > 0).all()


def test_swakde_merge_matches_reference_and_commutes(kde_built):
    cfg_j, cfg_t, params_j, params_t, xs, *_ = kde_built
    a_t = tswakde.swakde_stream(tswakde.swakde_init(cfg_t, "cpu"), params_t,
                                torch.from_numpy(xs[0::2]), cfg_t)
    b_t = tswakde.swakde_stream(tswakde.swakde_init(cfg_t, "cpu"), params_t,
                                torch.from_numpy(xs[1::2]), cfg_t)
    to_j = lambda s: jswakde.SWAKDEState(*(jnp.asarray(np_(v)) for v in s))
    ref = jax.jit(jswakde.swakde_merge, static_argnums=(2,))(to_j(a_t), to_j(b_t), cfg_j)
    got = tswakde.swakde_merge(a_t, b_t, cfg_t)
    assert_state_equal(got, ref)
    assert_state_equal(tswakde.swakde_merge(b_t, a_t, cfg_t), got)
    assert int(got.num.sum()) > int(a_t.num.sum())


def test_batch_swakde_matches_reference():
    L, W, R = 5, 12, 16
    params_j = ref_pstable(8, DIM, L, 2, 4.0, W)
    params_t = convert.params_from_numpy(fields(params_j), device="cpu")
    kw = dict(L=L, W=W, window=6, eh_eps=0.25, batch_size=R)
    cfg_j, cfg_t = jswakde.BatchSWAKDEConfig(**kw), tswakde.BatchSWAKDEConfig(**kw)
    batches = np.random.default_rng(7).normal(size=(14, R, DIM)).astype(np.float32)

    def run(state, params, bs):
        def step(s, b):
            return jswakde.batch_swakde_update(s, params, b, cfg_j), None
        return jax.lax.scan(step, state, bs)[0]
    st_j = jax.jit(run)(jswakde.batch_swakde_init(cfg_j), params_j, jnp.asarray(batches))
    st_t = tswakde.batch_swakde_init(cfg_t, device="cpu")
    for b in batches:
        st_t = tswakde.batch_swakde_update(st_t, params_t, torch.from_numpy(b), cfg_t)
    assert_state_equal(st_t, st_j)
    back = convert.batch_swakde_state_from_numpy(convert.to_numpy(st_t), "cpu")
    assert_state_equal(back, st_t)
    qs = batches[-1, :4]
    ref = jax.jit(jax.vmap(jswakde.batch_swakde_query, in_axes=(None, None, 0, None)),
                  static_argnums=(3,))(st_j, params_j, jnp.asarray(qs), cfg_j)
    for i, q in enumerate(torch.from_numpy(qs)):
        got = tswakde.batch_swakde_query(st_t, params_t, q, cfg_t)
        assert float(got) == float(np.asarray(ref)[i]) > 0
