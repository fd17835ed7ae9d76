"""S-ANN parity: repro_torch.core.sann against repro.core.sann on the CPU.

A stream of chunks with the reference's keep masks and codes injected
(`sann_prepare_given_keep(..., codes=...)`) covers point-ring wrap,
eviction tombstones and bucket-ring wrap; every state leaf is bit-exact
after every chunk.  Queries, deletes and merges then run on both states
with each package hashing on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sann as jsann
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.core import sann as tsann

from torch_parity import (assert_state_equal, assert_topk_match, fields, np_,
                          ref_pstable)

CFG = dict(dim=8, n_max=400, eta=0.3, r=3.0, c=1.5, w=4.0, L=4, k=2,
           bucket_cap=4, capacity_slack=0.5)      # capacity 64, 256 buckets
CHUNK, N_CHUNKS = 48, 5

_prep = jax.jit(jsann.sann_prepare_given_keep, static_argnums=(3,))
_commit = jax.jit(jsann.sann_commit_chunk, static_argnums=(2,))
_query = jax.jit(jsann.sann_query_batch, static_argnums=(3,))
_query_topk = jax.jit(jsann.sann_query_topk_batch, static_argnums=(3, 4))
_first = jax.jit(jsann._first_occurrence_mask, static_argnums=(1,))
_delete = jax.jit(jsann.sann_delete, static_argnums=(3,))
_merge = jax.jit(jsann.sann_merge, static_argnums=(3,))


def _stream(seed):
    """Points, keep masks (heavier than keep_prob, so the 64-slot ring wraps)
    and codes with few distinct values per row (so bucket rings wrap)."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(N_CHUNKS, CHUNK, CFG["dim"])).astype(np.float32)
    keep = rng.random((N_CHUNKS, CHUNK)) < 0.45
    codes = rng.integers(0, 12, size=(N_CHUNKS, CHUNK, CFG["L"])).astype(np.int32)
    return xs, keep, codes


@pytest.fixture(scope="module")
def built():
    cfg_j = jsann.SANNConfig(**CFG).resolved()
    params_j = ref_pstable(0, cfg_j.dim, cfg_j.L, cfg_j.k, cfg_j.w,
                           cfg_j.n_buckets)
    st_j = jsann.sann_empty_state(cfg_j)
    cfg_t = tsann.SANNConfig(**CFG).resolved()
    assert (cfg_t.capacity, cfg_t.n_buckets, cfg_t.L, cfg_t.k) == \
        (cfg_j.capacity, cfg_j.n_buckets, cfg_j.L, cfg_j.k) == (64, 256, 4, 2)
    params_t = convert.params_from_numpy(fields(params_j), device="cpu")
    st_t = tsann.sann_empty_state(cfg_t, device="cpu")
    xs, keep, codes = _stream(1)
    per_chunk = []
    for x, kp, c in zip(xs, keep, codes):
        st_j = _commit(st_j, _prep(params_j, jnp.asarray(x), jnp.asarray(kp),
                                   cfg_j, codes=jnp.asarray(c)), cfg_j)
        st_t = tsann.sann_commit_chunk(
            st_t, tsann.sann_prepare_given_keep(
                params_t, torch.from_numpy(x), torch.from_numpy(kp), cfg_t,
                codes=torch.from_numpy(c)), cfg_t)
        per_chunk.append((st_t, st_j))
    return cfg_j, params_j, cfg_t, params_t, per_chunk, xs


def test_ingest_state_bit_exact_every_chunk(built):
    *_, per_chunk, xs = built
    for st_t, st_j in per_chunk:
        assert_state_equal(st_t, st_j)
    final = per_chunk[-1][0]
    assert int(final.n_seen) == N_CHUNKS * CHUNK
    assert int(final.n_stored) == int(final.valid.sum())
    assert (final.tables == -1).any() and (final.stamps >= 0).all()
    # the point ring wrapped and some bucket overflowed its ring
    assert _stream(1)[1].sum() > 1.5 * built[2].capacity
    assert int(final.table_ptr.max()) > CFG["bucket_cap"]


def test_convert_round_trip(built):
    *_, per_chunk, _ = built
    st_t = per_chunk[-1][0]
    back = convert.sann_state_from_numpy(convert.to_numpy(st_t), device="cpu")
    assert_state_equal(back, st_t)


def _queries(xs, seed):
    rng = np.random.default_rng(seed)
    flat = xs.reshape(-1, xs.shape[-1])
    return (flat[rng.choice(len(flat), 24, replace=False)]
            + 0.05 * rng.normal(size=(24, flat.shape[1]))).astype(np.float32)


def test_query_batch_matches_reference(built):
    cfg_j, params_j, cfg_t, params_t, per_chunk, xs = built
    st_t, st_j = per_chunk[-1]
    qs = _queries(xs, 2)
    rj = _query(st_j, params_j, jnp.asarray(qs), cfg_j)
    rt = tsann.sann_query_batch(st_t, params_t, torch.from_numpy(qs), cfg_t)
    np.testing.assert_array_equal(np_(rt.found), np.asarray(rj.found))
    np.testing.assert_array_equal(np_(rt.index), np.asarray(rj.index))
    np.testing.assert_array_equal(np_(rt.n_candidates), np.asarray(rj.n_candidates))
    np.testing.assert_allclose(np_(rt.distance), np.asarray(rj.distance),
                               rtol=1e-5, atol=1e-6)
    assert np.asarray(rj.found).any()


def test_query_topk_batch_matches_reference(built):
    cfg_j, params_j, cfg_t, params_t, per_chunk, xs = built
    st_t, st_j = per_chunk[-1]
    qs = _queries(xs, 3)
    ids_j, dj = _query_topk(st_j, params_j, jnp.asarray(qs), cfg_j, 5)
    ids_t, dt = tsann.sann_query_topk_batch(st_t, params_t,
                                            torch.from_numpy(qs), cfg_t, topk=5)
    pts = np.asarray(st_j.points, np.float64)
    exact = ((pts[None] - qs[:, None].astype(np.float64)) ** 2).sum(-1)
    exact = np.concatenate([exact, np.full((len(qs), 1), np.inf)], 1)
    # compare squared distances; ids index the point store (-1 → inf column)
    assert_topk_match(np_(dt) ** 2, np_(ids_t), np.asarray(dj) ** 2,
                      np.asarray(ids_j), exact)
    assert (np.asarray(ids_j) >= 0).any()


def test_first_occurrence_mask_both_branches():
    rng = np.random.default_rng(4)
    cand = rng.integers(-1, 40, size=(6, 30)).astype(np.int32)
    for capacity in (40, 100_000):                   # scatter-min / argsort
        ref = np.asarray(_first(jnp.asarray(cand), capacity))
        got = tsann._first_occurrence_mask(torch.from_numpy(cand), capacity)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_delete_matches_reference(built):
    cfg_j, params_j, cfg_t, params_t, per_chunk, _ = built
    st_t, st_j = per_chunk[-1]
    slot = int(np.flatnonzero(np.asarray(st_j.valid))[3])
    x = np.asarray(st_j.points)[slot]
    dj = _delete(st_j, params_j, jnp.asarray(x), cfg_j)
    dt = tsann.sann_delete(st_t, params_t, torch.from_numpy(x.copy()), cfg_t)
    assert_state_equal(dt, dj)
    assert int(dt.n_stored) == int(st_t.n_stored) - 1


def test_merge_matches_reference(built):
    """Merge of two disjoint-stream sketches (one of them wrapped), with
    eviction: the union exceeds capacity."""
    cfg_j, params_j, cfg_t, params_t, per_chunk, _ = built
    a_t, a_j = per_chunk[1]
    b_t, b_j = per_chunk[-1]
    mj = _merge(a_j, b_j, params_j, cfg_j)
    mt = tsann.sann_merge(a_t, b_t, params_t, cfg_t)
    assert int(a_t.n_stored) + int(b_t.n_stored) > cfg_t.capacity
    assert_state_equal(mt, mj)


def test_sann_bytes_matches_reference():
    kw = dict(dim=128, n_max=1_000_000, eta=0.3, r=1.0, c=1.5, L=12, k=6,
              bucket_cap=32)
    assert tsann.sann_bytes(tsann.SANNConfig(**kw)) == \
        jsann.sann_bytes(jsann.SANNConfig(**kw))


def test_insert_chunked_is_prepare_then_commit(built):
    """`sann_insert_chunked` gives chunk j the key ``split(key, n)[j]``:
    the same as preparing and committing chunk by chunk under those keys."""
    *_, cfg_t, params_t, _, xs = built
    flat = torch.from_numpy(xs.reshape(-1, xs.shape[-1]))
    key = prng.PRNGKey(3, device="cpu")
    a = tsann.sann_insert_chunked(tsann.sann_empty_state(cfg_t, "cpu"), params_t,
                                  flat, key, cfg_t, chunk=100)
    b = tsann.sann_empty_state(cfg_t, "cpu")
    n = -(-flat.shape[0] // 100)
    for j, ck in enumerate(prng.split(key, n)):
        b = tsann.sann_commit_chunk(
            b, tsann.sann_prepare_chunk(params_t, flat[j * 100:(j + 1) * 100],
                                        ck, cfg_t), cfg_t)
    assert_state_equal(a, b)
    assert int(a.n_seen) == flat.shape[0]


def test_keep_fraction_within_6_sigma():
    """The keep draw (threefry bernoulli per point) keeps the expected
    fraction of a long chunk."""
    cfg = tsann.SANNConfig(dim=2, n_max=400, eta=0.3, r=1.0, c=1.5, L=2, k=1,
                           bucket_cap=2).resolved()
    g = torch.Generator().manual_seed(5)
    params = tsann.lsh.init_pstable(g, 2, cfg.L, cfg.k, cfg.w, cfg.n_buckets,
                                    device="cpu")
    n = 20_000
    prep = tsann.sann_prepare_chunk(params, torch.zeros(n, 2),
                                    prng.PRNGKey(5, device="cpu"), cfg)
    p = cfg.keep_prob
    frac = float(prep.keep.float().mean())
    assert abs(frac - p) <= 6 * (p * (1 - p) / n) ** 0.5
    assert int(prep.n_kept) == int(prep.keep.sum())


def test_commit_leaves_its_input_state_untouched(built):
    """The commit's table update (`ops.sann_table_commit`) writes a new
    tables tensor: recommitting chunk 2 onto chunk 1's state leaves that
    state as it was and gives chunk 2's state again."""
    *_, cfg_t, params_t, per_chunk, xs = built
    _, keep, codes = _stream(1)
    st = per_chunk[1][0]
    before = {f: getattr(st, f).clone() for f in st._fields}
    again = tsann.sann_commit_chunk(st, tsann.sann_prepare_given_keep(
        params_t, torch.from_numpy(xs[2]), torch.from_numpy(keep[2]), cfg_t,
        codes=torch.from_numpy(codes[2])), cfg_t)
    for f, t in before.items():
        assert torch.equal(getattr(st, f), t), f
    assert_state_equal(again, per_chunk[2][0])
    assert again.tables.data_ptr() != st.tables.data_ptr()
