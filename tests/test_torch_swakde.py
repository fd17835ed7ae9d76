"""SW-AKDE and RACE parity: repro_torch.core.{swakde,race} against
repro.core.{swakde,race} on the CPU.

SW-AKDE chunks with injected codes cross EH expiry (window 40 < stream);
``ts, num, t`` are bit-exact after every chunk, dead ring slots included,
for ``heavy_cell_cap`` 0 and 2.  Estimates are equal floats: the same
integer reductions followed by one float operation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import race as jrace
from repro.core import swakde as jswakde
from repro_torch import convert
from repro_torch.core import race as trace
from repro_torch.core import swakde as tswakde

from torch_parity import assert_state_equal, fields, np_, ref_srp

DIM = 8
_prep_codes = jax.jit(jswakde.swakde_prepare_from_codes, static_argnums=(1,))
_commit = jax.jit(jswakde.swakde_commit_chunk, static_argnums=(2,))
_query = jax.jit(jswakde.swakde_query_batch, static_argnums=(3,))
_grid = jax.jit(jswakde.swakde_grid_estimates, static_argnums=(1,))
_query_grid = jax.jit(jswakde.swakde_query_from_grid, static_argnums=(3,))
_race_update = jax.jit(jrace.race_update_batch, static_argnums=(3,))
_race_query = jax.jit(jrace.race_query_batch, static_argnums=(3,))


@pytest.fixture(scope="module", params=[0, 2], ids=["cap0", "cap2"])
def built(request):
    kw = dict(L=4, W=16, window=40, eh_eps=0.2, heavy_cell_cap=request.param)
    cfg_j, cfg_t = jswakde.SWAKDEConfig(**kw), tswakde.SWAKDEConfig(**kw)
    rng = np.random.default_rng(request.param)
    st_j = jswakde.swakde_init(cfg_j)
    st_t = tswakde.swakde_init(cfg_t, device="cpu")
    states = []
    for chunk in (32, 32, 17, 32, 32):                   # 145 steps > window
        codes = rng.integers(0, 5, size=(chunk, cfg_j.L)).astype(np.int32)
        codes[: chunk // 2, 1] = 3                       # a hot cell
        st_j = _commit(st_j, _prep_codes(jnp.asarray(codes), cfg_j), cfg_j)
        st_t = tswakde.swakde_commit_chunk(
            st_t, tswakde.swakde_prepare_from_codes(torch.from_numpy(codes),
                                                    cfg_t), cfg_t)
        states.append((st_t, st_j))
    params_j = ref_srp(7, DIM, cfg_j.L, 2, cfg_j.W)
    params_t = convert.params_from_numpy(fields(params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t, states


def test_swakde_state_bit_exact_every_chunk(built):
    *_, states = built
    for st_t, st_j in states:
        assert_state_equal(st_t, st_j)
    st_t = states[-1][0]
    assert int(st_t.t) == 145
    back = convert.swakde_state_from_numpy(convert.to_numpy(st_t), device="cpu")
    assert_state_equal(back, st_t)


@pytest.mark.parametrize("B", [5, 40], ids=["B<W", "B>=W"])
def test_swakde_query_batch_matches_reference(built, B):
    cfg_j, cfg_t, params_j, params_t, states = built
    st_t, st_j = states[-1]
    qs = np.random.default_rng(B).normal(size=(B, DIM)).astype(np.float32)
    ref = np.asarray(_query(st_j, params_j, jnp.asarray(qs), cfg_j))
    got = tswakde.swakde_query_batch(st_t, params_t, torch.from_numpy(qs), cfg_t)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref > 0).any()


def test_swakde_query_from_grid_matches_reference(built):
    cfg_j, cfg_t, params_j, params_t, states = built
    st_t, st_j = states[-1]
    grid_j = _grid(st_j, cfg_j)
    grid_t = tswakde.swakde_grid_estimates(st_t, cfg_t)
    np.testing.assert_array_equal(grid_t.numpy(), np.asarray(grid_j))
    qs = np.random.default_rng(9).normal(size=(7, DIM)).astype(np.float32)
    ref = np.asarray(_query_grid(grid_j, params_j, jnp.asarray(qs), cfg_j))
    got = tswakde.swakde_query_from_grid(grid_t, params_t,
                                         torch.from_numpy(qs), cfg_t)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_swakde_bytes_matches_reference():
    kw = dict(L=96, W=96, window=65_536, eh_eps=0.1)
    assert tswakde.swakde_bytes(tswakde.SWAKDEConfig(**kw)) == \
        jswakde.swakde_bytes(jswakde.SWAKDEConfig(**kw))


def test_swakde_prepare_mask_matches_reference():
    """A prefix mask sends the tail rows to the sentinel segment."""
    cfg_j = jswakde.SWAKDEConfig(L=3, W=8, window=20, eh_eps=0.25)
    cfg_t = tswakde.SWAKDEConfig(L=3, W=8, window=20, eh_eps=0.25)
    codes = np.random.default_rng(3).integers(0, 8, size=(12, 3)).astype(np.int32)
    mask = np.arange(12) < 9
    pj = _prep_codes(jnp.asarray(codes), cfg_j, jnp.asarray(mask))
    pt = tswakde.swakde_prepare_from_codes(torch.from_numpy(codes), cfg_t,
                                           torch.from_numpy(mask))
    assert_state_equal(pt, pj)
    sj = _commit(jswakde.swakde_init(cfg_j), pj, cfg_j, count=9)
    st = tswakde.swakde_commit_chunk(tswakde.swakde_init(cfg_t, device="cpu"),
                                     pt, cfg_t, count=9)
    assert_state_equal(st, sj)
    # two more masked chunks on that state: 9 + 11 + 11 stamps through a
    # window of 20, so cells expire inside the third chunk
    for n_live in (11, 11):
        codes = np.random.default_rng(n_live + int(st.t)).integers(
            0, 8, size=(12, 3)).astype(np.int32)
        mask = np.arange(12) < n_live
        pj = _prep_codes(jnp.asarray(codes), cfg_j, jnp.asarray(mask))
        sj = _commit(sj, pj, cfg_j, count=n_live)
        st = tswakde.swakde_commit_chunk(
            st, tswakde.swakde_prepare_from_codes(torch.from_numpy(codes), cfg_t,
                                                  torch.from_numpy(mask)),
            cfg_t, count=n_live)
        assert_state_equal(st, sj)
    assert int(st.t) == 31


@pytest.fixture(scope="module")
def race_built():
    L, W = 8, 16
    params_j = ref_srp(3, DIM, L, 2, W)
    params_t = convert.params_from_numpy(fields(params_j), device="cpu")
    rng = np.random.default_rng(11)
    xs = rng.normal(size=(3, 40, DIM)).astype(np.float32)
    st_j, st_t = jrace.race_init(L, W), trace.race_init(L, W, device="cpu")
    for x, sign in zip(xs, (1, 1, -1)):
        st_j = _race_update(st_j, params_j, jnp.asarray(x), sign)
        st_t = trace.race_update_batch(st_t, params_t, torch.from_numpy(x), sign)
    return params_j, params_t, st_j, st_t


def test_race_counters_bit_exact_turnstile(race_built):
    _, _, st_j, st_t = race_built
    assert_state_equal(st_t, st_j)
    assert int(st_t.n) == 40
    back = convert.race_state_from_numpy(convert.to_numpy(st_t), device="cpu")
    assert_state_equal(back, st_t)


def test_race_merge_matches_reference(race_built):
    _, _, st_j, st_t = race_built
    assert_state_equal(trace.race_merge(st_t, st_t), jrace.race_merge(st_j, st_j))


@pytest.mark.parametrize("mom", [0, 2, 4])
def test_race_query_batch_matches_reference(race_built, mom):
    params_j, params_t, st_j, st_t = race_built
    qs = np.random.default_rng(12).normal(size=(9, DIM)).astype(np.float32)
    ref = np.asarray(_race_query(st_j, params_j, jnp.asarray(qs), mom))
    got = trace.race_query_batch(st_t, params_t, torch.from_numpy(qs), mom)
    np.testing.assert_array_equal(np_(got), ref)


def test_estimate_median_is_midpoint():
    """Even group counts take the mean of the two middle values, as
    jnp.median does (torch.median would take the lower one)."""
    vals = np.random.default_rng(13).integers(0, 50, size=(20, 12)).astype(np.float32)
    est_j = jax.jit(jrace.estimate_from_vals, static_argnums=(1,))
    for g in (2, 3, 4, 6):
        ref = np.asarray(est_j(jnp.asarray(vals), g))
        got = trace.estimate_from_vals(torch.from_numpy(vals), g).numpy()
        np.testing.assert_array_equal(got, ref)
