"""Each plain PyTorch version in repro_torch.kernels.ref against the
reference's oracle (repro.kernels.ref / repro.kernels.ops on the CPU), and
for srp_hash and cand_score against the reference's Pallas kernels in
interpret mode.

Integer outputs are bit-exact (srp_hash: away from a sign boundary of the
projection); batch_score_topk's and cand_score's d2 agree within
(1e-5, 1e-6), the fp32 summation order, and ids except at detected
near-ties.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cand_score as jcand_score
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import srp_hash as jsrp_hash
from repro.core import swakde as jswakde
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from torch_parity import assert_topk_match, np_

# Jitted once per process: eager calls would retrace the loops every pass.
_commit = jax.jit(jswakde.swakde_commit_chunk, static_argnums=(2,))
_prep_codes = jax.jit(jswakde.swakde_prepare_from_codes, static_argnums=(1,))
_seg_pass = jax.jit(jref.swakde_segment_pass_ref,
                    static_argnames=("window", "maxb", "n_levels", "cap"))


def test_srp_hash_matches_reference_pallas_interpret():
    """Codes of the plain version equal the Pallas kernel's (interpret
    mode) and the reference's oracle wherever no projection of the row
    lies within 1e-4 of the sign boundary (float64 product)."""
    rng = np.random.default_rng(5)
    B, d, L, k, nb = 40, 24, 6, 3, 97
    x = rng.normal(size=(B, d)).astype(np.float32)
    proj = rng.normal(size=(d, L * k)).astype(np.float32)
    mix = ((rng.integers(1, 2**31 - 1, size=(L, k)).astype(np.uint32) << 1)
           | np.uint32(1))
    mix[0, 0] = np.uint32(2**32 - 1)                     # fold wraps mod 2^32
    pallas = np.asarray(jsrp_hash.srp_hash(jnp.asarray(x), jnp.asarray(proj),
                                           jnp.asarray(mix), nb, block_b=16,
                                           interpret=True))
    oracle = np.asarray(jax.jit(jref.srp_hash_ref, static_argnums=(3,))(
        jnp.asarray(x), jnp.asarray(proj), jnp.asarray(mix), nb))
    got = tops.srp_hash(torch.from_numpy(x), torch.from_numpy(proj),
                        torch.from_numpy(mix.astype(np.int64)), nb)
    assert got.dtype == torch.int32 and got.shape == (B, L)
    y = x.astype(np.float64) @ proj.astype(np.float64)
    near = (np.abs(y) < 1e-4).reshape(B, L, k).any(-1)
    for want in (pallas, oracle):
        assert not ((got.numpy() != want) & ~near).any()
    assert (got.numpy() == pallas).mean() > 0.99


def test_srp_code_flips_explains_only_sign_boundary_flips():
    """The kernel's parity rule: a code that differs is explained only when
    one of its k projections lies within tol * |x| * |proj column| of 0."""
    rng = np.random.default_rng(9)
    B, d, L, k, nb = 30, 12, 5, 2, 1009
    x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
    proj = torch.from_numpy(rng.normal(size=(d, L * k)).astype(np.float32))
    x[:, 0] = 0.0
    proj[:, 0] = 0.0
    proj[0, 0] = 1.0                      # y = 0: hash row 0 on its boundary
    mix = torch.from_numpy(rng.integers(1, 2**31 - 1, size=(L, k)) * 2 + 1)
    want = tref.srp_hash_ref(x, proj, mix, nb)
    assert tref.srp_code_flips(x, proj, mix, want, want) == (0, 0)
    got = want.clone()
    got[:, 0] = (got[:, 0] + 1) % nb      # flips at the boundary
    assert tref.srp_code_flips(x, proj, mix, got, want) == (B, 0)
    got[3, 2] = (got[3, 2] + 1) % nb      # a flip away from any boundary
    assert tref.srp_code_flips(x, proj, mix, got, want) == (B + 1, 1)


def test_cand_score_matches_reference_pallas_interpret():
    rng = np.random.default_rng(6)
    M, d = 37, 20
    q = rng.normal(size=d).astype(np.float32)
    cands = rng.normal(size=(M, d)).astype(np.float32)
    cands[5] = q                                         # distance 0
    pallas = np.asarray(jcand_score.cand_score(jnp.asarray(q), jnp.asarray(cands),
                                               block_m=16, interpret=True))
    oracle = np.asarray(jref.cand_score_ref(jnp.asarray(q), jnp.asarray(cands)))
    got = tops.cand_score(torch.from_numpy(q), torch.from_numpy(cands))
    assert got.dtype == torch.float32 and got.shape == (M,)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert float(got[5]) == 0.0


def test_race_hist_matches_reference():
    rng = np.random.default_rng(0)
    W = 16
    codes = rng.integers(0, W, size=(300, 6)).astype(np.int32)
    codes[:100, 2] = 5                                   # one hot bucket
    ref = np.asarray(jops.race_hist(jnp.asarray(codes), W))
    got = tops.race_hist(torch.from_numpy(codes), W)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    counts = rng.integers(-5, 5, size=(6, W)).astype(np.int32)
    ref = np.asarray(jref.race_update_ref(jnp.asarray(counts), jnp.asarray(codes), -1))
    got = tref.race_update_ref(torch.from_numpy(counts), torch.from_numpy(codes), -1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sann_table_scatter_matches_reference():
    """Appends prepared by the reference's sort-by-(row, code) structure,
    with few distinct codes so buckets overflow the ring and wrap."""
    from repro.core import sann as jsann
    rng = np.random.default_rng(1)
    cfg = jsann.SANNConfig(dim=4, n_max=400, eta=0.3, r=1.0, c=1.5, L=3, k=2,
                           bucket_cap=4, capacity_slack=0.5).resolved()
    B = 96
    keep = rng.random(B) < 0.7
    codes = rng.integers(0, 6, size=(B, cfg.L)).astype(np.int32)
    prep = jax.jit(jsann.sann_prepare_given_keep, static_argnums=(3,))(
        None, jnp.zeros((B, 4)), jnp.asarray(keep), cfg, codes=jnp.asarray(codes))
    L, NB, cap = cfg.L, cfg.n_buckets, cfg.bucket_cap
    tables = rng.integers(-1, 64, size=(L, NB, cap)).astype(np.int32)
    ptr = rng.integers(0, 50, size=(L, NB)).astype(np.int32)
    val = rng.integers(-1, 64, size=prep.s_l.shape).astype(np.int32)
    args = [np.array(a) for a in (prep.s_l, prep.s_c, prep.rank)] + [val]
    mask = np.array(prep.entry_win)
    assert mask.sum() < len(mask)                        # some appends shadowed
    ref = np.asarray(jref.sann_table_scatter_ref(
        jnp.asarray(tables), jnp.asarray(ptr), *map(jnp.asarray, args),
        jnp.asarray(mask)))
    t_tables = torch.from_numpy(tables.copy())
    got = tops.sann_table_scatter(t_tables, torch.from_numpy(ptr),
                                  *map(torch.from_numpy, args),
                                  torch.from_numpy(mask))
    assert got is t_tables                               # in place
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("k", [1, 5])
def test_batch_score_topk_matches_reference(k):
    rng = np.random.default_rng(2)
    B, M, d = 7, 12, 5
    qs = rng.normal(size=(B, d)).astype(np.float32)
    cands = rng.normal(size=(B, M, d)).astype(np.float32)
    cands[:, 7] = cands[:, 3]                            # exact duplicate (tie)
    cands[:, 9] = cands[:, 3]
    cands[2, :, :] = cands[2, 0]                         # all candidates tie
    ok = rng.random((B, M)) < 0.8
    ok[:, 3] = ok[:, 7] = ok[:, 9] = True
    ok[4] = False                                        # fully masked row
    ok[5, :] = False
    ok[5, 1] = True                                      # fewer valid than k
    d2_r, idx_r = jops.batch_score_topk(jnp.asarray(qs), jnp.asarray(cands),
                                        jnp.asarray(ok), k)
    d2_p, idx_p = tops.batch_score_topk(torch.from_numpy(qs),
                                        torch.from_numpy(cands),
                                        torch.from_numpy(ok), k)
    assert d2_p.dtype == torch.float32 and idx_p.dtype == torch.int32
    exact = ((cands.astype(np.float64) - qs[:, None].astype(np.float64)) ** 2).sum(-1)
    exact = np.where(ok, exact, np.inf)
    assert_topk_match(d2_p, idx_p, np.asarray(d2_r), np.asarray(idx_r), exact)
    # ties go to the lowest index; a fully masked row gives inf, idx 0..k-1
    np.testing.assert_array_equal(np_(idx_p)[2], np.arange(k))
    assert np.isinf(np_(d2_p)[4]).all()
    np.testing.assert_array_equal(np_(idx_p)[4], np.arange(k))


def _segment_inputs(cap):
    """Pass inputs as `core.swakde.swakde_commit_chunk` builds them, on a
    reference state whose stamps already cross the window."""
    cfg = jswakde.SWAKDEConfig(L=4, W=16, window=40, eh_eps=0.2)
    rng = np.random.default_rng(3 + cap)
    st = jswakde.swakde_init(cfg)
    for _ in range(3):                                   # 96 > window stamps
        codes = rng.integers(0, 4, size=(32, cfg.L)).astype(np.int32)
        st = _commit(st, _prep_codes(jnp.asarray(codes), cfg), cfg)
    codes = rng.integers(0, 5, size=(32, cfg.L)).astype(np.int32)
    prep = _prep_codes(jnp.asarray(codes), cfg)
    rows = jnp.arange(cfg.L)[:, None]
    gcode = jnp.minimum(prep.seg_code, cfg.W - 1)
    sorted_ts = st.t + prep.order
    arrays = (st.ts[rows, gcode], st.num[rows, gcode],
              jnp.zeros_like(prep.seg_len), sorted_ts, prep.seg_first,
              prep.seg_len)
    eh = cfg.eh_config()
    kw = dict(window=cfg.window, maxb=eh.max_buckets_per_level,
              n_levels=eh.levels, cap=cap)
    return [np.array(a) for a in arrays], kw


@pytest.mark.parametrize("cap", [0, 1, 3])
def test_swakde_segment_pass_matches_reference(cap):
    """Every pass of the drain loop bit-exact, dead ring slots included."""
    (cts, cnum, done, sorted_ts, first, seg_len), kw = _segment_inputs(cap)
    j = tuple(map(jnp.asarray, (cts, cnum, done)))
    t = tuple(map(torch.from_numpy, (cts, cnum, done)))
    fixed_j = tuple(map(jnp.asarray, (sorted_ts, first, seg_len)))
    fixed_t = tuple(map(torch.from_numpy, (sorted_ts, first, seg_len)))
    passes = 0
    while (np.asarray(j[2]) < seg_len).any():
        j = _seg_pass(*j, *fixed_j, **kw)
        t = tops.swakde_segment_pass(*t, *fixed_t, **kw)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        passes += 1
    assert passes >= 2                                   # expiry or cap split
    np.testing.assert_array_equal(t[2].numpy(), seg_len)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    """Dispatch: a CPU tensor runs the plain version and counts no launch;
    the kernel wrapper itself refuses a CPU tensor instead of falling back."""
    from repro_torch.kernels import race_update
    tops.reset_launches()
    codes = torch.zeros((8, 2), dtype=torch.int32)
    tops.race_hist(codes, 4)
    assert all(n == 0 for n in tops.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        race_update.race_hist(codes, 4)


def test_kernel_build_needs_nvcc():
    import shutil
    from repro_torch.kernels import _build
    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("nvcc or a card is present; this checks the CPU-only box")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.lib()


@functools.lru_cache(maxsize=None)
def _commit_entries():
    """A prepared chunk (the reference's sort-by-(row, code) structure) with
    few codes, so buckets wrap, and a jitted reference tombstone pass."""
    from repro.core import sann as jsann
    rng = np.random.default_rng(2)
    cfg = jsann.SANNConfig(dim=4, n_max=400, eta=0.3, r=1.0, c=1.5, L=3, k=2,
                           bucket_cap=4, capacity_slack=0.5).resolved()
    B = 64
    keep = rng.random(B) < 0.7
    codes = rng.integers(0, 5, size=(B, cfg.L)).astype(np.int32)
    prep = jax.jit(jsann.sann_prepare_given_keep, static_argnums=(3,))(
        None, jnp.zeros((B, 4)), jnp.asarray(keep), cfg, codes=jnp.asarray(codes))
    entries = [np.array(a) for a in (prep.s_l, prep.s_c, prep.rank)]

    def tombstone(tables, write_ptr, n_kept, cap):
        # src/repro/core/sann.py sann_commit_chunk's pass, as it stands there
        ring_off = (jnp.arange(cap, dtype=jnp.int32) - write_ptr) % cap
        overwritten = ring_off < n_kept
        stale = (tables >= 0) & overwritten[jnp.maximum(tables, 0)]
        return jnp.where(stale, jnp.int32(-1), tables)

    return (cfg, entries, np.array(prep.entry_win),
            jax.jit(tombstone, static_argnums=(3,)))


@pytest.mark.parametrize("write_ptr,n_kept", [
    (3, 9),        # no wrap
    (17, 9),       # write_ptr + n_kept wraps past capacity
    (11, 0),       # nothing kept: only the appends
    (5, 20),       # n_kept = capacity: every slot recycled
    (5, 33),       # n_kept > capacity
])
def test_sann_table_commit_matches_reference(write_ptr, n_kept):
    """`sann_table_commit_ref` is the reference's tombstone pass then its
    `sann_table_scatter`, bit for bit: ids at or past capacity (the clamped
    gather) and loser entries (val = -1) included."""
    cfg, (s_l, s_c, rank), mask, tombstone = _commit_entries()
    C = 20
    rng = np.random.default_rng(write_ptr * 100 + n_kept)
    L, NB, cap = cfg.L, cfg.n_buckets, cfg.bucket_cap
    tables = rng.integers(-1, C + 4, size=(L, NB, cap)).astype(np.int32)
    ptr = rng.integers(0, 50, size=(L, NB)).astype(np.int32)
    val = rng.integers(-1, C, size=s_l.shape).astype(np.int32)
    val[::3] = -1                                        # losers
    want = np.asarray(jref.sann_table_scatter_ref(
        tombstone(jnp.asarray(tables), jnp.int32(write_ptr), jnp.int32(n_kept), C),
        *map(jnp.asarray, (ptr, s_l, s_c, rank, val, mask))))
    t_tables = torch.from_numpy(tables.copy())
    got = tops.sann_table_commit(
        t_tables, *map(torch.from_numpy, (ptr, s_l, s_c, rank, val, mask)),
        torch.tensor(write_ptr, dtype=torch.int32),
        torch.tensor(n_kept, dtype=torch.int32), C)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_tables.numpy(), tables)   # input untouched
    assert (tables >= C).any() and (got.numpy() == -1).sum() > (tables == -1).sum()
