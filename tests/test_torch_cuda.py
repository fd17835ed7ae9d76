"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip on a machine without a GPU (the CPU parity tests
in tests/test_torch_*.py cover the plain versions against the reference).
Run them on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes here are small and chosen for edge cases the main path does not
reach: a histogram wider than shared memory, k = 64, d not a multiple of
32, ties, fully masked rows, capped segment passes, unaligned rows, hash
rows split across blocks.  `cand_score` and `srp_hash` also run at their
main-path shapes.  `sketch_decode_attn` runs at the serve step's smoke
shapes and at one long shape (S = 131 072, gemma3-4b's heads), with an
empty live list, a ragged kv_len inside a block and more splits than live
tiles, and through its cp.async pipeline (bf16 K/V) at dh 64 to 512, G 1
to 8, live lists shorter than the ring and sketch blocks that are not a
multiple of its tile; it agrees with its plain version within 2e-5 (fp32
sums in another order, the reference kernel's own bound) and gives the
same bits twice.  `sann_table_commit` is bit-equal to its plain version
with the ring interval wrapping and with n_kept at or past capacity.  The
drained SW-AKDE commit is bit-equal to its plain pass loop (caps 0, 1, 3,
padding and masked-row segments) in one launch a chunk, also past 32 EH
slots (33, 52, 252) with the one-pass entry, and past the shared memory a
block may use (eps 1e-4, 5002 slots: the cell in global memory); `srp_hash`'s 3xTF32 signs at 0 follow
the flip rule.  `batch_score_topk_gather` matches the plain gather + top-k
with -1 ids, ties across the edges of its 512-candidate chunks, unaligned
rows, k = 1 and 64, and gives the `(B, M, d)` entry's bits; `race_hist`
stores every bin in one launch (one code a row, codes out of range, a
ragged batch, an empty batch, W wide enough for bin tiles).  The training
path: the flash attention `Function` against autograd through a dense
masked softmax, the drift monitor's one chunk a batch against the
per-example SW-AKDE updates, a train step that repeats bit for bit, and
one train step of each other family's smoke config equal to the CPU's.
LM training on a (data, model) mesh: a 2 x 2 mesh of one card repeated
equal to the same mesh on the CPU (dense and ``moe_ep``), the hybrid's
Mamba2 heads split over ``model`` equal to one device, and cards 0..3 equal
to one card repeated (deepseek-moe-16b, and deepseek-v3's MLA, MoE and MTP
head).  Decode on a mesh: `sketch_decode_attn`'s
partial entry (a rank's block of a sequence: the output and its
log-sum-exp) against its plain version, four blocks' partials merged equal
to the whole-cache kernel, the smoke decodes on a 2 x 2 mesh of one card
equal to the CPU mesh's, and cards 0..3 equal to one card repeated.
"""
import pytest
import torch

from repro_torch.kernels import (batch_score, cand_score, ingest_commit, ops,
                                 race_update, ref, sketch_decode_attn, srp_hash)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("B,L,W", [(1000, 7, 33), (4096, 96, 96),
                                   (300, 3, 20_000)])
def test_race_hist_kernel_matches_plain(dev, B, L, W):
    g = torch.Generator(device=dev).manual_seed(B)
    codes = torch.randint(0, W, (B, L), generator=g, device=dev, dtype=torch.int32)
    codes[: B // 3, 0] = 1
    got = race_update.race_hist(codes, W)
    torch.testing.assert_close(got, ref.race_hist_ref(codes, W), rtol=0, atol=0)


def test_sann_table_scatter_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    L, NB, cap = 4, 50, 4
    tables = torch.randint(-1, 99, (L, NB, cap), generator=g, device=dev,
                           dtype=torch.int32)
    ptr = torch.randint(0, 30, (L, NB), generator=g, device=dev, dtype=torch.int32)
    # one entry per (bucket, ring position): distinct targets, as entry_win makes
    s_l = torch.arange(L, device=dev).repeat_interleave(NB * cap).int()
    s_c = torch.arange(NB, device=dev).repeat_interleave(cap).repeat(L).int()
    rank = torch.arange(cap, device=dev).repeat(L * NB).int()
    val = torch.randint(-1, 99, s_l.shape, generator=g, device=dev, dtype=torch.int32)
    mask = torch.rand(s_l.shape, generator=g, device=dev) < 0.6
    got = ingest_commit.sann_table_scatter(tables.clone(), ptr, s_l, s_c, rank,
                                           val, mask)
    want = ref.sann_table_scatter_ref(tables.clone(), ptr, s_l, s_c, rank, val, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(3, 50, 3), (4, 70_000, 8)])
@pytest.mark.parametrize("write_ptr,n_kept", [(3, 9), (17, 9), (11, 0),
                                              (5, 20), (5, 33)])
def test_sann_table_commit_kernel_matches_plain(dev, shape, write_ptr, n_kept):
    """Capacity 20; slot ids from -1 to past capacity (the clamped read);
    one entry per (bucket, ring position), -1 for a third (losers).  The
    first shape leaves a tail of n % 4 ids, the second spans many
    grid-stride steps."""
    L, NB, cap = shape
    C = 20
    g = torch.Generator(device=dev).manual_seed(write_ptr * 100 + n_kept)
    tables = torch.randint(-1, C + 4, (L, NB, cap), generator=g, device=dev,
                           dtype=torch.int32)
    ptr = torch.randint(0, 30, (L, NB), generator=g, device=dev, dtype=torch.int32)
    s_l = torch.arange(L, device=dev).repeat_interleave(NB * cap).int()
    s_c = torch.arange(NB, device=dev).repeat_interleave(cap).repeat(L).int()
    rank = torch.arange(cap, device=dev).repeat(L * NB).int()
    val = torch.randint(-1, C, s_l.shape, generator=g, device=dev, dtype=torch.int32)
    val[::3] = -1
    mask = torch.rand(s_l.shape, generator=g, device=dev) < 0.6
    wp = torch.tensor(write_ptr, dtype=torch.int32, device=dev)
    nk = torch.tensor(n_kept, dtype=torch.int32, device=dev)
    before = tables.clone()
    ops.reset_launches()
    got = ops.sann_table_commit(tables, ptr, s_l, s_c, rank, val, mask, wp, nk, C)
    assert ops.LAUNCHES["sann_table_scatter"] == 1
    want = ref.sann_table_commit_ref(tables, ptr, s_l, s_c, rank, val, mask,
                                     wp, nk, C)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(tables, before)


@pytest.mark.parametrize("cap", [4, 3])
@pytest.mark.parametrize("T", [1, 8, 256])
def test_sann_table_commit_tenant_axis_kernel_matches_plain(dev, T, cap):
    """A stacked fleet's commit: ``(T * 3, 50, cap)`` tables with per-tenant
    ``write_ptr`` / ``n_kept`` (some tenants wrapping their ring), one
    launch whatever T is.  cap 4 takes the 16-byte vector pass (a tenant
    spans whole vectors), cap 3 the scalar pass."""
    L, NB, C = 3, 50, 20
    g = torch.Generator(device=dev).manual_seed(T * 10 + cap)
    tables = torch.randint(-1, C + 4, (T * L, NB, cap), generator=g,
                           device=dev, dtype=torch.int32)
    ptr = torch.randint(0, 30, (T * L, NB), generator=g, device=dev,
                        dtype=torch.int32)
    s_l = torch.arange(T * L, device=dev).repeat_interleave(NB * cap).int()
    s_c = torch.arange(NB, device=dev).repeat_interleave(cap).repeat(T * L).int()
    rank = torch.arange(cap, device=dev).repeat(T * L * NB).int()
    val = torch.randint(-1, C, s_l.shape, generator=g, device=dev,
                        dtype=torch.int32)
    mask = torch.rand(s_l.shape, generator=g, device=dev) < 0.6
    wp = torch.randint(0, C, (T,), generator=g, device=dev, dtype=torch.int32)
    nk = torch.randint(0, C + 3, (T,), generator=g, device=dev,
                       dtype=torch.int32)
    before = tables.clone()
    ops.reset_launches()
    got = ops.sann_table_commit(tables, ptr, s_l, s_c, rank, val, mask, wp, nk,
                                C, rows_per_tenant=L)
    assert ops.LAUNCHES["sann_table_scatter"] == 1
    want = ref.sann_table_commit_ref(tables, ptr, s_l, s_c, rank, val, mask,
                                     wp, nk, C, rows_per_tenant=L)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(tables, before)


def _assert_topk_equal_or_near_tie(d_k, i_k, d_r, i_r, full):
    torch.testing.assert_close(d_k, d_r, rtol=1e-5, atol=1e-6)
    a = torch.gather(full, 1, i_k.long())
    b = torch.gather(full, 1, i_r.long())
    tie = (a == b) | ((a - b).abs() <= 1e-6 + 1e-5 * b.abs())
    assert bool(((i_k == i_r) | tie).all())


@pytest.mark.parametrize("B,M,d,k", [(37, 10, 5, 1), (37, 10, 5, 10),
                                     (64, 200, 45, 64), (9, 33, 128, 33),
                                     (5, 2100, 20, 64), (6, 2100, 16, 1)])
def test_batch_score_topk_kernel_matches_plain(dev, B, M, d, k):
    g = torch.Generator(device=dev).manual_seed(M)
    qs = torch.randn((B, d), generator=g, device=dev)
    cands = torch.randn((B, M, d), generator=g, device=dev)
    cands[:, M // 2] = cands[:, 0]                      # exact ties
    ok = torch.rand((B, M), generator=g, device=dev) < 0.7
    ok[:, 0] = ok[:, M // 2] = True
    ok[3] = False                                       # fully masked row
    d_k, i_k = batch_score.batch_score_topk(qs, cands, ok, k)
    d_r, i_r = ref.batch_score_topk_ref(qs, cands, ok, k)
    full = torch.where(ok, ref.batch_score_ref(qs, cands), float("inf"))
    _assert_topk_equal_or_near_tie(d_k, i_k, d_r, i_r, full)
    assert torch.equal(i_k[3], torch.arange(k, device=dev, dtype=torch.int32))


@pytest.mark.parametrize("B,N,M,d,k", [
    (37, 500, 10, 5, 1), (37, 500, 10, 5, 10),   # d % 4 != 0: scalar loads
    (64, 3000, 200, 45, 64),                     # M not a multiple of the tile
    (9, 400, 33, 128, 33),
    (256, 63_395, 384, 128, 50),                 # the top-50 query shape
    (256, 63_395, 36, 128, 1),                   # the (c, r) query shape
    (6, 1000, 3000, 16, 64),                     # six 512-candidate chunks
    (5, 1000, 5000, 12, 7),                      # ten chunks
    (4, 300, 4100, 8, 1),                        # k = 1 over a long row
])
def test_batch_score_topk_gather_kernel_matches_plain(dev, B, N, M, d, k):
    """Slot ids with -1s, the same point named at several positions (exact
    ties, also on both sides of a chunk edge), a fully masked row, and an
    unaligned point store (the scalar path): equal to the plain gather +
    top-k within the scorer's tolerance, ids equal away from near-ties, one
    launch a call."""
    g = torch.Generator(device=dev).manual_seed(N + M + k)
    qs = torch.randn((B, d), generator=g, device=dev)
    points = torch.randn((N, d), generator=g, device=dev)
    cand = torch.randint(-1, N, (B, M), generator=g, device=dev,
                         dtype=torch.int32)
    cand[:, 0] = cand[:, 0].clamp(min=0)
    edge = 512                                        # the first chunk's end
    for m in (M // 2, edge - 1, edge, M - 1):
        if 0 < m < M:
            cand[:, m] = cand[:, 0]                   # ties, across chunks too
    ok = (torch.rand((B, M), generator=g, device=dev) < 0.7) & (cand >= 0)
    ok[:, 0] = True
    ok[1] = False                                     # fully masked row
    buf = torch.empty(N * d + 1, device=dev)
    unaligned = buf[1:].view(N, d)
    unaligned.copy_(points)
    for pts in (points, unaligned):
        ops.reset_launches()
        d_k, i_k = ops.batch_score_topk_gather(qs, pts, cand, ok, k)
        assert ops.LAUNCHES["batch_score_topk"] == 1
        d_r, i_r = ref.batch_score_topk_gather_ref(qs, pts, cand, ok, k)
        full = torch.where(ok, ref.batch_score_ref(
            qs, pts[cand.clamp(min=0).long()]), float("inf"))
        _assert_topk_equal_or_near_tie(d_k, i_k, d_r, i_r, full)
        assert torch.isinf(d_k[1]).all()
        assert torch.equal(i_k[1], torch.arange(k, device=dev, dtype=torch.int32))
    # the (B, M, d) entry on the same kernel body gives the same bits
    d_o, i_o = batch_score.batch_score_topk(
        qs, points[cand.clamp(min=0).long()], ok, k)
    d_g, i_g = batch_score.batch_score_topk_gather(qs, points, cand, ok, k)
    assert torch.equal(d_o, d_g) and torch.equal(i_o, i_g)


def test_batch_score_topk_gather_refuses_bad_arguments(dev):
    qs, points = torch.zeros((4, 8), device=dev), torch.zeros((10, 8), device=dev)
    cand = torch.zeros((4, 6), dtype=torch.int32, device=dev)
    ok = torch.ones((4, 6), dtype=torch.bool, device=dev)
    for bad in (dict(cand=cand.long()), dict(points=points[:, :4]),
                dict(ok=ok.int()), dict(k=7), dict(k=0), dict(qs=qs.cpu())):
        args = dict(qs=qs, points=points, cand=cand, ok=ok, k=3) | bad
        with pytest.raises(ValueError):
            batch_score.batch_score_topk_gather(**args)


@pytest.mark.parametrize("case", ["one_code_per_row", "out_of_range",
                                  "ragged_batch", "empty_batch", "wide",
                                  "wide_tiles"])
def test_race_hist_kernel_edge_cases_one_launch(dev, case):
    """Every bin is stored (the output is allocated uninitialised, so the
    allocator's stale -7s must all be overwritten), in one launch a call."""
    B, L, W = {"one_code_per_row": (4096, 96, 96), "out_of_range": (4096, 96, 96),
               "ragged_batch": (1001, 13, 40), "empty_batch": (0, 5, 7),
               "wide": (3000, 3, 20_000), "wide_tiles": (700, 2, 30_000)}[case]
    g = torch.Generator(device=dev).manual_seed(B + W)
    codes = torch.randint(0, W, (B, L), generator=g, device=dev, dtype=torch.int32)
    if case == "one_code_per_row":
        codes[:] = torch.arange(L, device=dev, dtype=torch.int32) % W
    if case == "out_of_range":
        codes[::3] = -1 - codes[::3]
        codes[1::5] += W
    if case == "wide_tiles":
        codes[:, 0] = W - 1
    stale = torch.full((L, W), -7, dtype=torch.int32, device=dev)
    del stale
    ops.reset_launches()
    got = ops.race_hist(codes, W)
    assert ops.LAUNCHES["race_hist"] == 1
    torch.testing.assert_close(got, ref.race_hist_ref(codes, W), rtol=0, atol=0)


def _swakde_stream(dev, eps, cap, seed, n_chunks=5, chunk=256, window=600):
    """A small SW-AKDE stream with one very heavy cell a row, so levels hold
    more than 32 buckets at ``eps``, through a window that expires inside
    chunks; yields (state, prep, cfg) before each commit."""
    from repro_torch.core import swakde
    cfg = swakde.SWAKDEConfig(L=3, W=8, window=window, eh_eps=eps,
                              heavy_cell_cap=cap)
    g = torch.Generator(device=dev).manual_seed(seed)
    state = swakde.swakde_init(cfg, dev)
    for i in range(n_chunks):
        codes = torch.randint(0, 4, (chunk, cfg.L), generator=g, device=dev,
                              dtype=torch.int32)
        codes[: chunk * 3 // 4, 0] = 2                 # a heavy cell
        codes[::2, 1] = 5
        mask = torch.arange(chunk, device=dev) < (chunk - 9 if i == 2 else chunk)
        prep = swakde.swakde_prepare_from_codes(codes, cfg, mask)
        yield state, prep, cfg, int(mask.sum())
        state = swakde.swakde_commit_chunk(state, prep, cfg, count=int(mask.sum()))


@pytest.mark.parametrize("eps,slots", [(0.0163, 33), (0.01, 52), (0.002, 252)])
def test_swakde_entries_at_many_slots_match_plain(dev, eps, slots):
    """Both SW-AKDE entries past 32 EH slots (the shared-memory form): the
    one-pass entry bit-exact at every pass of the plain loop, the drained
    commit bit-exact against the plain pass loop in one launch."""
    from repro_torch.core.util import saturating_add
    for j, (state, prep, cfg, n_live) in enumerate(
            _swakde_stream(dev, eps, 0, seed=slots)):
        eh = cfg.eh_config()
        assert eh.slots == slots
        kw = dict(window=cfg.window, maxb=eh.max_buckets_per_level,
                  n_levels=eh.levels, cap=0)
        rows = torch.arange(cfg.L, device=dev)[:, None]
        gcode = prep.seg_code.clamp(max=cfg.W - 1).long()
        sorted_ts = saturating_add(state.t, prep.order)
        carry = (state.ts[rows, gcode].contiguous(),
                 state.num[rows, gcode].contiguous(),
                 torch.zeros_like(prep.seg_len))
        fixed = (sorted_ts, prep.seg_first, prep.seg_len)
        while bool((carry[2] < prep.seg_len).any()):
            got = ingest_commit.swakde_segment_pass(*carry, *fixed, **kw)
            want = ref.swakde_segment_pass_ref(*carry, *fixed, **kw)
            for x, y in zip(got, want):
                torch.testing.assert_close(x, y, rtol=0, atol=0)
            carry = got
        args = (state.ts, state.num, sorted_ts, prep.seg_code, prep.seg_first,
                prep.seg_len)
        ops.reset_launches()
        got = ops.swakde_segment_commit(*args, **kw)
        assert ops.LAUNCHES["swakde_segment_pass"] == 1
        want = ref.swakde_segment_commit_ref(*args, **kw)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        if j == 4:   # the levels really fill past 32 buckets where they can
            assert int(got[1].max()) >= min(slots - 1, 48)


def test_swakde_cell_past_shared_memory_runs_in_global_memory(dev):
    """eps = 1e-4 at window 65 536: 18 levels x 5002 slots, a 422 160-byte
    cell for one warp, over the 232 448 bytes a block may use, so both
    entries keep it in a global scratch slice.  On a small grid (L = 3,
    W = 8) through five chunks of 16 384, the last of which expires inside
    the window: the one-pass entry bit-exact at every pass of the plain
    loop, the drained commit bit-exact against the plain pass loop in one
    launch a chunk."""
    from repro_torch.core.util import saturating_add
    for j, (state, prep, cfg, n_live) in enumerate(_swakde_stream(
            dev, 1e-4, 0, seed=5002, chunk=16_384, window=65_536)):
        eh = cfg.eh_config()
        assert (eh.levels, eh.slots) == (18, 5002)
        assert ingest_commit.swakde_cell_bytes(eh.levels, eh.slots) > \
            ingest_commit.SMEM_LIMIT
        assert ingest_commit.swakde_cell_form(eh.levels, eh.slots) == "global"
        kw = dict(window=cfg.window, maxb=eh.max_buckets_per_level,
                  n_levels=eh.levels, cap=0)
        rows = torch.arange(cfg.L, device=dev)[:, None]
        gcode = prep.seg_code.clamp(max=cfg.W - 1).long()
        sorted_ts = saturating_add(state.t, prep.order)
        carry = (state.ts[rows, gcode].contiguous(),
                 state.num[rows, gcode].contiguous(),
                 torch.zeros_like(prep.seg_len))
        fixed = (sorted_ts, prep.seg_first, prep.seg_len)
        passes = 0
        while bool((carry[2] < prep.seg_len).any()):
            got = ingest_commit.swakde_segment_pass(*carry, *fixed, **kw)
            want = ref.swakde_segment_pass_ref(*carry, *fixed, **kw)
            for x, y in zip(got, want):
                torch.testing.assert_close(x, y, rtol=0, atol=0)
            carry = got
            passes += 1
        args = (state.ts, state.num, sorted_ts, prep.seg_code, prep.seg_first,
                prep.seg_len)
        ops.reset_launches()
        got = ops.swakde_segment_commit(*args, **kw)
        assert ops.LAUNCHES["swakde_segment_pass"] == 1
        want = ref.swakde_segment_commit_ref(*args, **kw)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        if j == 4:   # stamps expire inside the last chunk: several passes,
            assert passes > 1                      # and levels hold > 227 KB
            assert int(got[1].max()) > 2000


@pytest.mark.parametrize("cap", [0, 1, 3])
def test_swakde_segment_pass_kernel_matches_plain(dev, cap):
    """A small SW-AKDE stream whose window expires inside chunks: every pass
    of every chunk's drain loop bit-exact."""
    from repro_torch.core import swakde
    from repro_torch.core.util import saturating_add
    cfg = swakde.SWAKDEConfig(L=5, W=16, window=40, eh_eps=0.2,
                              heavy_cell_cap=cap)
    eh = cfg.eh_config()
    kw = dict(window=cfg.window, maxb=eh.max_buckets_per_level,
              n_levels=eh.levels, cap=cap)
    g = torch.Generator(device=dev).manual_seed(cap)
    state = swakde.swakde_init(cfg, dev)
    rows = torch.arange(cfg.L, device=dev)[:, None]
    for _ in range(5):
        codes = torch.randint(0, 5, (64, cfg.L), generator=g, device=dev,
                              dtype=torch.int32)
        prep = swakde.swakde_prepare_from_codes(codes, cfg)
        gcode = prep.seg_code.clamp(max=cfg.W - 1).long()
        carry = (state.ts[rows, gcode].contiguous(),
                 state.num[rows, gcode].contiguous(),
                 torch.zeros_like(prep.seg_len))
        fixed = (saturating_add(state.t, prep.order), prep.seg_first, prep.seg_len)
        while bool((carry[2] < prep.seg_len).any()):
            got = ingest_commit.swakde_segment_pass(*carry, *fixed, **kw)
            want = ref.swakde_segment_pass_ref(*carry, *fixed, **kw)
            for x, y in zip(got, want):
                torch.testing.assert_close(x, y, rtol=0, atol=0)
            carry = got
        state = swakde.swakde_commit_chunk(state, prep, cfg)


@pytest.mark.parametrize("cap", [0, 1, 3])
def test_swakde_segment_commit_kernel_matches_plain(dev, cap):
    """The drained commit (one launch a chunk, no host sync) against its
    plain pass loop on a stream whose window expires inside chunks, with
    padding segments and, in one chunk, a masked-row segment; the state
    passed in is not modified."""
    from repro_torch.core import swakde
    from repro_torch.core.util import saturating_add
    cfg = swakde.SWAKDEConfig(L=5, W=16, window=40, eh_eps=0.2,
                              heavy_cell_cap=cap)
    eh = cfg.eh_config()
    kw = dict(window=cfg.window, maxb=eh.max_buckets_per_level,
              n_levels=eh.levels, cap=cap)
    g = torch.Generator(device=dev).manual_seed(10 + cap)
    state = swakde.swakde_init(cfg, dev)
    for n_live in (64, 64, 50, 64, 64):
        codes = torch.randint(0, 5, (64, cfg.L), generator=g, device=dev,
                              dtype=torch.int32)
        codes[:40, 1] = 2                                # a heavy cell
        mask = torch.arange(64, device=dev) < n_live
        prep = swakde.swakde_prepare_from_codes(codes, cfg, mask)
        before = (state.ts.clone(), state.num.clone())
        args = (state.ts, state.num, saturating_add(state.t, prep.order),
                prep.seg_code, prep.seg_first, prep.seg_len)
        want = ref.swakde_segment_commit_ref(*args, **kw)
        got = ingest_commit.swakde_segment_commit(*args, **kw)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        ops.reset_launches()
        state = swakde.swakde_commit_chunk(state, prep, cfg, count=n_live)
        assert ops.LAUNCHES["swakde_segment_pass"] == 1
        assert torch.equal(state.ts, want[0]) and torch.equal(state.num, want[1])
        assert torch.equal(args[0], before[0]) and torch.equal(args[1], before[1])


def test_wrappers_count_launches_and_check_arguments(dev):
    ops.reset_launches()
    codes = torch.zeros((8, 2), dtype=torch.int32, device=dev)
    ops.race_hist(codes, 4)
    ops.race_hist(codes.cpu(), 4)                        # plain version: no count
    assert ops.LAUNCHES["race_hist"] == 1
    with pytest.raises(ValueError):
        race_update.race_hist(codes.long(), 4)
    with pytest.raises(ValueError):
        race_update.race_hist(codes.t(), 4)


@pytest.mark.parametrize("M,d", [(36, 128), (384, 128), (1, 5), (70, 33)])
def test_cand_score_kernel_matches_plain(dev, M, d):
    g = torch.Generator(device=dev).manual_seed(M + d)
    q = torch.randn((d,), generator=g, device=dev)
    cands = torch.randn((M, d), generator=g, device=dev)
    cands[0] = q                                        # distance 0
    got = cand_score.cand_score(q, cands)
    torch.testing.assert_close(got, ref.cand_score_ref(q, cands),
                               rtol=1e-5, atol=1e-6)
    assert float(got[0]) == 0.0
    # a row slice at an odd offset takes the scalar path
    buf = torch.randn((M * d + 1,), generator=g, device=dev)
    odd = buf[1:].view(M, d)
    torch.testing.assert_close(cand_score.cand_score(q, odd),
                               ref.cand_score_ref(q, odd), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,d,L,k,nb", [(4096, 384, 96, 2, 96), (1, 384, 96, 2, 96),
                                        (77, 50, 13, 5, 1009), (130, 20, 3, 64, 7)])
def test_srp_hash_kernel_matches_plain(dev, B, d, L, k, nb):
    g = torch.Generator(device=dev).manual_seed(B + L)
    x = torch.randn((B, d), generator=g, device=dev)
    proj = torch.randn((d, L * k), generator=g, device=dev)
    mix = torch.randint(1, 2**31 - 1, (L, k), generator=g, device=dev,
                        dtype=torch.int64) * 2 + 1
    mix[0, 0] = 2**32 - 1
    got = srp_hash.srp_hash(x, proj, mix, nb)
    want = ref.srp_hash_ref(x, proj, mix, nb)
    assert got.dtype == torch.int32 and got.shape == (B, L)
    assert bool(((got >= 0) & (got < nb)).all())
    flips, unexplained = ref.srp_code_flips(x, proj, mix, got, want)
    assert unexplained == 0, "srp_hash code differs away from a sign boundary"
    assert flips <= max(1, B * L // 1000)


def test_srp_hash_kernel_signs_at_zero(dev):
    """Rows of x orthogonal to some projection columns (y exactly 0 in
    exact arithmetic) and rows within 1e-7 of that: the 3xTF32 sign near 0
    may differ from the plain version's only under the flip rule."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, d, L, k, nb = 300, 384, 96, 2, 96
    proj = torch.randn((d, L * k), generator=g, device=dev)
    mix = torch.randint(1, 2**31 - 1, (L, k), generator=g, device=dev,
                        dtype=torch.int64) * 2 + 1
    x = torch.randn((B, d), generator=g, device=dev)
    # project the first 200 rows off columns 0..7 (in float64), then nudge
    # half of them by 1e-7 of |x| along column 0
    cols = proj[:, :8].double()
    q, _ = torch.linalg.qr(cols)
    xd = x[:200].double()
    xd = xd - (xd @ q) @ q.T
    xd[100:] += 1e-7 * xd[100:].norm(dim=1, keepdim=True) * \
        (cols[:, 0] / cols[:, 0].norm())
    x[:200] = xd.float()
    got = srp_hash.srp_hash(x, proj, mix, nb)
    want = ref.srp_hash_ref(x, proj, mix, nb)
    assert bool(((got >= 0) & (got < nb)).all())
    y = x[:200].double() @ proj[:, :8].double()
    assert float(y.abs().max()) <= 1e-5 * float(x[:200].norm(dim=1).max()) * \
        float(proj[:, :8].norm(dim=0).max())
    flips, unexplained = ref.srp_code_flips(x, proj, mix, got, want)
    assert unexplained == 0, "srp_hash code differs away from a sign boundary"


def test_new_wrappers_count_launches_and_refuse_bad_arguments(dev):
    ops.reset_launches()
    q, cands = torch.zeros(8, device=dev), torch.zeros((3, 8), device=dev)
    ops.cand_score(q, cands)
    ops.cand_score(q.cpu(), cands.cpu())                 # plain version: no count
    x, proj = torch.zeros((4, 8), device=dev), torch.zeros((8, 6), device=dev)
    mix = torch.ones((3, 2), dtype=torch.int64, device=dev)
    ops.srp_hash(x, proj, mix, 5)
    ops.srp_hash(x.cpu(), proj.cpu(), mix.cpu(), 5)
    assert ops.LAUNCHES["cand_score"] == 1 and ops.LAUNCHES["srp_hash"] == 1
    with pytest.raises(ValueError):
        cand_score.cand_score(q.double(), cands.double())
    with pytest.raises(ValueError):
        srp_hash.srp_hash(x, proj, mix.int(), 5)
    with pytest.raises(ValueError):
        srp_hash.srp_hash(x.half(), proj, mix, 5)
    with pytest.raises(ValueError):
        srp_hash.srp_hash(x, proj.t().contiguous().t(), mix, 5)


@pytest.mark.parametrize("w", [9.612, 3.0, 1.6])
def test_pstable_scalar_reciprocal_is_one_fp32_multiply_on_the_card(dev, w):
    """`lsh.fp32_reciprocal` is a Python float; times a CUDA float32 tensor
    it must give the CPU's bits (one fp32 multiply by float32(1)/float32(w))."""
    from repro_torch.core import lsh
    g = torch.Generator(device=dev).manual_seed(int(w * 10))
    y = torch.randn((1 << 20,), generator=g, device=dev) * 50
    r = lsh.fp32_reciprocal(w)
    one = torch.tensor(1.0, dtype=torch.float32)
    assert torch.equal((y * r).cpu(),
                       y.cpu() * (one / torch.tensor(w, dtype=torch.float32)))


def test_keep_draws_are_bit_identical_on_the_card(dev):
    from repro_torch.core import prng, sann
    key = prng.fold_in(prng.PRNGKey(7, device="cpu"), 3)
    for n in (1, 4096):
        keys = sann.sann_row_keys(key.to(dev), n)
        assert torch.equal(keys.cpu(), sann.sann_row_keys(key, n))
        assert torch.equal(prng.bernoulli(keys, 0.3).cpu(),
                           prng.bernoulli(keys.cpu(), 0.3))


def _sda_case(dev, B, Hkv, G, dh, S, bs, frac, dtype, seed):
    """Random q, k, v and live blocks: each block live with probability
    ``frac`` (a float), or exactly ``frac`` blocks a request (an int)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Hkv, G, dh), generator=g, device=dev)
    k = torch.randn((B, S, Hkv, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, dh), generator=g, device=dev).to(dtype)
    u = torch.rand((B, S // bs), generator=g, device=dev)
    if isinstance(frac, int):
        live = u.argsort(1).argsort(1) < frac
    else:
        live = u < frac
    ids, n_live = sketch_decode_attn.compact_live(live)
    return q, k, v, live, ids, n_live


@pytest.mark.parametrize("B,Hkv,G,dh,S,bs,frac,kv_len,softcap,dtype", [
    (2, 2, 2, 16, 1024, 512, 1.0, 604, 0.0, torch.float32),      # gemma3 smoke
    (2, 2, 2, 16, 1024, 512, 0.5, 604, 50.0, torch.float32),     # gemma2 smoke
    (3, 2, 4, 64, 1024, 128, 0.5, 900, 20.0, torch.float32),
    (1, 1, 8, 32, 512, 64, 1.0, 100, 0.0, torch.float32),
    (4, 4, 2, 256, 4096, 512, 0.6, 1000, 0.0, torch.bfloat16),    # lm_serve
    (1, 4, 2, 256, 131_072, 512, 0.5, 131_000, 50.0, torch.bfloat16),
    # the cp.async pipeline (bf16 K/V, dh 64/128/256/512):
    (2, 2, 2, 256, 2048, 32, 1, 2048, 0.0, torch.bfloat16),   # 1 tile < ring
    (2, 2, 2, 256, 2048, 64, 1, 2000, 0.0, torch.bfloat16),   # 2 tiles < ring
    (2, 4, 2, 256, 4096, 512, 0.6, 1013, 0.0, torch.bfloat16),  # kv_len in a tile
    (2, 2, 2, 128, 960, 48, 0.7, 900, 0.0, torch.bfloat16),   # block % tile != 0
    (2, 4, 1, 256, 2048, 512, 0.8, 2000, 0.0, torch.bfloat16),  # G = 1
    (1, 2, 8, 256, 2048, 256, 0.7, 2048, 30.0, torch.bfloat16),  # G = 8
    (2, 2, 2, 64, 1024, 64, 0.7, 1000, 0.0, torch.bfloat16),
    (2, 2, 4, 128, 1024, 128, 0.7, 777, 20.0, torch.bfloat16),
    (1, 2, 2, 512, 2048, 512, 1.0, 2040, 0.0, torch.bfloat16),
    (1, 1, 8, 512, 1024, 256, 1.0, 1000, 0.0, torch.bfloat16),  # largest dh, G
    (2, 2, 2, 96, 1024, 64, 0.7, 1000, 0.0, torch.bfloat16),  # simple path
    (1, 2, 2, 256, 1024, 512, 1.0, 1000, 0.0, torch.float32),  # fp32 K/V
])
def test_sketch_decode_attn_kernel_matches_plain(dev, B, Hkv, G, dh, S, bs, frac,
                                                 kv_len, softcap, dtype):
    q, k, v, live, ids, n_live = _sda_case(dev, B, Hkv, G, dh, S, bs, frac,
                                           dtype, S + G)
    got = sketch_decode_attn.sketch_decode_attn(q, k, v, ids, n_live, kv_len,
                                                bs, softcap)
    want = ref.sketch_decode_attn_ref(q, k, v, live, kv_len, bs, softcap)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    # splits combine in a fixed order: a second call gives the same bits
    assert torch.equal(got, sketch_decode_attn.sketch_decode_attn(
        q, k, v, ids, n_live, kv_len, bs, softcap))
    # the reference's unbatched form, request by request, in bf16 q as well
    for b in range(min(B, 2)):
        one = sketch_decode_attn.sketch_decode_attn(
            q[b].to(dtype), k[b], v[b], ids[b], n_live[b:b + 1],
            torch.tensor([kv_len], device=dev), bs, softcap)
        plain = ref.sketch_decode_attn_ref(q[b].to(dtype), k[b], v[b], live[b],
                                           kv_len, bs, softcap)
        torch.testing.assert_close(one, plain, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,Hkv,G,dh,S,bs,frac,kv_len,dtype", [
    (1, 4, 2, 256, 32_768, 512, 0.5, 32_700, torch.bfloat16),  # lm_long block
    (4, 4, 2, 256, 1024, 512, 0.6, 1000, torch.bfloat16),      # lm_serve block
    (2, 2, 1, 64, 1024, 64, 0.7, 1000, torch.bfloat16),
    (2, 2, 4, 128, 1024, 128, 0.7, 777, torch.bfloat16),       # ragged kv_len
    (1, 2, 8, 256, 2048, 256, 0.7, 2048, torch.bfloat16),
    (2, 2, 2, 64, 1024, 64, 0.0, 1000, torch.bfloat16),        # nothing live
    (3, 2, 4, 64, 1024, 128, 0.5, 900, torch.float32),
    (2, 2, 2, 128, 1024, 512, 1.0, 1000, torch.float32),
    (1, 2, 2, 256, 1024, 512, 1.0, 0, torch.float32),           # nothing written
])
def test_sketch_decode_attn_partial_matches_plain(dev, B, Hkv, G, dh, S, bs,
                                                  frac, kv_len, dtype):
    """The partial entry (a rank's block of a sequence): the normalised
    output and its log-sum-exp against the plain version within 2e-5 (-inf
    and zeros where nothing is live), one launch a call, the same bits
    twice."""
    q, k, v, live, ids, n_live = _sda_case(dev, B, Hkv, G, dh, S, bs, frac,
                                           dtype, S + G + 1)
    before = ops.LAUNCHES["sketch_decode_attn"]
    o, lse = sketch_decode_attn.sketch_decode_attn_partial(
        q, k, v, ids, n_live, kv_len, bs)
    assert ops.LAUNCHES["sketch_decode_attn"] == before + 1
    wo, wl = ref.sketch_decode_attn_partial_ref(q, k, v, live, kv_len, bs)
    assert lse.shape == (B, Hkv, G) and lse.dtype == torch.float32
    fin = torch.isfinite(wl)
    assert torch.equal(torch.isfinite(lse), fin)
    assert torch.isneginf(lse[~fin]).all() and not o[~fin].any()
    torch.testing.assert_close(o, wo, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse[fin], wl[fin], rtol=2e-5, atol=2e-5)
    o2, l2 = sketch_decode_attn.sketch_decode_attn_partial(
        q, k, v, ids, n_live, kv_len, bs)
    assert torch.equal(o, o2) and torch.equal(lse, l2)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_sketch_decode_attn_partials_merge_to_the_whole_kernel(dev, softcap):
    """Four blocks of a 16 384-token sequence (gemma3-4b's heads, bf16),
    one partial launch each, one of them with nothing live, merged in rank
    order (`sharding.merge_partials`) equal to the whole-cache kernel
    within 2e-5."""
    from repro_torch.parallel import sharding
    B, Hkv, G, dh, S, bs, kv_len = 2, 4, 2, 256, 16_384, 512, 15_000
    q, k, v, live, ids, n_live = _sda_case(dev, B, Hkv, G, dh, S, bs, 0.5,
                                           torch.bfloat16, 3)
    live[:, 8:16] = False                      # block 1 of 4: nothing live
    live[:, (kv_len - 1) // bs] = True
    ids, n_live = sketch_decode_attn.compact_live(live)
    whole = sketch_decode_attn.sketch_decode_attn(q, k, v, ids, n_live, kv_len,
                                                  bs, softcap)
    size, parts = S // 4, []
    before = ops.LAUNCHES["sketch_decode_attn"]
    for r in range(4):
        s0 = r * size
        ids_r, n_r = sketch_decode_attn.compact_live(
            live[:, s0 // bs:(s0 + size) // bs])
        parts.append(sketch_decode_attn.sketch_decode_attn_partial(
            q, k[:, s0:s0 + size].contiguous(), v[:, s0:s0 + size].contiguous(),
            ids_r, n_r, min(max(kv_len - s0, 0), size), bs, softcap))
    assert ops.LAUNCHES["sketch_decode_attn"] == before + 4
    assert torch.isneginf(parts[1][1]).all()
    mesh = sharding.Mesh((dev,) * 4, ("model",))
    for got in sharding.merge_partials(parts, mesh, "model"):
        torch.testing.assert_close(got, whole, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch,B", [("gemma3-4b", 1), ("deepseek-moe-16b", 2),
                                    ("zamba2-2.7b", 2), ("whisper-large-v3", 2)])
def test_mesh_decode_on_the_card_matches_the_cpu_mesh(dev, arch, B):
    """The smoke config's fp32 decode on a 2 x 2 mesh of one card repeated
    against the same mesh of CPU entries (gemma3-4b with the sketch at B =
    1 over four 512-token blocks: the partial kernel on every rank that
    holds a written row), 4 steps from a random 1000-token prefix: logits
    within 1e-5 of their largest, every float32 cache leaf within 1e-5 of
    its largest (the bfloat16 cross cache within one bf16 ulp: an fp32
    value near a rounding boundary rounds either way), the block
    signatures and live lists equal."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model
    from repro_torch.parallel import param_specs
    from repro_torch.serve import kv_cache, serve_step
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              param_dtype="float32")
    sketch = arch == "gemma3-4b"
    tree = model.init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    g = torch.Generator().manual_seed(10)
    one = kv_cache.init_cache(cfg, B, 2048, sketch=sketch, device="cpu")
    for name, x in one.items():
        if name in ("k", "v", "dk", "dv"):
            x[:, :, :1000] = torch.randn(x[:, :, :1000].shape, generator=g)
        elif name == "block_sigs":
            x[:, :, :2] = torch.rand(x[:, :, :2].shape, generator=g) < 0.5
        elif name in ("ssm_state", "conv_buf"):
            x.copy_(torch.randn(x.shape, generator=g))
    one["length"] = 1000
    tokens = torch.randint(0, cfg.vocab, (B, 4), generator=g)
    out = {}
    for where in ("cuda:0", "cpu"):
        mesh = make_test_mesh(2, 2, where)
        cache = kv_cache.shard_cache(one, cfg, mesh)
        params = param_specs.shard_params(tree, mesh)
        if cfg.family == "encdec":
            frames = torch.randn((B, cfg.enc_frames, cfg.d_model),
                                 generator=torch.Generator().manual_seed(11))
            cache = serve_step.encode_cross_cache(params, cfg, frames, cache)
        step = serve_step.make_serve_step(cfg, sketch=sketch, mesh=mesh)
        logits, lives = [], []
        before = ops.LAUNCHES["sketch_decode_attn"]
        for t in range(4):
            lg, cache = step(params, cache, tokens[:, t:t + 1])
            logits.append(lg.cpu())
            lives.append([(i.cpu(), n.cpu()) for i, n in step.last_live])
        out[where] = (logits, lives, {k: v.full("cpu") for k, v in cache.items()
                                      if k != "length"},
                      ops.LAUNCHES["sketch_decode_attn"] - before)
    (lc, vc, cc, nc), (lp, vp, cp, _) = out["cuda:0"], out["cpu"]
    for a, b in zip(lc, lp):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
    assert len(vc) == len(vp)
    for x, y in zip(vc, vp):
        for (i, n), (j, m) in zip(x, y):
            assert torch.equal(i, j) and torch.equal(n, m)
    for name, want in cp.items():
        if want.dtype == torch.bool:
            assert torch.equal(cc[name], want), name
            continue
        if want.dtype == torch.bfloat16:   # the cross cache: one bf16 ulp
            got, want = cc[name].float(), want.float()
            assert bool(((got - want).abs() <= 2.0 ** -7 * want.abs()).all())
            continue
        fin = torch.isfinite(want)
        top = float(want[fin].abs().max()) if fin.any() else 1.0
        torch.testing.assert_close(cc[name][fin].float(), want[fin].float(),
                                   rtol=0, atol=1e-5 * top)
    # the global layers of gemma3-4b's smoke stack on the ranks whose block
    # starts at or below the token: blocks at 0 and 512 of four
    assert nc == (2 * 2 * 4 if sketch else 0)


def test_mesh_decode_on_four_cards_matches_one_card_repeated(dev):
    """The gemma3-4b smoke decode with the sketch at B = 1 over cards 0..3
    (the sequence over data and model) against the same mesh on cuda:0
    repeated: logits and caches bit for bit (the same ops in the same
    order on each card; the peer copies change no value)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model
    from repro_torch.parallel import param_specs
    from repro_torch.serve import kv_cache, serve_step
    cfg = dataclasses.replace(registry.get_smoke_config("gemma3-4b"),
                              param_dtype="float32")
    tree = model.init_params(cfg, torch.Generator().manual_seed(12), "cpu")
    one = kv_cache.init_cache(cfg, 1, 2048, sketch=True, device="cpu")
    g = torch.Generator().manual_seed(13)
    for name in ("k", "v"):
        one[name][:, :, :1500] = torch.randn(one[name][:, :, :1500].shape,
                                             generator=g)
    one["block_sigs"][:, :, :3] = torch.rand((6, 1, 3, 64), generator=g) < 0.5
    one["length"] = 1500
    tokens = torch.randint(0, cfg.vocab, (1, 4), generator=g)
    out = {}
    for where in ("cuda", "cuda:0"):
        mesh = make_test_mesh(2, 2, where)
        cache = kv_cache.shard_cache(one, cfg, mesh)
        params = param_specs.shard_params(tree, mesh)
        step = serve_step.make_serve_step(cfg, sketch=True, mesh=mesh)
        logits = []
        for t in range(4):
            lg, cache = step(params, cache, tokens[:, t:t + 1])
            logits.append(lg.cpu())
        out[where] = logits, {k: v.full("cpu") for k, v in cache.items()
                              if k != "length"}
    for a, b in zip(out["cuda"][0], out["cuda:0"][0]):
        assert torch.equal(a, b)
    for name, x in out["cuda:0"][1].items():
        assert torch.equal(out["cuda"][1][name], x), name


def test_sketch_decode_attn_edge_cases(dev, monkeypatch):
    q, k, v, live, ids, n_live = _sda_case(dev, 3, 2, 2, 64, 1024, 64, 0.5,
                                           torch.float32, 7)
    # an empty live list gives zeros; request 1 has none
    live[1] = False
    ids, n_live = sketch_decode_attn.compact_live(live)
    for kv_len in (1, 37, 65, 700, 1024):          # ragged inside a block
        got = sketch_decode_attn.sketch_decode_attn(q, k, v, ids, n_live,
                                                    kv_len, 64, 0.0)
        want = ref.sketch_decode_attn_ref(q, k, v, live, kv_len, 64, 0.0)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        assert not got[1].any()
    # more splits than live tiles: the idle splits add nothing (fp32 K/V
    # takes the simple path, bf16 the cp.async pipeline)
    few = torch.zeros_like(live)
    few[:, 3] = True
    ids, n_live = sketch_decode_attn.compact_live(few)
    for kv in (torch.float32, torch.bfloat16):
        kd, vd = k.to(kv), v.to(kv)
        for n_split in (1, 2, 16, 256):
            monkeypatch.setattr(sketch_decode_attn, "default_n_split",
                                lambda *shape, n=n_split: n)
            got = sketch_decode_attn.sketch_decode_attn(q, kd, vd, ids, n_live,
                                                        1024, 64, 0.0)
            torch.testing.assert_close(
                got, ref.sketch_decode_attn_ref(q, kd, vd, few, 1024, 64, 0.0),
                rtol=2e-5, atol=2e-5)
    monkeypatch.undo()
    ops.reset_launches()
    ops.sketch_decode_attn(q, k, v, ids, n_live, 1024, 64)
    ops.sketch_decode_attn(q.cpu(), k.cpu(), v.cpu(), ids.cpu(), n_live.cpu(),
                           1024, 64)                 # plain version: no count
    assert ops.LAUNCHES["sketch_decode_attn"] == 1
    with pytest.raises(ValueError):                  # S not a multiple
        sketch_decode_attn.sketch_decode_attn(q, k, v, ids, n_live, 1024, 100)
    with pytest.raises(ValueError):
        sketch_decode_attn.sketch_decode_attn(q, k.half(), v.half(), ids, n_live,
                                              1024, 64)
    with pytest.raises(ValueError):
        sketch_decode_attn.sketch_decode_attn(q, k, v, ids.long(), n_live, 1024, 64)


# --- the streaming services on the card ------------------------------------

_SVC = {"retrieval": dict(dim=8, n_max=64, eta=0.1, r=0.4, c=2.0, w=1.0, L=6,
                          k=3, bucket_cap=4, ingest_chunk=64, query_block=16,
                          topk=8),
        "kde_srp": dict(dim=8, L=6, W=32, window=150, eh_eps=0.2,
                        ingest_chunk=50, query_block=16, hash_family="srp"),
        "kde_pstable": dict(dim=8, L=6, W=32, window=150, eh_eps=0.2,
                            ingest_chunk=50, query_block=16,
                            hash_family="pstable", w=2.0),
        "race": dict(dim=8, L=6, W=32, ingest_chunk=64, query_block=16,
                     hash_family="srp")}
_SVC_KERNELS = {"retrieval": ("sann_table_scatter", "batch_score_topk"),
                "kde_srp": ("srp_hash", "swakde_segment_pass"),
                "kde_pstable": ("swakde_segment_pass",),
                "race": ("srp_hash", "race_hist")}


def _grid_rows(n, seed):
    """Rows on a 1/16 grid: every hash product with 1/8-grid parameters is
    exact in fp32, so the card's codes equal the CPU's."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return (np.round(rng.normal(size=(n, 8)) * 16) / 16).astype(np.float32)


def _service(kind, device, **extra):
    import numpy as np
    from repro_torch import convert
    from repro_torch.core import sann
    from repro_torch.serve import kde_service, race_service, retrieval
    kw = {**_SVC[kind], **extra}
    rng = np.random.default_rng(len(kind))
    if kind == "retrieval":
        cfg = retrieval.RetrievalConfig(**kw)
        base = sann.SANNConfig(dim=8, n_max=cfg.n_max, eta=cfg.eta, r=cfg.r,
                               c=cfg.c, w=cfg.w, L=cfg.L, k=cfg.k,
                               bucket_cap=cfg.bucket_cap).resolved()
        L, k, nb, w, family = base.L, base.k, base.n_buckets, base.w, "pstable"
    elif kind == "race":
        cfg = race_service.RACEServiceConfig(**kw)
        L, k, nb, w, family = cfg.L, cfg.k, cfg.W, cfg.w, cfg.hash_family
    else:
        cfg = kde_service.KDEServiceConfig(**kw)
        L, k, nb, w, family = cfg.L, cfg.k, cfg.W, cfg.w, cfg.hash_family
    p = {"proj": np.round(rng.normal(size=(8, L * k)) * 8) / 8,
         "mix": (rng.integers(1, 2**31 - 1, size=(L, k)) * 2 + 1).astype(np.uint32),
         "L": L, "k": k, "n_buckets": nb}
    p["proj"] = p["proj"].astype(np.float32)
    if family == "pstable":
        p.update(bias=(np.floor(rng.uniform(0, w, L * k) * 8) / 8).astype(
            np.float32), w=w)
    params = convert.params_from_numpy(p, device)
    cls = {"retrieval": retrieval.RetrievalService,
           "race": race_service.RACEService}.get(kind, kde_service.KDEService)
    return cls(cfg, device=device, params=params)


def _drive_service(kind, svc, data):
    svc.ingest(data[:200])
    if kind == "retrieval":
        svc.delete(data[10])
    elif kind == "race":
        svc.delete(data[:3])
    else:
        svc.advance_clock(svc.steps + 30)
    svc.ingest(data[200:])


def _assert_same_answers(got, want):
    import numpy as np
    for name, g, w in zip(getattr(want, "_fields", range(9)),
                          got if isinstance(got, tuple) else (got,),
                          want if isinstance(want, tuple) else (want,)):
        if g.dtype == np.float32 and name in ("distance", 1):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", list(_SVC))
def test_service_round_trip_on_the_card(dev, kind):
    """Each service on the card through its kernels (launch counts), with
    the same stream as on the CPU: bit-identical state, equal answers
    (S-ANN distances within batch_score_topk's tolerance), and coalesced
    B = 1 answers bit-identical to direct ones on the card."""
    import threading
    data = _grid_rows(400, 1)
    qs = _grid_rows(24, 2) + 1 / 32
    cpu = _service(kind, "cpu")
    _drive_service(kind, cpu, data)
    card = _service(kind, dev)
    ops.reset_launches()
    _drive_service(kind, card, data)
    for name in _SVC_KERNELS[kind]:
        if name != "batch_score_topk":
            assert ops.LAUNCHES[name] > 0, name
    for f in card.state._fields:
        assert torch.equal(getattr(card.state, f).cpu(), getattr(cpu.state, f)), f
    kinds = {"retrieval": ("cr", "topk"), "race": ("kde", "density")}.get(
        kind, ("kde", "density"))
    direct = {}
    for kd in kinds:
        ops.reset_launches()
        direct[kd] = card._serve_query(kd, qs)
        if kind == "retrieval":
            assert ops.LAUNCHES["batch_score_topk"] == 2  # two 16-row blocks
        _assert_same_answers(direct[kd], cpu._serve_query(kd, qs))
    card._batch_queries, card._max_wait_us = True, 0.0
    got = {}

    def client(c):
        for j in range(c, 24, 8):
            kd = kinds[j % 2]
            got[(j, kd)] = card._serve_query(kd, qs[j:j + 1])

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert len(got) == 24
    for (j, kd), res in got.items():
        want = direct[kd]
        for g, w in zip(res if isinstance(res, tuple) else (res,),
                        want if isinstance(want, tuple) else (want,)):
            assert (g == w[j:j + 1]).all()
    card.close()
    cpu.close()


@pytest.mark.parametrize("kind", list(_SVC))
def test_service_recovery_on_the_card(dev, tmp_path, kind):
    """A durable service on the card crashes in the stream's tail (an
    injected fault at ``engine.commit``); a fresh one on the card recovers
    from the snapshot + WAL tail to the uninterrupted CPU state, and so
    does one on the CPU from the card's directory."""
    from repro_torch.persist import faults
    data = _grid_rows(400, 3)
    cpu = _service(kind, "cpu")
    _drive_service(kind, cpu, data)
    dur = dict(snapshot_dir=str(tmp_path), snapshot_every=2)
    crash = _service(kind, dev, **dur)
    plan = faults.FaultPlan([faults.FaultSpec("engine.commit", "crash", hit=7)])
    with faults.installed(plan):
        crash.ingest(data[:200])
        if kind == "retrieval":
            crash.delete(data[10])
        elif kind == "race":
            crash.delete(data[:3])
        else:
            crash.advance_clock(crash.steps + 30)
        crash.ingest_async(data[200:])
        with pytest.raises(RuntimeError, match="injected crash"):
            crash.flush()
    crash.close()
    for device in (dev, "cpu"):
        rec = _service(kind, device, **dur)
        assert rec.recover() > 0
        for f in rec.state._fields:
            assert torch.equal(getattr(rec.state, f).cpu(),
                               getattr(cpu.state, f)), f
        rec.close()
    cpu.close()


def test_rpc_cluster_spawned_workers_on_the_card(dev):
    """Two spawned RACE workers, each its own CUDA process on the card: the
    merged state and answers equal the in-process cluster's on the card,
    each worker reports launches of its commit kernels, and no worker
    process outlives `close()`."""
    import numpy as np
    from repro_torch.net import cluster as rpc
    from repro_torch.serve import cluster, race_service
    cfg = race_service.RACEServiceConfig(**_SVC["race"])
    params = _service("race", dev).params
    data = _grid_rows(1000, 5)
    qs = _grid_rows(24, 6) + 1 / 32
    inproc = cluster.ClusterRACEService(cfg, num_workers=2, device=dev,
                                        params=params)
    inproc.ingest(data)
    cl = rpc.RPCClusterRACEService(cfg, num_workers=2, device=dev,
                                   params=params)
    procs = list(cl._procs.values())
    try:
        cl.ingest(data)
        for f in cl.merged_state()._fields:
            assert torch.equal(getattr(cl.merged_state(), f),
                               getattr(inproc.merged_state(), f)), f
        np.testing.assert_array_equal(cl.query(qs), inproc.query(qs))
        for w in cl.workers:
            launches = w.stats()["launches"]
            assert launches["race_hist"] > 0 and launches["srp_hash"] > 0
    finally:
        cl.close()
        inproc.close()
    assert not any(p.is_alive() for p in procs)


# --- sketch sharding on the card ----------------------------------------------

def _sharded_case(mesh_devices):
    """RACE (SRP), SW-AKDE (p-stable) and S-ANN at L = 8 on a mesh of
    ``mesh_devices``, 4 chunks each, against one device on the first
    card: gathered state equal bit for bit, answers equal, one launch of
    each commit kernel (and of `srp_hash`) a shard a chunk.  Answers also
    to Gaussian queries (inexact sums) at batches of 16 and 1024: a GEMM
    of another shape may sum in another order, and a code would move."""
    import numpy as np
    from repro_torch.core import lsh, prng, race, sann, swakde
    from repro_torch.parallel import sketch_sharding as ss
    from repro_torch.parallel.sharding import Mesh
    ctx = ss.make_sketch_ctx(Mesh(mesh_devices))
    K, first = ctx.mesh.size, ctx.mesh.devices[0]
    g = torch.Generator().manual_seed(0)
    data = torch.from_numpy(_grid_rows(4 * 64, 7)).to(first)
    qs = torch.from_numpy(_grid_rows(16, 8) + 1 / 32).to(first)
    chunks = [data[i:i + 64] for i in range(0, 256, 64)]
    gauss = [torch.randn((B, 8), generator=g).to(first) for B in (16, 1024)]

    def on_mesh(state, params, prepare, commit, kernels):
        st, p = ss.shard_state(state, ctx), ss.shard_params(params, ctx)
        for i, x in enumerate(chunks):
            ops.reset_launches()
            st = commit(st, prepare(p, x, i))
            for name in kernels:
                assert ops.LAUNCHES[name] == K, (name, ops.LAUNCHES[name])
        for sh, dev in zip(st, ctx.mesh.devices):
            assert all(t.device == dev for t in sh), dev
        return st, p

    # RACE
    p1 = lsh.init_srp(g, 8, 8, 2, 32, device=first)
    one = race.race_init(8, 32, first)
    for x in chunks:
        one = race.race_update_batch(one, p1, x)
    st, p = on_mesh(race.race_init(8, 32, first), p1,
                    lambda p, x, i: ss.sharded_race_prepare_chunk(p, x, 32, ctx),
                    lambda s, pr: ss.sharded_race_commit_chunk(s, pr, ctx),
                    ("srp_hash", "race_hist"))
    for a, b in zip(ss.gather_state(st, ctx), one):
        assert torch.equal(a, b)
    for q in [qs] + gauss:
        assert torch.equal(ss.sharded_race_query_batch(st, p, q, ctx, 4),
                           race.race_query_batch(one, p1, q, 4))
    # SW-AKDE, expiring
    cfg = swakde.SWAKDEConfig(L=8, W=32, window=150, eh_eps=0.2)
    p1 = lsh.init_pstable(g, 8, 8, 2, 2.0, 32, device=first)
    one = swakde.swakde_init(cfg, first)
    for x in chunks:
        one = swakde.swakde_update_chunk(one, p1, x, cfg)
    st, p = on_mesh(swakde.swakde_init(cfg, first), p1,
                    lambda p, x, i: ss.sharded_swakde_prepare_chunk(p, x, cfg,
                                                                    ctx),
                    lambda s, pr: ss.sharded_swakde_commit_chunk(s, pr, cfg,
                                                                 ctx),
                    ("swakde_segment_pass",))
    for a, b in zip(ss.gather_state(st, ctx), one):
        assert torch.equal(a, b)
    grid = ss.sharded_swakde_grid_estimates(st, cfg, ctx)
    want = swakde.swakde_query_batch(one, p1, qs, cfg)
    assert torch.equal(ss.sharded_swakde_query_from_grid(grid, p, qs, cfg, ctx),
                       want)
    assert torch.equal(ss.sharded_swakde_query_batch(st, p, qs, cfg, ctx), want)
    for q in gauss:
        want = swakde.swakde_query_batch(one, p1, q, cfg)
        assert torch.equal(ss.sharded_swakde_query_batch(st, p, q, cfg, ctx),
                           want)
        assert torch.equal(ss.sharded_swakde_query_from_grid(grid, p, q, cfg,
                                                             ctx), want)
    # S-ANN, the ring wrapping
    scfg = sann.SANNConfig(dim=8, n_max=64, eta=0.1, r=0.4, c=2.0, w=1.0,
                           L=8, k=3, bucket_cap=4).resolved()
    p1 = lsh.init_pstable(g, 8, scfg.L, scfg.k, scfg.w, scfg.n_buckets,
                          device=first)
    keys = prng.split(prng.PRNGKey(3, first), 4)
    one = sann.sann_empty_state(scfg, first)
    for x, k in zip(chunks, keys):
        one = sann.sann_insert_batch(one, p1, x, k, scfg)
    st, p = on_mesh(sann.sann_empty_state(scfg, first), p1,
                    lambda p, x, i: ss.sharded_sann_prepare_chunk(
                        p, x, keys[i], scfg, ctx),
                    lambda s, pr: ss.sharded_sann_commit_chunk(s, pr, scfg,
                                                               ctx),
                    ("sann_table_scatter",))
    for a, b in zip(ss.gather_state(st, ctx), one):
        assert torch.equal(a, b)
    got = ss.sharded_sann_query_batch(st, p, data[-16:], scfg, ctx)
    want = sann.sann_query_batch(one, p1, data[-16:], scfg)
    assert bool(want.found.any())
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for q in [qs] + gauss:
        ids, d = ss.sharded_sann_query_topk_batch(st, p, q, scfg, ctx, topk=8)
        wi, wd = sann.sann_query_topk_batch(one, p1, q, scfg, 8)
        assert torch.equal(ids, wi) and torch.equal(d, wd)
    for q in gauss:
        for a, b in zip(ss.sharded_sann_query_batch(st, p, q, scfg, ctx),
                        sann.sann_query_batch(one, p1, q, scfg)):
            assert torch.equal(a, b)


def test_sharded_entries_on_one_card_match_one_device(dev):
    _sharded_case((dev,) * 4)


def test_sharded_services_on_one_card_match_one_device(dev, tmp_path):
    """The three services on a mesh of one card repeated four times:
    state, answers and snapshot files equal the single-device service's on
    the card, and each recovers the other's directory."""
    from repro_torch.parallel.sharding import Mesh
    data = _grid_rows(400, 9)
    qs = _grid_rows(16, 10) + 1 / 32
    for kind in ("retrieval", "kde_pstable", "race"):
        kw = dict(L=8, snapshot_every=2)
        one = _service(kind, dev, snapshot_dir=str(tmp_path / kind / "1"),
                       **kw)
        four = _service(kind, dev, snapshot_dir=str(tmp_path / kind / "4"),
                        mesh=Mesh((dev,) * 4), **kw)
        assert four.num_shards == 4
        for svc in (one, four):
            _drive_service(kind, svc, data)
        for a, b in zip(four.gather_state(four.state), one.state):
            assert torch.equal(a, b)
        _assert_same_answers(four._serve_query(four._default_query_kind, qs),
                             one._serve_query(one._default_query_kind, qs))
        one.close()
        four.close()
        for step in sorted((tmp_path / kind / "1").glob("step_*")):
            for f in step.iterdir():
                other = tmp_path / kind / "4" / step.name / f.name
                assert f.read_bytes() == other.read_bytes(), (kind, f)
        for src, mesh in (("1", Mesh((dev,) * 4)), ("4", None)):
            rec = _service(kind, dev, snapshot_dir=str(tmp_path / kind / src),
                           mesh=mesh, **kw)
            assert rec.recover() >= 0
            for a, b in zip(rec.gather_state(rec.state), one.state):
                assert torch.equal(a, b)
            rec.close()


def test_kernels_launch_on_the_card_that_holds_their_tensors(dev):
    """A kernel on tensors of the second card launches there (the count
    moves, the answer equals the plain version); tensors on two cards are
    refused before any launch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    d1 = torch.device("cuda", 1)
    g = torch.Generator(device=d1).manual_seed(1)
    codes = torch.randint(0, 40, (1000, 7), generator=g, device=d1,
                          dtype=torch.int32)
    ops.reset_launches()
    with torch.cuda.device(0):
        got = race_update.race_hist(codes, 33)
    assert got.device == d1 and ops.LAUNCHES["race_hist"] == 1
    assert torch.equal(got.cpu(), ref.race_hist_ref(codes.cpu(), 33))
    x = torch.randn((77, 50), generator=g, device=d1)
    proj = torch.randn((50, 13 * 5), generator=g, device=d1)
    mix = torch.randint(1, 2**31 - 1, (13, 5), generator=g, device=d1,
                        dtype=torch.int64) * 2 + 1
    flips, unexplained = ref.srp_code_flips(
        x, proj, mix, srp_hash.srp_hash(x, proj, mix, 1009),
        ref.srp_hash_ref(x, proj, mix, 1009))
    assert unexplained == 0
    q, k, v, live, ids, n_live = _sda_case(d1, 2, 2, 2, 256, 2048, 64, 1,
                                           torch.bfloat16, 9)
    torch.testing.assert_close(
        sketch_decode_attn.sketch_decode_attn(q, k, v, ids, n_live, 2000, 64),
        ref.sketch_decode_attn_ref(q, k, v, live, 2000, 64),
        rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="expected a tensor on"):
        srp_hash.srp_hash(x, proj.to(dev), mix, 1009)
    with pytest.raises(ValueError, match="a launch takes one card"):
        from repro_torch.kernels import _build
        _build.launch("race_hist", "race_hist_launch", codes,
                      torch.empty((7, 33), dtype=torch.int32, device=dev),
                      1000, 7, 33)


def test_shards_on_four_cards_match_one_card_repeated(dev):
    """cuda:0..3 against ("cuda:0",) * 4 and one device: every shard's
    leaves on its own card, the same state and answers."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    _sharded_case(tuple(torch.device("cuda", i) for i in range(4)))


# ---------------------------------------------------------------------------
# the training path: flash attention, the drift monitor, the train step
# ---------------------------------------------------------------------------

def _dense_attention(q, k, v, window, softcap):
    G = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(q.shape[1], device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (96, 0.0), (96, 30.0)])
def test_flash_function_matches_dense_attention_on_the_card(dev, window, softcap):
    """fp32 (TF32 off): output and gradients within 2e-5 of the largest
    value of autograd through one dense masked softmax (sums in another
    order); GQA 8 / 2, blocks of 64 over S = 256."""
    from repro_torch.models import flash
    g = torch.Generator(device=dev).manual_seed(window)
    mk = lambda *s: torch.randn(s, generator=g, device=dev)
    q, k, v, go = mk(2, 256, 8, 64), mk(2, 256, 2, 64), mk(2, 256, 2, 64), mk(2, 256, 8, 64)
    res = []
    for fn in (lambda a, b, c: flash.flash_attention(
                   a, b, c, window=window, softcap=softcap, block_q=64, block_k=64),
               lambda a, b, c: _dense_attention(a, b, c, window, softcap)):
        a, b, c = (t.clone().requires_grad_() for t in (q, k, v))
        o = fn(a, b, c)
        o.backward(go)
        res.append((o.detach(), a.grad, b.grad, c.grad))
    for got, want in zip(*res):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2e-5 * float(want.abs().max()))


def test_drift_monitor_chunk_matches_per_example_on_the_card(dev):
    """The monitor's one chunk a batch (one `srp_hash` and one
    `swakde_segment_pass` launch) against `swakde_update` one example at a
    time and `swakde_query` on the card: the same state bit for bit and the
    same densities."""
    from repro_torch.core import swakde
    from repro_torch.data import pipeline
    dcfg = pipeline.DataConfig(vocab=2048, batch=3, seq=64, seed=4,
                               drift_window=32, drift_width=64)
    mon = pipeline.DriftMonitor(dcfg, dev)
    state = swakde.swakde_init(mon.cfg, dev)
    stream = pipeline.TokenStream(dcfg, drift_at=10)
    for i in range(16):
        toks = stream.next_batch()
        emb = torch.from_numpy(mon.embed(toks).astype("float32")).to(dev)
        want = float(swakde.swakde_query(state, mon.params, emb.mean(0), mon.cfg))
        for x in emb:
            state = swakde.swakde_update(state, mon.params, x, mon.cfg)
        before = dict(ops.LAUNCHES)
        got = mon.observe(toks)
        assert {k: ops.LAUNCHES[k] - before[k]
                for k in ("srp_hash", "swakde_segment_pass")} == \
            {"srp_hash": 1, "swakde_segment_pass": 1}
        assert got["density"] == want, i
        for f in state._fields:
            assert torch.equal(getattr(mon.state, f), getattr(state, f)), (i, f)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_step_repeats_bit_for_bit_on_the_card(dev, dtype):
    """Two runs of two AdamW steps from one seed give the same parameters
    and optimizer state bit for bit (the embedding's backward included:
    the batches repeat tokens)."""
    import dataclasses
    from repro_torch.checkpoint.checkpoint import tree_leaves
    from repro_torch.configs import gemma3_4b
    from repro_torch.optim import adam
    from repro_torch.train import train_step
    cfg = dataclasses.replace(gemma3_4b.smoke(), n_layers=3, param_dtype=dtype)
    tokens = torch.randint(0, 40, (4, 128), generator=torch.Generator().manual_seed(5))
    runs = []
    for _ in range(2):
        step, init = train_step.make_train_step(cfg, adam.adamw(lr=1e-3))
        state = init(torch.Generator(device=dev).manual_seed(6), dev)
        for _ in range(2):
            state, m = step(state, {"tokens": tokens.to(dev)})
        runs.append(tree_leaves(state))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b",
                                  "zamba2-2.7b", "xlstm-125m",
                                  "whisper-large-v3", "internvl2-76b"])
def test_family_decode_on_the_card_matches_the_cpu(dev, arch):
    """Each family's smoke config in float32: 8 greedy decode steps on the
    card against the plain path on the CPU from one tree and one zero
    cache (whisper's cross cache from the same frames; internvl2 with
    sketch attention, every layer launching `sketch_decode_attn`).  Logits
    and every float cache leaf within 1e-5 of their largest value (fp32
    sums in another order; the bf16 cross cache within one ulp of its
    largest value), bool
    leaves and ``length`` equal."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import model
    from repro_torch.serve import kv_cache, serve_step
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              param_dtype="float32")
    sketch = cfg.family == "vlm"
    s_max = 1024 if sketch else 64
    cpu = torch.device("cpu")
    params = model.init_params(cfg, torch.Generator().manual_seed(1), cpu)
    to_dev = lambda t: {k: to_dev(v) if isinstance(v, dict) else v.to(dev)
                        for k, v in t.items()}
    trees = {cpu: params, dev: to_dev(params)}
    caches = {d: kv_cache.init_cache(cfg, 2, s_max, sketch=sketch, device=d)
              for d in (cpu, dev)}
    if cfg.family == "encdec":
        frames = torch.randn(2, cfg.enc_frames, cfg.d_model,
                             generator=torch.Generator().manual_seed(2))
        for d in (cpu, dev):
            caches[d] = serve_step.encode_cross_cache(trees[d], cfg,
                                                      frames.to(d), caches[d])
    step = serve_step.make_serve_step(cfg, sketch=sketch)
    tok = torch.zeros((2, 1), dtype=torch.long)
    for _ in range(8):
        before = ops.LAUNCHES["sketch_decode_attn"]
        out = {d: step(trees[d], caches[d], tok.to(d)) for d in (cpu, dev)}
        launched = ops.LAUNCHES["sketch_decode_attn"] - before
        assert launched == (cfg.n_layers if sketch else 0)
        (lc, caches[cpu]), (lg, caches[dev]) = out[cpu], out[dev]
        torch.testing.assert_close(lg.cpu(), lc, rtol=0,
                                   atol=1e-5 * float(lc.abs().max()))
        tok = lc.argmax(-1)
    assert caches[dev]["length"] == caches[cpu]["length"] == 8
    for name, want in caches[cpu].items():
        if name == "length":
            continue
        got = caches[dev][name].cpu()
        if want.dtype == torch.bool:
            assert torch.equal(got, want), name
        elif want.dtype == torch.bfloat16:
            # whisper's cross cache, bf16 as the reference stores it: an fp32
            # value near a rounding boundary may round either way, one ulp
            # of at most the leaf's largest value
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=2.0 ** -7 * float(want.float().abs().max()),
                                       msg=name)
        else:
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=1e-5 * float(want.float().abs().max()),
                                       msg=name)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b",
                                  "zamba2-2.7b", "xlstm-125m",
                                  "whisper-large-v3", "internvl2-76b"])
def test_family_train_step_on_the_card_matches_the_cpu(dev, arch):
    """Each trained family's smoke config in float32, one tree and one
    batch of 8 rows (``launch.inputs.make_batch``: tokens, and the
    frontends' frames or patches; deepseek-v3 accumulates its 8
    microbatches in bf16, as published) on the card and on the CPU: the
    gradients of
    ``grads_and_metrics`` within 1e-4 of their largest entry (zamba2's
    within one bf16 ulp, 2^-8: its Mamba2 scores round to bf16 in both),
    then one AdamW step of ``make_train_step``: every metric within 1e-5
    relative (the grad norm 1e-4) and every parameter within twice the
    step's learning rate (lr_t = 2e-5 at the first step of a 100-step
    warmup): the step moves a parameter by lr_t times ``g / (|g| + eps)``
    plus the same decay on both, so an element whose gradients lie in
    Adam's eps region on the two devices may move up to 2 lr_t apart."""
    import dataclasses
    from repro_torch.checkpoint.checkpoint import _flatten, tree_map
    from repro_torch.configs import registry
    from repro_torch.launch import inputs
    from repro_torch.models import model
    from repro_torch.optim import adam
    from repro_torch.train import train_step
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              param_dtype="float32")
    cpu = torch.device("cpu")
    seq = 64 + (cfg.n_patches if cfg.family == "vlm" else 0)
    batch = inputs.make_batch(cfg, 8, seq, torch.Generator().manual_seed(3))
    params = model.init_params(cfg, torch.Generator().manual_seed(4), cpu)
    trees = {cpu: params, dev: tree_map(lambda t: t.to(dev, copy=True), params)}
    batches = {d: {k: v.to(d) for k, v in batch.items()} for d in (cpu, dev)}
    grads = {d: train_step.grads_and_metrics(trees[d], cfg, batches[d])[0]
             for d in (cpu, dev)}
    tol = 2.0 ** -8 if cfg.family == "hybrid" else 1e-4
    for (k, want), (_, got) in zip(_flatten(grads[cpu]), _flatten(grads[dev])):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=tol * float(want.abs().max()), msg=k)
    metrics = {}
    for d in (cpu, dev):
        step, _ = train_step.make_train_step(cfg, adam.adamw(lr=1e-3))
        p = trees[d]
        state = train_step.TrainState(p, adam.adamw(lr=1e-3).init(p),
                                      torch.zeros((), dtype=torch.int32,
                                                  device=d))
        state, metrics[d] = step(state, batches[d])
        trees[d] = state.params
    for k, want in metrics[cpu].items():
        rtol = 1e-4 if k == "grad_norm" else 1e-5
        assert abs(float(metrics[dev][k]) - float(want)) <= rtol * abs(float(want)) + 1e-12, k
    lr_t = float(adam._step_scalars(torch.ones((), dtype=torch.int32), 1e-3,
                                    0.9, 0.95, 100)[0])
    for (k, want), (_, got) in zip(_flatten(trees[cpu]), _flatten(trees[dev])):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=2 * lr_t + 1e-7, msg=k)


# ---------------------------------------------------------------------------
# LM training on a (data, model) mesh
# ---------------------------------------------------------------------------

MESH_LR = 1e-3


def _mesh_step(cfg, mesh, tree, tokens):
    """One AdamW step (lr MESH_LR, no warmup) of ``tree`` on ``mesh``:
    (gathered parameters, gathered first moment, metrics)."""
    from repro_torch.optim import adam
    from repro_torch.parallel import param_specs
    from repro_torch.train import train_step
    opt = adam.adamw(lr=MESH_LR, warmup=1)
    step, _ = train_step.make_train_step(cfg, opt, mesh)
    params = param_specs.shard_params(tree, mesh)
    state = train_step.TrainState(params, adam.init_on_mesh(opt, params),
                                  torch.zeros((), dtype=torch.int32,
                                              device=mesh.devices[0]))
    state, m = step(state, {"tokens": tokens})
    return (param_specs.gather_params(state.params, "cpu"),
            param_specs.gather_params(state.opt_state.m, "cpu"), m)


def _assert_mesh_step_close(got, want, gtol, mtol=1e-5, ntol=1e-4):
    """Two `_mesh_step` results: the gradients (AdamW's first moment after
    one step, ``(1 - b1) g``) leaf by leaf within ``gtol(name)`` of each
    leaf's largest, the metrics within ``mtol`` relative (the grad norm
    ``ntol``); the parameters within ``rtol 2e-4, atol 2e-5`` (the
    reference's bounds), but where the two gradients differ by more than
    half of ``want``'s or ``want``'s is under 100 eps (there the update
    g / (|g| + eps) may take either sign) within that bound plus
    ``2 MESH_LR``."""
    from repro_torch.checkpoint.checkpoint import _flatten
    (pa, ga, ma), (pb, gb, mb) = got, want
    for k, v in mb.items():
        rtol = ntol if k == "grad_norm" else mtol
        assert abs(float(ma[k]) - float(v)) <= rtol * abs(float(v)) + 1e-12, k
    for (k, a), (_, b), (_, x), (_, y) in zip(_flatten(pa), _flatten(pb),
                                              _flatten(ga), _flatten(gb)):
        top = float(y.abs().max())
        assert float((x - y).abs().max()) <= gtol(k) * top, k
        free = ((x - y).abs() > 0.5 * y.abs()) | (y.abs() <= 1e-7)
        bound = 2e-5 + 2e-4 * b.abs() + torch.where(free, 2 * MESH_LR, 0.0)
        assert bool(((a - b).abs() <= bound).all()), k


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
def test_mesh_train_step_on_the_card_matches_the_cpu_mesh(dev, arch):
    """The smoke config's fp32 step on a 2 x 2 mesh of one card repeated
    against the same mesh of CPU entries (``moe_ep`` for deepseek-moe-16b,
    whose ranks' bf16 combine may round a sum either way: its gradients
    within 2e-2 of their largest, ``moe_ep``'s bf16 bound; qwen3-4b's
    within 1e-4), by `_assert_mesh_step_close`."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              param_dtype="float32")
    tree = model.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    tokens = torch.randint(0, cfg.vocab, (8, 32),
                           generator=torch.Generator().manual_seed(6))
    got = _mesh_step(cfg, make_test_mesh(2, 2, "cuda:0"), tree, tokens)
    want = _mesh_step(cfg, make_test_mesh(2, 2, "cpu"), tree, tokens)
    tol = 2e-2 if cfg.family == "moe" else 1e-4
    _assert_mesh_step_close(got, want, lambda k: tol)


def test_mesh_on_four_cards_matches_one_card_repeated(dev):
    """The deepseek-moe-16b smoke step on cuda:0..3 (data 2 x model 2)
    against the same mesh on cuda:0 repeated: the collectives' peer copies
    change no value, and only the order in which a block's gradient terms
    from several ranks add up differs (each card's backward runs on a
    thread of its own): metrics within 1e-6 relative, gradients within
    1e-4 of their largest, parameters as `_assert_mesh_step_close` holds
    them.  On the four cards the step repeats bit for bit (each
    all-gather's backward adds a block's terms in rank order, whichever
    card's thread runs it)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    import dataclasses
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model
    cfg = dataclasses.replace(registry.get_smoke_config("deepseek-moe-16b"),
                              param_dtype="float32")
    tree = model.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    tokens = torch.randint(0, cfg.vocab, (8, 32),
                           generator=torch.Generator().manual_seed(8))
    got = _mesh_step(cfg, make_test_mesh(2, 2, "cuda"), tree, tokens)
    again = _mesh_step(cfg, make_test_mesh(2, 2, "cuda"), tree, tokens)
    assert {k: float(v) for k, v in got[2].items()} == \
        {k: float(v) for k, v in again[2].items()}
    for a, b in zip(got[:2], again[:2]):
        for (k, x), (_, y) in zip(_flatten(a), _flatten(b)):
            assert torch.equal(x, y), k
    want = _mesh_step(cfg, make_test_mesh(2, 2, "cuda:0"), tree, tokens)
    _assert_mesh_step_close(got, want, lambda k: 1e-4, mtol=1e-6, ntol=1e-6)


def test_hybrid_head_split_on_the_card_matches_one_device(dev):
    """The zamba2 smoke step (fp32) on a 2 x 2 mesh of one card repeated,
    Mamba2's heads over ``model``, against the one-device step on the same
    card: the intra-chunk scores are rounded to bfloat16 on both paths, so
    a score whose float32 value moves in its last bit with another product
    shape rounds one ulp apart; the gradients and the gradient norm within
    one bfloat16 ulp (2^-8) of their largest, the metrics within 1e-5
    relative, the parameters by `_assert_mesh_step_close`."""
    import dataclasses
    from repro_torch.checkpoint.checkpoint import tree_map
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model
    from repro_torch.optim import adam
    from repro_torch.train import train_step
    cfg = dataclasses.replace(registry.get_smoke_config("zamba2-2.7b"),
                              param_dtype="float32")
    tree = model.init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    tokens = torch.randint(0, cfg.vocab, (8, 32),
                           generator=torch.Generator().manual_seed(10))
    card = torch.device("cuda", 0)
    got = _mesh_step(cfg, make_test_mesh(2, 2, card), tree, tokens)
    opt = adam.adamw(lr=MESH_LR, warmup=1)
    step, _ = train_step.make_train_step(cfg, opt)
    params = tree_map(lambda x: x.to(card), tree)
    state = train_step.TrainState(params, opt.init(params),
                                  torch.zeros((), dtype=torch.int32,
                                              device=card))
    state, m = step(state, {"tokens": tokens.to(card)})
    want = (tree_map(lambda x: x.cpu(), state.params),
            tree_map(lambda x: x.cpu(), state.opt_state.m), m)
    _assert_mesh_step_close(got, want, lambda k: 2.0 ** -8, ntol=2.0 ** -8)


def test_v3_mesh_on_four_cards_matches_one_card_repeated(dev):
    """The deepseek-v3 smoke step (fp32, one microbatch: MLA split by
    heads, the MoE expert-parallel, the MTP head) on cuda:0..3 (data 2 x
    model 2) repeats bit for bit and equals the same mesh on cuda:0
    repeated at `test_mesh_on_four_cards_matches_one_card_repeated`'s
    bounds: metrics within 1e-6 relative, gradients within 1e-4 of their
    largest."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    import dataclasses
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model
    cfg = dataclasses.replace(registry.get_smoke_config("deepseek-v3-671b"),
                              param_dtype="float32", grad_microbatches=1)
    tree = model.init_params(cfg, torch.Generator().manual_seed(11), "cpu")
    tokens = torch.randint(0, cfg.vocab, (8, 32),
                           generator=torch.Generator().manual_seed(12))
    got = _mesh_step(cfg, make_test_mesh(2, 2, "cuda"), tree, tokens)
    again = _mesh_step(cfg, make_test_mesh(2, 2, "cuda"), tree, tokens)
    assert {k: float(v) for k, v in got[2].items()} == \
        {k: float(v) for k, v in again[2].items()}
    for a, b in zip(got[:2], again[:2]):
        for (k, x), (_, y) in zip(_flatten(a), _flatten(b)):
            assert torch.equal(x, y), k
    want = _mesh_step(cfg, make_test_mesh(2, 2, "cuda:0"), tree, tokens)
    _assert_mesh_step_close(got, want, lambda k: 1e-4, mtol=1e-6, ntol=1e-6)
