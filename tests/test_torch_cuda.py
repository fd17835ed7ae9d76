"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip on a machine without a GPU (the CPU parity tests
in tests/test_torch_*.py cover the plain versions against the reference).
Run them on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes here are small and chosen for edge cases the main path does not
reach: a histogram wider than shared memory, k = 64, d not a multiple of
32, ties, fully masked rows, capped segment passes.
"""
import pytest
import torch

from repro_torch.kernels import batch_score, ingest_commit, ops, race_update, ref

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


@pytest.mark.parametrize("B,M,d,k", [(37, 10, 5, 1), (37, 10, 5, 10),
                                     (64, 200, 45, 64), (9, 33, 128, 33)])
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
    torch.testing.assert_close(d_k, d_r, rtol=1e-5, atol=1e-6)
    full = torch.where(ok, ref.batch_score_ref(qs, cands), float("inf"))
    a = torch.gather(full, 1, i_k.long())
    b = torch.gather(full, 1, i_r.long())
    tie = (a == b) | ((a - b).abs() <= 1e-6 + 1e-5 * b.abs())
    assert bool(((i_k == i_r) | tie).all())
    assert torch.equal(i_k[3], torch.arange(k, device=dev, dtype=torch.int32))


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
