"""SW-AKDE — Sliding-Window Approximate KDE (paper §4, Algorithm 2).

A RACE grid in which every cell is an Exponential Histogram: cell
(i, h_i(x)) records a 1 at the arrival timestep and a query reads the EH
estimate of the increments in the last N steps; the estimator is the row
average.  The PyTorch counterpart of the reference's ``core/swakde.py``.

`swakde_update` / `swakde_stream` are the per-point oracle (one `eh_add`
over the L hit cells per point).  Batched ingest is two-phase (DESIGN.md
§10): `swakde_prepare_chunk` hashes the chunk and sorts each row's codes
into per-cell segments;
`swakde_commit_chunk` settles every hit cell in closed-form segment passes
(DESIGN.md §12) until its segment is drained: on the card one launch of the
`swakde_segment_pass` kernel's drained entry, with no host sync; on the CPU
the plain pass loop.  The state is all int32 and bit-identical to the
reference's, dead ring slots included.

`swakde_merge` unions two sketches cell by cell (`eh.eh_merge`), and
`BatchSWAKDE*` is the Corollary-4.2 model: one batch a timestep, SumEH
cells fed by the `race_hist` kernel's per-cell counts.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import lsh
from .eh import (EHConfig, EHState, SumEHConfig, SumEHState, eh_add,
                 eh_merge, eh_query_cells, sum_eh_add)
from .util import mean_last, resolve_device, saturating_add
from ..kernels import ops as kernel_ops

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class SWAKDEConfig:
    L: int               # rows (repetitions R in the paper's space bound)
    W: int               # LSH range (bucket count after rehash)
    window: int          # N
    eh_eps: float        # eps' — EH relative error
    heavy_cell_cap: int = 0
    """Bound on the adds one (row, cell) segment absorbs per commit pass
    (0 = uncapped).  The result is bit-identical for every value."""

    @property
    def kde_eps(self) -> float:
        """Paper Lemma 4.3: eps = 2*eps' + eps'^2."""
        return 2 * self.eh_eps + self.eh_eps**2

    def eh_config(self) -> EHConfig:
        return EHConfig.create(self.window, self.eh_eps)


class SWAKDEState(NamedTuple):
    ts: torch.Tensor     # (L, W, levels, slots) int32
    num: torch.Tensor    # (L, W, levels) int32
    t: torch.Tensor      # () int32 current timestep, saturating


def swakde_init(cfg: SWAKDEConfig, device="cuda") -> SWAKDEState:
    """Empty sketch on ``device`` (raises on ``"cuda"`` without a card):
    ``ts`` -1 (empty bucket), ``num`` 0, ``t`` 0."""
    device = resolve_device(device)
    eh = cfg.eh_config()
    return SWAKDEState(
        ts=torch.full((cfg.L, cfg.W, eh.levels, eh.slots), -1, dtype=_I32,
                      device=device),
        num=torch.zeros((cfg.L, cfg.W, eh.levels), dtype=_I32, device=device),
        t=torch.zeros((), dtype=_I32, device=device),
    )


def swakde_update(state: SWAKDEState, params, x: torch.Tensor,
                  cfg: SWAKDEConfig) -> SWAKDEState:
    """One stream element ``x (d,)``: hash with L rows, `eh_add` the L hit
    cells at timestep ``t``.  Per-point oracle; `swakde_update_chunk` is
    bit-identical."""
    codes = lsh.hash_points(params, x).long()               # (L,)
    rows = torch.arange(cfg.L, device=x.device)
    cell = eh_add(EHState(ts=state.ts[rows, codes], num=state.num[rows, codes]),
                  state.t, cfg.eh_config())
    ts, num = state.ts.clone(), state.num.clone()
    ts[rows, codes] = cell.ts                               # rows distinct
    num[rows, codes] = cell.num
    return SWAKDEState(ts=ts, num=num, t=saturating_add(state.t, 1))


def swakde_stream(state: SWAKDEState, params, xs: torch.Tensor,
                  cfg: SWAKDEConfig) -> SWAKDEState:
    """Feed ``xs (T, d)`` through `swakde_update`, one step per point."""
    for x in xs:
        state = swakde_update(state, params, x, cfg)
    return state


class SWAKDEPrep(NamedTuple):
    """The state-independent half of a chunk update; per-add timestamps are
    offsets within the chunk (the stable-sort order)."""
    order: torch.Tensor      # (L, C) int32 — per-row stable sort order of codes
    seg_code: torch.Tensor   # (L, SW) int32 — cell code per segment (W = pad)
    seg_len: torch.Tensor    # (L, SW) int32 — points hitting each segment
    seg_first: torch.Tensor  # (L, SW) int32 — first sorted position of segment


def swakde_prepare_chunk(params, xs: torch.Tensor, cfg: SWAKDEConfig,
                         mask: Optional[torch.Tensor] = None) -> SWAKDEPrep:
    """Prepare ``xs (C, d)``: one hash matmul, then the sort of each row's
    codes into cell segments (`swakde_prepare_from_codes`)."""
    return swakde_prepare_from_codes(lsh.hash_points(params, xs), cfg, mask)


def _scatter_rows(base: torch.Tensor, seg_id: torch.Tensor, src: torch.Tensor,
                  reduce: Optional[str] = None) -> torch.Tensor:
    """Per-row scatter into ``base (L, n)`` at ``seg_id (L, C)``, dropping
    ids ``>= n`` (the reference's ``mode="drop"``); ``reduce`` as in
    `torch.Tensor.scatter_reduce_` (None = overwrite, every writer of one
    id writes the same value)."""
    L, n = base.shape
    buf = torch.cat([base, base.new_zeros((L, 1))], dim=1)
    idx = torch.clamp(seg_id, max=n).long()
    if reduce is None:
        buf.scatter_(1, idx, src)
    else:
        buf.scatter_reduce_(1, idx, src, reduce=reduce)
    return buf[:, :n].contiguous()


def swakde_prepare_from_codes(codes: torch.Tensor, cfg: SWAKDEConfig,
                              mask: Optional[torch.Tensor] = None) -> SWAKDEPrep:
    """The sort-into-segments half alone, from codes ``(C, L) int32``.
    ``mask`` (optional, (C,) bool, a prefix of live rows) sends masked rows
    to the sentinel code ``W``: they sort last and never touch the grid."""
    C, L = codes.shape
    SW = min(C, cfg.W)                       # max distinct cells hit per row
    dev = codes.device
    if mask is not None:
        codes = torch.where(mask[:, None], codes, cfg.W)
    codes_t = codes.to(_I32).t().contiguous()                    # (L, C)
    order = torch.argsort(codes_t, dim=1, stable=True)
    sc = torch.gather(codes_t, 1, order)
    is_start = torch.ones((L, C), dtype=torch.bool, device=dev)
    is_start[:, 1:] = sc[:, 1:] != sc[:, :-1]
    seg_id = torch.cumsum(is_start, dim=1) - 1                   # (L, C)
    pos = torch.arange(C, dtype=_I32, device=dev).expand(L, C)
    seg_len = _scatter_rows(torch.zeros((L, SW), dtype=_I32, device=dev),
                            seg_id, torch.ones_like(sc), reduce="sum")
    seg_code = _scatter_rows(torch.full((L, SW), cfg.W, dtype=_I32, device=dev),
                             seg_id, sc)
    seg_first = _scatter_rows(torch.full((L, SW), C, dtype=_I32, device=dev),
                              seg_id, pos.contiguous(), reduce="amin")
    # Sentinel segments (unused slots and the masked-row segment) carry code
    # W and stay empty so the commit never drains them.
    seg_len = torch.where(seg_code == cfg.W, 0, seg_len)
    return SWAKDEPrep(order=order.to(_I32).contiguous(), seg_code=seg_code,
                      seg_len=seg_len, seg_first=seg_first)


def swakde_commit_chunk(state: SWAKDEState, prep: SWAKDEPrep,
                        cfg: SWAKDEConfig, count=None) -> SWAKDEState:
    """Commit: every hit cell absorbs its segment's arrivals in closed-form
    passes until the segment is drained (`kernel_ops.swakde_segment_commit`:
    one launch on the card, no host sync), written into a copy of the grid.
    ``count`` (optional) overrides the clock advance (default C), for a
    prefix-masked prepare."""
    eh = cfg.eh_config()
    C = prep.order.shape[1]
    sorted_ts = saturating_add(state.t, prep.order)              # (L, C)
    ts, num = kernel_ops.swakde_segment_commit(
        state.ts.contiguous(), state.num.contiguous(), sorted_ts,
        prep.seg_code, prep.seg_first, prep.seg_len, window=cfg.window,
        maxb=eh.max_buckets_per_level, n_levels=eh.levels,
        cap=cfg.heavy_cell_cap)
    return SWAKDEState(ts=ts, num=num,
                       t=saturating_add(state.t, C if count is None else count))


def swakde_update_chunk(state: SWAKDEState, params, xs: torch.Tensor,
                        cfg: SWAKDEConfig) -> SWAKDEState:
    """Consume a whole chunk ``xs (C, d)``: prepare then commit."""
    return swakde_commit_chunk(state, swakde_prepare_chunk(params, xs, cfg),
                               cfg)


def swakde_stream_batched(state: SWAKDEState, params, xs: torch.Tensor,
                          cfg: SWAKDEConfig, chunk: int = 1024) -> SWAKDEState:
    """Stream ``xs (T, d)`` through `swakde_update_chunk` in chunks of
    ``chunk`` rows (the last one may be shorter)."""
    for i in range(0, xs.shape[0], chunk):
        state = swakde_update_chunk(state, params, xs[i:i + chunk], cfg)
    return state


def swakde_row_estimates(state: SWAKDEState, params, q: torch.Tensor,
                         cfg: SWAKDEConfig) -> torch.Tensor:
    """Per-row EH window counts at ``q (d,)`` → (L,) float32: one gather of
    the L hit cells, queried at the clock ``t - 1``."""
    return swakde_row_estimates_from_codes(
        state, lsh.hash_points(params, q), cfg)


def swakde_row_estimates_from_codes(state: SWAKDEState, codes: torch.Tensor,
                                    cfg: SWAKDEConfig) -> torch.Tensor:
    """`swakde_row_estimates` of a point already hashed: ``codes (L,)``."""
    codes = codes.long()
    rows = torch.arange(cfg.L, device=codes.device)
    return eh_query_cells(state.ts[rows, codes], state.num[rows, codes],
                          state.t - 1, cfg.eh_config())


def swakde_query(state: SWAKDEState, params, q: torch.Tensor,
                 cfg: SWAKDEConfig) -> torch.Tensor:
    """Average of the L EH estimates at ``q (d,)`` — the paper's estimator
    Ŷ, () float32 (unnormalised window density)."""
    return mean_last(swakde_row_estimates(state, params, q, cfg))


def swakde_kde(state: SWAKDEState, params, q: torch.Tensor,
               cfg: SWAKDEConfig) -> torch.Tensor:
    """Normalised sliding-window density: Ŷ / min(t, N)."""
    denom = torch.clamp(state.t, max=cfg.window).float()
    return swakde_query(state, params, q, cfg) / torch.clamp(denom, min=1.0)


def swakde_merge(a: SWAKDEState, b: SWAKDEState,
                 cfg: SWAKDEConfig) -> SWAKDEState:
    """Combine two sketches built with identical params and a shared clock
    over different sub-streams: every cell is the `eh_merge` of its two
    inputs, expired at the query clock ``t - 1`` (expiring at ``t`` would
    drop the boundary bucket stamped ``t - window`` that queries count).
    Commutative bit for bit."""
    t = torch.maximum(a.t, b.t)
    m = eh_merge(EHState(a.ts, a.num), EHState(b.ts, b.num), t - 1,
                 cfg.eh_config())
    return SWAKDEState(ts=m.ts, num=m.num, t=t)


def swakde_grid_estimates(state: SWAKDEState, cfg: SWAKDEConfig) -> torch.Tensor:
    """EH window counts of every cell at the query clock ``t - 1`` →
    (L, W) float32."""
    return eh_query_cells(state.ts, state.num, state.t - 1, cfg.eh_config())


def swakde_row_estimates_batch(state: SWAKDEState, params, qs: torch.Tensor,
                               cfg: SWAKDEConfig) -> torch.Tensor:
    """Batched per-row EH window counts ``qs (B, d)`` → (B, L) float32: for
    B ≥ W read the full (L, W) estimate table, else query the B·L hit cells
    (bit-identical either way)."""
    codes = lsh.hash_points(params, qs).long()          # (B, L)
    rows = torch.arange(cfg.L, device=qs.device)[None, :]
    if qs.shape[0] >= cfg.W:
        return swakde_grid_estimates(state, cfg)[rows, codes]
    return eh_query_cells(state.ts[rows, codes], state.num[rows, codes],
                          state.t - 1, cfg.eh_config())


def swakde_row_estimates_from_grid(grid: torch.Tensor, params,
                                   qs: torch.Tensor, cfg: SWAKDEConfig):
    """Per-row window counts read from a precomputed ``grid (L, W)``."""
    codes = lsh.hash_points(params, qs).long()
    return grid[torch.arange(cfg.L, device=qs.device)[None, :], codes]


def swakde_query_from_grid(grid: torch.Tensor, params, qs: torch.Tensor,
                           cfg: SWAKDEConfig) -> torch.Tensor:
    """Batched Ŷ estimates from a cached grid: ``qs (B, d)`` → (B,)."""
    return mean_last(swakde_row_estimates_from_grid(grid, params, qs, cfg))


def swakde_query_batch(state: SWAKDEState, params, qs: torch.Tensor,
                       cfg: SWAKDEConfig) -> torch.Tensor:
    """Fused batch queries: ``qs (B, d) float32`` → (B,) float32."""
    return mean_last(swakde_row_estimates_batch(state, params, qs, cfg))


def swakde_bytes(cfg: SWAKDEConfig) -> int:
    """Concrete sketch footprint (for the §4 space-bound benchmarks)."""
    eh = cfg.eh_config()
    return cfg.L * cfg.W * (eh.levels * eh.slots * 8 + eh.levels * 4) + 8


# ---------------------------------------------------------------------------
# Batch-update variant (Corollary 4.2): window = last N *batches*
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchSWAKDEConfig:
    L: int
    W: int
    window: int        # N batches
    eh_eps: float
    batch_size: int    # R

    def eh_config(self) -> SumEHConfig:
        return SumEHConfig.create(self.window, self.eh_eps, self.batch_size)


class BatchSWAKDEState(NamedTuple):
    ts: torch.Tensor     # (L, W, levels, slots) int32
    num: torch.Tensor    # (L, W, levels) int32
    t: torch.Tensor      # () int32 — batch timestep


def batch_swakde_init(cfg: BatchSWAKDEConfig, device="cuda") -> BatchSWAKDEState:
    """Empty batch sketch on ``device`` (raises on ``"cuda"`` without a card)."""
    device = resolve_device(device)
    eh = cfg.eh_config().base
    return BatchSWAKDEState(
        ts=torch.full((cfg.L, cfg.W, eh.levels, eh.slots), -1, dtype=_I32,
                      device=device),
        num=torch.zeros((cfg.L, cfg.W, eh.levels), dtype=_I32, device=device),
        t=torch.zeros((), dtype=_I32, device=device))


def batch_swakde_update(state: BatchSWAKDEState, params, batch: torch.Tensor,
                        cfg: BatchSWAKDEConfig) -> BatchSWAKDEState:
    """One batch ``(R, d)`` arrives at one timestep: each cell's increment
    is the number of batch elements hashing to it (the `race_hist` kernel),
    added to every cell at once by `eh.sum_eh_add`."""
    codes = lsh.hash_points(params, batch)                   # (R, L)
    incr = kernel_ops.race_hist(codes, cfg.W)                # (L, W)
    s = sum_eh_add(SumEHState(state.ts, state.num), state.t, incr,
                   cfg.eh_config())
    return BatchSWAKDEState(ts=s.ts, num=s.num, t=saturating_add(state.t, 1))


def batch_swakde_query(state: BatchSWAKDEState, params, q: torch.Tensor,
                       cfg: BatchSWAKDEConfig) -> torch.Tensor:
    """Mean over rows of the hit cells' SumEH window counts at ``q (d,)``."""
    codes = lsh.hash_points(params, q).long()
    rows = torch.arange(cfg.L, device=q.device)
    return mean_last(eh_query_cells(state.ts[rows, codes],
                                    state.num[rows, codes], state.t - 1,
                                    cfg.eh_config().base))
