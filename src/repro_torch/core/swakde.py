"""SW-AKDE — Sliding-Window Approximate KDE (paper §4, Algorithm 2).

A RACE grid in which every cell is an Exponential Histogram: cell
(i, h_i(x)) records a 1 at the arrival timestep and a query reads the EH
estimate of the increments in the last N steps; the estimator is the row
average.  The PyTorch counterpart of the reference's ``core/swakde.py``.

Ingest is two-phase (DESIGN.md §10): `swakde_prepare_chunk` hashes the
chunk and sorts each row's codes into per-cell segments;
`swakde_commit_chunk` gathers the hit cells and runs closed-form segment
passes (the `swakde_segment_pass` kernel, DESIGN.md §12) until every
segment is drained.  Each pass ends with one ``.any()`` check on the host,
i.e. one device-to-host sync per pass.  The state is all int32 and
bit-identical to the reference's, dead ring slots included.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import lsh
from .eh import EHConfig, eh_query_cells
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
    """Commit: gather the hit cells, run `swakde_segment_pass` until every
    segment is drained (one host check of ``done < seg_len`` per pass), and
    write the cells back.  ``count`` (optional) overrides the clock advance
    (default C), for a prefix-masked prepare."""
    eh = cfg.eh_config()
    L, C = prep.order.shape
    sorted_ts = saturating_add(state.t, prep.order)              # (L, C)
    gcode = torch.clamp(prep.seg_code, max=cfg.W - 1).long()     # clamp padding
    rows = torch.arange(L, device=sorted_ts.device)[:, None]
    cell_ts = state.ts[rows, gcode].contiguous()                 # (L, SW, lv, S)
    cell_num = state.num[rows, gcode].contiguous()               # (L, SW, lv)
    done = torch.zeros_like(prep.seg_len)
    while bool((done < prep.seg_len).any()):
        cell_ts, cell_num, done = kernel_ops.swakde_segment_pass(
            cell_ts, cell_num, done, sorted_ts, prep.seg_first, prep.seg_len,
            window=cfg.window, maxb=eh.max_buckets_per_level,
            n_levels=eh.levels, cap=cfg.heavy_cell_cap)
    # Write back; sentinel segments (code W) are dropped via a spare cell.
    ts = torch.cat([state.ts, state.ts[:, :1]], dim=1)
    num = torch.cat([state.num, state.num[:, :1]], dim=1)
    code = prep.seg_code.long()
    ts[rows, code] = cell_ts
    num[rows, code] = cell_num
    return SWAKDEState(ts=ts[:, :cfg.W].contiguous(),
                       num=num[:, :cfg.W].contiguous(),
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
