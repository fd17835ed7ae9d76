"""Exponential Histograms [DGIM02] in fixed-shape tensors (paper §2.4).

The SW-AKDE cell: DGIM's linked-list buckets are a dense
``ts[levels, slots]`` ring of timestamps (newest-first per level) plus
per-level live counts ``num[levels]``.  This slice ports the configuration
and the query side; ingest runs through the closed-form segment pass
(`kernels.ops.swakde_segment_pass`).  All timestamps are int32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class EHConfig:
    window: int          # N — sliding-window length (timesteps)
    k: int               # ceil(1/eps'): max k/2+1 buckets per level
    levels: int          # number of size levels (2^0 .. 2^{levels-1})
    slots: int           # per-level ring capacity = k//2 + 2

    @staticmethod
    def create(window: int, eps: float) -> "EHConfig":
        k = max(2, math.ceil(1.0 / eps))
        levels = math.ceil(math.log2(max(window, 2))) + 2
        return EHConfig(window=window, k=k, levels=levels, slots=k // 2 + 2)

    @property
    def max_buckets_per_level(self) -> int:
        return self.k // 2 + 1


class EHState(NamedTuple):
    ts: torch.Tensor    # (levels, slots) int32 — bucket timestamps, newest-first
    num: torch.Tensor   # (levels,) int32 — live buckets per level


def eh_query_cells(ts: torch.Tensor, num: torch.Tensor, t,
                   cfg: EHConfig) -> torch.Tensor:
    """DGIM estimate TOTAL - LAST/2 of #1s in (t - window, t] for a batch of
    cells: ``ts (..., levels, slots)``, ``num (..., levels)`` → ``(...)``
    float32, bit-identical per cell to the reference's `eh_query_cells`."""
    dev = ts.device
    idx = torch.arange(cfg.slots, device=dev)
    live = (idx < num[..., None]) & (ts > t - cfg.window)
    sizes = (1 << torch.arange(cfg.levels, dtype=torch.int32, device=dev))[:, None]
    total = torch.where(live, sizes, 0).sum(dim=(-2, -1))
    # Oldest live bucket = the live bucket at the highest level.
    has = live.any(dim=-1)
    lvl = torch.arange(cfg.levels, device=dev)
    last_level = torch.where(has, lvl, -1).amax(dim=-1)
    last = torch.where(last_level >= 0, 1 << last_level.clamp(min=0), 0)
    est = total - last // 2
    return torch.clamp(est, min=0).float()


def eh_query(state: EHState, t, cfg: EHConfig) -> torch.Tensor:
    """DGIM estimate of #1s in (t - window, t] for one cell."""
    return eh_query_cells(state.ts, state.num, t, cfg)
