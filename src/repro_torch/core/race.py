"""RACE — Repeated Array-of-Counts Estimator [CS20] (paper §2.3).

The sketch is an (L, W) int32 counter grid; row i is an ACE indexed by an
independent LSH function h_i, so ``E[A[i, h_i(q)]] = sum_x k^p(x, q)``
(Theorem 2.3).  Turnstile: deletions decrement counters.

Ingest is two-phase (prepare: hash + histogram through the `race_hist`
kernel; commit: one dense add).  Counters are bit-identical to the
reference's ``core/race.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import lsh
from .util import mean_last, resolve_device, saturating_add
from ..kernels import ops as kernel_ops


class RACEState(NamedTuple):
    counts: torch.Tensor   # (L, W) int32
    n: torch.Tensor        # () int32 — signed stream size, saturating


def race_init(L: int, W: int, device="cuda") -> RACEState:
    """Zero sketch: ``counts (L, W) int32``, ``n () int32`` on ``device``
    (raises on ``"cuda"`` without a card)."""
    device = resolve_device(device)
    return RACEState(counts=torch.zeros((L, W), dtype=torch.int32, device=device),
                     n=torch.zeros((), dtype=torch.int32, device=device))


def race_merge(a: RACEState, b: RACEState) -> RACEState:
    """Combine two sketches built with identical params over different
    streams: counters sum exactly; ``n`` saturates."""
    return RACEState(counts=a.counts + b.counts, n=saturating_add(a.n, b.n))


class RACEPrep(NamedTuple):
    """The state-independent half of a chunk update (DESIGN.md §10)."""
    hist: torch.Tensor    # (L, W) int32 — per-chunk bucket histogram
    count: int            # chunk size B


def race_prepare_chunk(params, xs: torch.Tensor, n_buckets: int) -> RACEPrep:
    """Prepare: hash ``xs (B, d)`` (one matmul) and histogram the codes
    (`kernels.ops.race_hist`)."""
    codes = lsh.hash_points(params, xs)                      # (B, L)
    return RACEPrep(hist=kernel_ops.race_hist(codes, n_buckets),
                    count=xs.shape[0])


def race_commit_chunk(state: RACEState, prep: RACEPrep,
                      sign: int = 1) -> RACEState:
    """Commit: fold a prepared chunk into the counters (one dense add)."""
    return RACEState(counts=state.counts + sign * prep.hist,
                     n=saturating_add(state.n, sign * prep.count))


def race_update_batch(state: RACEState, params, xs: torch.Tensor,
                      sign: int = 1) -> RACEState:
    """Batched turnstile update of ``xs (B, d)``: prepare then commit."""
    prep = race_prepare_chunk(params, xs, state.counts.shape[1])
    return race_commit_chunk(state, prep, sign)


def estimate_from_vals(vals: torch.Tensor, median_of_means: int = 0):
    """Reduce per-row counter reads ``vals (..., L) float32`` to the RACE
    estimate: mean over rows, or median-of-means with ``median_of_means``
    groups.  The median of an even count is the midpoint of the two middle
    values, ``(lo + hi) * 0.5``, as ``jnp.median`` computes it
    (``torch.median`` would return the lower one)."""
    if median_of_means and median_of_means > 1:
        g = median_of_means
        L = vals.shape[-1]
        usable = (L // g) * g
        means = mean_last(
            vals[..., :usable].reshape(*vals.shape[:-1], g, usable // g))
        s = torch.sort(means, dim=-1).values
        return (s[..., (g - 1) // 2] + s[..., g // 2]) * 0.5
    return mean_last(vals)


def race_row_reads(state: RACEState, params, qs: torch.Tensor) -> torch.Tensor:
    """Batched per-row counter reads: ``qs (B, d)`` → (B, L) float32."""
    codes = lsh.hash_points(params, qs)                      # (B, L)
    L = state.counts.shape[0]
    rows = torch.arange(L, device=codes.device)[None, :]
    return state.counts[rows, codes.long()].float()


def race_query_batch(state: RACEState, params, qs: torch.Tensor,
                     median_of_means: int = 0) -> torch.Tensor:
    """Fused batch queries: ``qs (B, d) float32`` → (B,) float32."""
    return estimate_from_vals(race_row_reads(state, params, qs),
                              median_of_means)
