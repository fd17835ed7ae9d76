"""Multi-tenant sketch fleets: stacked states and tenant-routed ingest.

The PyTorch counterpart of the reference's ``core/fleet.py``.  A fleet is T
independent sketches of one kind sharing one set of LSH params, stored as
ONE stacked state whose every leaf gains a leading ``[T]`` tenant axis
(``RACEState.counts`` becomes ``(T, L, W)``, and so on).  Ingest takes one
*mixed* chunk ``xs (B, d)`` tagged with per-point tenant slots
``tids (B,)``:

  1. hash the whole mixed chunk once (the params are the fleet's);
  2. route: a stable sort by tenant slot (`route_chunk`) gathers each
     tenant's points into a cap-padded ``(T, cap)`` block, in stream order;
  3. commit every tenant at once.  The reference vmaps the single-sketch
     prepare/commit over the tenant axis; here the tenant axis is folded
     into the sketch's row axis instead, so a fleet chunk is one launch of
     each kernel whatever T is:

     * RACE: one `race_hist` launch on tenant-offset codes
       (``slot * W + code`` over ``T * W`` bins, dropped slots out of
       range), transposed to ``(T, L, W)`` and added — integer adds, so
       bit-identical to the reference's fused scatter-add;
     * SW-AKDE: one prepare over ``(T * L, cap)`` rows and ONE
       `swakde_segment_commit` launch on the grid viewed as
       ``(T * L, W, levels, slots)``, each row timestamped from its own
       tenant's clock;
     * S-ANN: per-tenant keep draws (one vectorised threefry pass), one
       append sort keyed on ``(t * L + l, code)``, point and stamp scatters
       into the ``(T, capacity, d)`` store and ONE `sann_table_commit`
       launch with per-tenant ``write_ptr`` / ``n_kept``.

The padding contracts of the reference hold at ``T * L`` rows: a tenant's
real points are a *prefix* of its block; S-ANN pads get ``keep=False`` (the
prefix-stable `sann_row_keys` schedule means pad draws never perturb the
real ones); SW-AKDE pads take the sentinel code ``W`` and their segments
are zeroed; every clock advances by the tenant's *real* count.  So every
tenant row is bit-identical to the single sketch fed its own sub-stream.

Queries gather per-request tenant rows and run the fused batch engines once
for the whole mixed batch; the S-ANN scorers read the stacked point store
viewed as ``(T * capacity, d)`` through the `batch_score_topk` kernel's
gather entry, with each request's slot ids offset by ``t * capacity``.

Every fleet function returns new tensors; none modifies its input.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from . import lsh, prng
from .eh import eh_query_cells
from .race import RACEState, estimate_from_vals
from .sann import (SANNConfig, SANNResult, SANNState,
                   _first_occurrence_mask, sann_score_candidates_batch)
from .swakde import SWAKDEConfig, SWAKDEState, swakde_prepare_from_codes
from .util import mean_last, saturating_add, set_drop
from ..kernels import ops as kernel_ops

_I32 = torch.int32


# --------------------------------------------------------------------------
# stacked-state helpers
# --------------------------------------------------------------------------

def fleet_stack(states: Sequence):
    """Stack identically-shaped sketch states into one fleet (every leaf
    gains a leading ``[T]`` axis)."""
    return type(states[0])(*(torch.stack(leaves) for leaves in zip(*states)))


def fleet_row(stacked, i: int):
    """Tenant row ``i`` as a plain single-sketch state (views of the
    stacked leaves)."""
    return type(stacked)(*(x[i] for x in stacked))


def fleet_set_row(stacked, i: int, row):
    """A new fleet with tenant row ``i`` replaced by ``row`` (the input is
    not modified)."""
    out = []
    for x, r in zip(stacked, row):
        x = x.clone()
        x[i] = r
        out.append(x)
    return type(stacked)(*out)


def fleet_broadcast(state, T: int):
    """A fleet of ``T`` copies of ``state`` (e.g. T empty sketches)."""
    return type(state)(*(x[None].expand((T,) + tuple(x.shape)).clone()
                         for x in state))


# --------------------------------------------------------------------------
# tenant routing
# --------------------------------------------------------------------------

class FleetRoute(NamedTuple):
    """Gather plan for one mixed chunk: tenant slot t's points are chunk
    rows ``take[t, :counts[t]]`` in stream order; columns >= counts[t] are
    arbitrary in-bounds pads flagged False in ``valid``."""
    take: torch.Tensor    # (T, cap) int64 — chunk row index per padded block
    valid: torch.Tensor   # (T, cap) bool  — prefix mask: col < counts[t]
    counts: torch.Tensor  # (T,) int32     — real points per tenant slot


def _slots(tids: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Tenant slots as int64, ids outside ``[0, num_slots)`` sent to
    ``num_slots`` (dropped)."""
    tids = tids.long()
    return torch.where((tids >= 0) & (tids < num_slots), tids, num_slots)


def _slot_counts(slot: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Real points per slot (dropped ids ignored) → ``(num_slots,) int32``,
    with no host wait (an index add, not `torch.bincount`)."""
    counts = torch.zeros(num_slots + 1, dtype=_I32, device=slot.device)
    counts.index_add_(0, slot, torch.ones_like(slot, dtype=_I32))
    return counts[:num_slots]


def route_chunk(tids: torch.Tensor, num_slots: int, cap: int) -> FleetRoute:
    """Sort/segment a mixed chunk by tenant slot.

    ``tids (B,)`` holds per-point tenant slots; ids outside
    ``[0, num_slots)`` (use -1) are dropped.  ``cap`` bounds the per-slot
    count — the caller guarantees every slot receives <= cap points (the
    serve layer splits oversized chunks; `serve.tenant_fleet`).  One stable
    argsort by slot groups each tenant's points contiguously in stream
    order; an exclusive cumsum of the per-slot counts locates each group's
    start."""
    B = tids.shape[0]
    dev = tids.device
    slot = _slots(tids, num_slots)
    order = torch.sort(slot, stable=True).indices                # (B,)
    counts = _slot_counts(slot, num_slots)
    starts = torch.cumsum(counts, 0) - counts                    # exclusive
    col = torch.arange(cap, dtype=torch.int64, device=dev)
    idx = starts.long()[:, None] + col[None, :]
    take = order[idx.clamp(0, max(B - 1, 0))]
    valid = col[None, :] < counts[:, None]
    return FleetRoute(take=take, valid=valid, counts=counts)


# --------------------------------------------------------------------------
# RACE fleet
# --------------------------------------------------------------------------

def race_fleet_ingest(stacked: RACEState, params, xs: torch.Tensor,
                      tids: torch.Tensor,
                      codes: Optional[torch.Tensor] = None) -> RACEState:
    """Tenant-routed RACE ingest: stacked ``counts (T, L, W)``, one mixed
    chunk, one `race_hist` launch.

    Each point's code in row l moves to bin ``slot * W + code`` of a
    ``T * W``-bin histogram (a dropped slot lands past the last bin, which
    `race_hist` ignores); the ``(L, T, W)`` histogram is added to the
    counters tenant-major.  Integer adds are exact and order-free, so this
    is bit-identical to the per-tenant prepare/commit loop.  ``codes
    (B, L) int32`` (optional) skips the hash, as in every fleet ingest."""
    T, L, W = stacked.counts.shape
    if codes is None:
        codes = lsh.hash_points(params, xs)                      # (B, L)
    slot = _slots(tids, T)
    off = (slot[:, None] * W + codes.long()).to(_I32)
    hist = kernel_ops.race_hist(off.contiguous(), T * W)         # (L, T*W)
    counts = stacked.counts + hist.view(L, T, W).transpose(0, 1)
    return RACEState(counts=counts,
                     n=saturating_add(stacked.n, _slot_counts(slot, T)))


def race_fleet_row_reads(stacked: RACEState, params, qs: torch.Tensor,
                         tids: torch.Tensor) -> torch.Tensor:
    """Per-request row reads from the stacked fleet: ``qs (B, d)``,
    ``tids (B,)`` → (B, L) float32 (one hash, one tenant-indexed gather)."""
    codes = lsh.hash_points(params, qs).long()                   # (B, L)
    L = codes.shape[-1]
    t = tids.long().clamp(0, stacked.counts.shape[0] - 1)
    rows = torch.arange(L, device=codes.device)[None, :]
    return stacked.counts[t[:, None], rows, codes].float()


def race_fleet_query(stacked: RACEState, params, qs: torch.Tensor,
                     tids: torch.Tensor, median_of_means: int = 0):
    """Batched per-tenant RACE estimates: (B,) float32, bit-identical to
    `race_query_batch` against each request's own sketch."""
    return estimate_from_vals(race_fleet_row_reads(stacked, params, qs, tids),
                              median_of_means)


def race_fleet_kde(stacked: RACEState, params, qs: torch.Tensor,
                   tids: torch.Tensor, median_of_means: int = 0):
    """Normalised per-tenant KDE reads (`race_kde` with a tenant axis)."""
    est = race_fleet_query(stacked, params, qs, tids, median_of_means)
    t = tids.long().clamp(0, stacked.n.shape[0] - 1)
    return est / torch.clamp(stacked.n[t], min=1).float()


# --------------------------------------------------------------------------
# SW-AKDE fleet
# --------------------------------------------------------------------------

def swakde_fleet_ingest(stacked: SWAKDEState, params, xs: torch.Tensor,
                        tids: torch.Tensor, cfg: SWAKDEConfig, cap: int,
                        codes: Optional[torch.Tensor] = None) -> SWAKDEState:
    """Tenant-routed SW-AKDE ingest: hash the mixed chunk once, route the
    codes (`route_chunk`), prepare all ``T * L`` rows at once (pads at the
    sentinel code W, so their segments carry no mass) and commit them in
    one `swakde_segment_commit` launch on the grid viewed as
    ``(T * L, W, levels, slots)``.  Row ``t * L + l`` is timestamped from
    tenant t's clock, and each clock advances by its real count.
    Bit-identical to the per-tenant `swakde_update_chunk` loop."""
    T = stacked.t.shape[0]
    L, W = cfg.L, cfg.W
    if codes is None:
        codes = lsh.hash_points(params, xs)                      # (B, L)
    route = route_chunk(tids, T, cap)
    codes_t = torch.where(route.valid[:, :, None], codes[route.take], W)
    rows = codes_t.transpose(1, 2).reshape(T * L, cap)           # (T*L, cap)
    prep = swakde_prepare_from_codes(rows.t(), cfg)
    eh = cfg.eh_config()
    sorted_ts = saturating_add(stacked.t.repeat_interleave(L)[:, None],
                               prep.order)                       # (T*L, cap)
    shape = stacked.ts.shape
    ts, num = kernel_ops.swakde_segment_commit(
        stacked.ts.reshape((T * L,) + tuple(shape[2:])).contiguous(),
        stacked.num.reshape(T * L, W, -1).contiguous(), sorted_ts,
        prep.seg_code, prep.seg_first, prep.seg_len, window=cfg.window,
        maxb=eh.max_buckets_per_level, n_levels=eh.levels,
        cap=cfg.heavy_cell_cap)
    return SWAKDEState(ts=ts.view(shape), num=num.view(stacked.num.shape),
                       t=saturating_add(stacked.t, route.counts))


def swakde_fleet_grid(stacked: SWAKDEState, cfg: SWAKDEConfig) -> torch.Tensor:
    """Window-count estimate tables for every tenant: (T, L, W) float32,
    each tenant expiring at its own clock."""
    return eh_query_cells(stacked.ts, stacked.num, stacked.t - 1,
                          cfg.eh_config())


def swakde_fleet_row_estimates(stacked: SWAKDEState, params, qs: torch.Tensor,
                               tids: torch.Tensor,
                               cfg: SWAKDEConfig) -> torch.Tensor:
    """Per-request EH row estimates from the stacked fleet: (B, L) float32 —
    one hash, one tenant-indexed cell gather, one `eh_query_cells` at each
    request's own tenant clock; bit-identical to
    `swakde_row_estimates_batch` against the request's own sketch."""
    codes = lsh.hash_points(params, qs).long()                   # (B, L)
    L = codes.shape[-1]
    t = tids.long().clamp(0, stacked.t.shape[0] - 1)
    rows = torch.arange(L, device=codes.device)[None, :]
    cell_ts = stacked.ts[t[:, None], rows, codes]    # (B, L, levels, slots)
    cell_num = stacked.num[t[:, None], rows, codes]  # (B, L, levels)
    return eh_query_cells(cell_ts, cell_num, stacked.t[t] - 1,
                          cfg.eh_config())


def swakde_fleet_query(stacked: SWAKDEState, params, qs: torch.Tensor,
                       tids: torch.Tensor, cfg: SWAKDEConfig) -> torch.Tensor:
    """Batched per-tenant Ŷ estimates: (B,) float32, bit-identical to
    `swakde_query_batch` against each request's own sketch."""
    return mean_last(swakde_fleet_row_estimates(stacked, params, qs, tids,
                                                cfg))


def swakde_fleet_kde(stacked: SWAKDEState, params, qs: torch.Tensor,
                     tids: torch.Tensor, cfg: SWAKDEConfig) -> torch.Tensor:
    """Normalised per-tenant window densities (`swakde_kde` + tenant axis)."""
    est = swakde_fleet_query(stacked, params, qs, tids, cfg)
    t = tids.long().clamp(0, stacked.t.shape[0] - 1)
    denom = torch.clamp(stacked.t[t], max=cfg.window).float()
    return est / torch.clamp(denom, min=1.0)


# --------------------------------------------------------------------------
# S-ANN fleet
# --------------------------------------------------------------------------

def sann_fleet_keys(chunk_key: torch.Tensor, exts: torch.Tensor) -> torch.Tensor:
    """Per-tenant keys of one fleet operation: ``fold_in(chunk_key, ext)``
    for each slot's external tenant id ``exts (T,)`` → ``(T, 2)``."""
    return prng.fold_in(chunk_key, exts.long())


def sann_fleet_ingest(stacked: SANNState, params, xs: torch.Tensor,
                      tids: torch.Tensor, keys: torch.Tensor, cfg: SANNConfig,
                      cap: int,
                      codes: Optional[torch.Tensor] = None) -> SANNState:
    """Tenant-routed S-ANN ingest: hash once, route points and codes, and
    commit every tenant at once.

    ``keys (T, 2)`` holds one key per tenant slot.  Point i of tenant t's
    block is kept under ``bernoulli(fold_in(keys[t], i))`` — the
    prefix-stable `sann_row_keys` schedule, drawn for all T blocks in one
    pass, pads masked to ``keep=False``.  The append sort keys on
    ``((t * L + l) * n_buckets + code, point)``, so each tenant's segments
    are its own single-sketch segments; points and stamps scatter into the
    ``(T, capacity, ...)`` stores and the tables commit in one
    `sann_table_commit` launch with per-tenant ``write_ptr`` / ``n_kept``.
    ``n_seen`` advances by the real counts.  Every tenant row is
    bit-identical to the single sketch ingesting its own sub-stream under
    its key."""
    T, capacity, d = stacked.points.shape
    L, NB, bc = cfg.L, cfg.n_buckets, cfg.bucket_cap
    dev = xs.device
    if codes is None:
        codes = lsh.hash_points(params, xs)                      # (B, L)
    route = route_chunk(tids, T, cap)
    xs_t = xs[route.take]                                        # (T, cap, d)
    codes_t = codes[route.take]                                  # (T, cap, L)
    col = torch.arange(cap, dtype=torch.int64, device=dev)
    keep = prng.bernoulli(prng.fold_in(keys[:, None, :].to(dev), col[None, :]),
                          cfg.keep_prob) & route.valid           # (T, cap)

    # --- slot ranks per tenant -------------------------------------------
    kept_rank = (torch.cumsum(keep, 1) - keep.long()).to(_I32)  # exclusive
    n_kept = keep.sum(1).to(_I32)                                # (T,)
    winner = keep & (kept_rank >= (n_kept - capacity)[:, None])

    # --- the append sort over all tenants' (row, code) buckets -----------
    t_idx = torch.arange(T, dtype=torch.int64, device=dev)
    row = (t_idx[:, None, None] * L
           + torch.arange(L, dtype=torch.int64, device=dev)[None, None, :])
    bucket_key = (row * NB + codes_t.long()).reshape(-1)         # (T*cap*L,)
    n_pts = T * cap
    n_flat = n_pts * L
    sentinel = T * L * NB
    kept_flat = keep.reshape(n_pts, 1).expand(n_pts, L).reshape(-1)
    flat_p = torch.arange(n_pts, dtype=torch.int64, device=dev)[:, None] \
        .expand(n_pts, L).reshape(-1)
    masked_key = torch.where(kept_flat, bucket_key, sentinel)
    # (bucket key, point) packed into one int64: kept keys are unique, so a
    # plain sort gives the stable order of each tenant's own sort.
    packed = torch.sort(masked_key * n_pts + flat_p).values
    s_key = packed // n_pts
    s_p = packed % n_pts
    s_kept = s_key < sentinel
    pos_idx = torch.arange(n_flat, dtype=torch.int64, device=dev)
    seg_start = torch.ones(n_flat, dtype=torch.bool, device=dev)
    seg_start[1:] = s_key[1:] != s_key[:-1]
    rank = pos_idx - torch.cummax(torch.where(seg_start, pos_idx, 0), 0).values
    s_l = torch.clamp(s_key // NB, max=T * L - 1)                # clamp sentinel
    s_c = s_key % NB
    counts = torch.zeros(T * L * NB, dtype=_I32, device=dev)
    counts.index_add_(0, bucket_key, kept_flat.to(_I32))
    seg_total = counts[s_l * NB + s_c]
    entry_win = s_kept & (rank >= seg_total - bc)

    # --- commit: rebase on each tenant's pointers -------------------------
    slot = (stacked.write_ptr[:, None] + kept_rank) % capacity   # (T, cap)
    base = (t_idx * capacity)[:, None]
    win_flat = torch.where(winner, slot.long() + base, T * capacity)
    points = set_drop(stacked.points.reshape(T * capacity, d),
                      win_flat.reshape(-1), xs_t.reshape(n_pts, d))
    ring_off = (torch.arange(capacity, dtype=_I32, device=dev)[None, :]
                - stacked.write_ptr[:, None]) % capacity
    valid = stacked.valid | (ring_off < n_kept[:, None])
    val = torch.where(winner.reshape(-1)[s_p], slot.reshape(-1)[s_p],
                      -1).to(_I32)
    tables = kernel_ops.sann_table_commit(
        stacked.tables.reshape(T * L, NB, bc),
        stacked.table_ptr.reshape(T * L, NB), s_l.to(_I32), s_c.to(_I32),
        rank.to(_I32), val, entry_win, stacked.write_ptr, n_kept, capacity,
        rows_per_tenant=L)
    arrival = saturating_add(stacked.n_seen[:, None],
                             col.to(_I32)[None, :])              # (T, cap)
    stamps = set_drop(stacked.stamps.reshape(-1), win_flat.reshape(-1),
                      arrival.reshape(-1))
    old_valid = stacked.valid.reshape(-1)[
        torch.where(winner, slot.long() + base, 0)]
    newly = winner & ~old_valid
    return SANNState(
        points=points.view(T, capacity, d), valid=valid,
        write_ptr=(stacked.write_ptr + n_kept) % capacity,
        n_seen=saturating_add(stacked.n_seen, route.counts),
        n_stored=(stacked.n_stored + newly.sum(1)).to(_I32),
        tables=tables.view(T, L, NB, bc),
        table_ptr=stacked.table_ptr + counts.view(T, L, NB),
        stamps=stamps.view(T, capacity))


def _stacked_rows(stacked: SANNState):
    """The stacked point store as ``(T * capacity, d)`` for the scorer's
    gather entry, whose 64-bit row arithmetic takes any size, and whose ids
    are int32: the store must hold fewer than 2**31 rows."""
    T, capacity, d = stacked.points.shape
    if T * capacity >= 2**31:
        raise ValueError(f"S-ANN fleet of {T} x {capacity} slots: the "
                         "scorer's slot ids are int32 (< 2**31 rows)")
    return stacked.points.reshape(T * capacity, d), capacity


def sann_fleet_candidates(stacked: SANNState, params, qs: torch.Tensor,
                          tids: torch.Tensor, cfg: SANNConfig):
    """Per-request bucket candidates from the stacked fleet: one hash and
    one tenant-indexed table gather → ``(cand, ok, t)`` with the row-major
    (L, bucket_cap) column order of `sann_bucket_candidates_batch` on the
    request's own sketch (``t`` the clamped tenant slots, int64)."""
    codes = lsh.hash_points(params, qs).long()                   # (B, L)
    t = tids.long().clamp(0, stacked.n_seen.shape[0] - 1)
    rows = torch.arange(cfg.L, device=qs.device)[None, :]
    cand = stacked.tables[t[:, None], rows, codes]
    cand = cand.reshape(qs.shape[0], cfg.L * cfg.bucket_cap)
    ok = (cand >= 0) & stacked.valid[t[:, None], cand.clamp(min=0).long()]
    return cand, ok, t


def sann_fleet_query_topk(stacked: SANNState, params, qs: torch.Tensor,
                          tids: torch.Tensor, cfg: SANNConfig, topk: int = 50):
    """Batched per-tenant top-k: ``(ids (B, k), dists (B, k))`` with the
    `sann_query_topk_batch` padding/ordering contract, against each
    request's own tenant row (slot ids index that row).  One scorer call on
    the stacked store, each request's ids offset by ``t * capacity``."""
    points, capacity = _stacked_rows(stacked)
    cand, ok, t = sann_fleet_candidates(stacked, params, qs, tids, cfg)
    mask = ok & _first_occurrence_mask(cand, capacity)
    k = min(topk, cand.shape[1])
    glob = (cand.clamp(min=0) + (t * capacity)[:, None]).to(_I32)
    d2, idx = kernel_ops.batch_score_topk_gather(qs, points, glob, mask, k)
    ids = torch.where(torch.isfinite(d2), torch.gather(cand, 1, idx.long()),
                      -1)
    return ids, torch.sqrt(d2)


def sann_fleet_query(stacked: SANNState, params, qs: torch.Tensor,
                     tids: torch.Tensor, cfg: SANNConfig) -> SANNResult:
    """Batched per-tenant (c, r)-NN queries → `SANNResult` with (B,)
    fields, as `sann_query_batch` per request: `sann_score_candidates_batch`
    (the 3L truncation, one scorer call) on the stacked store, each
    request's slot ids offset into it and the answer's id taken back to its
    tenant's row."""
    points, capacity = _stacked_rows(stacked)
    cand, ok, t = sann_fleet_candidates(stacked, params, qs, tids, cfg)
    off = (t * capacity)[:, None]
    res = sann_score_candidates_batch(
        points, torch.where(cand >= 0, cand + off, -1).to(_I32), ok, qs,
        3 * cfg.L, cfg)
    return res._replace(index=torch.where(res.found, res.index - off[:, 0],
                                          -1).to(_I32))
