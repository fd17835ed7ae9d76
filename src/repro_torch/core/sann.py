"""S-ANN — Streaming (c,r)-Approximate Near Neighbor sketch (paper §3, Alg. 1).

The PyTorch counterpart of the reference's ``core/sann.py``: each arriving
point is kept with probability n^-eta, stored in a ring of ``capacity``
slots, and appended to L p-stable hash tables whose buckets are rings of
``bucket_cap`` slot ids.  A query scores the union of its L buckets.

Ingest is two-phase (DESIGN.md §10): `sann_prepare_chunk` is the pure half
(keep decisions, prefix ranks, hashing, the sort-by-(row, code) append
structure) and `sann_commit_chunk` rebases it on the live pointers, with
the ring appends done by the `sann_table_scatter` kernel.  Queries run the
fused batch engine (§9) with the `batch_score_topk` kernel.  Given the same
keep decisions and codes, every integer leaf of the state is bit-identical
to the reference's.

Random numbers: the reference draws each keep decision with threefry
``fold_in(key, i)`` + ``bernoulli`` (a prefix-stable per-point schedule).
The port draws ``torch.rand(B, generator=g) < keep_prob`` and does not try
to reproduce JAX's bits; parity tests inject the reference's keep mask
through `sann_prepare_given_keep`.  This draw depends on the chunk length,
so the tenant fleets of a later slice will need a prefix-stable schedule of
their own.

Commits never modify their input state: the tombstone pass makes a new
tables tensor and the ring append writes into it in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from . import lsh, theory
from .util import resolve_device, saturating_add, set_drop
from ..kernels import ops as kernel_ops

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class SANNConfig:
    dim: int
    n_max: int             # upper bound on stream size (paper's n)
    eta: float             # sampling exponent: keep prob = n^-eta
    r: float               # near radius
    c: float               # approximation factor (far radius = c*r)
    w: float = 4.0         # p-stable bucket width
    L: Optional[int] = None
    k: Optional[int] = None
    bucket_cap: int = 16
    capacity_slack: float = 4.0

    def resolved(self) -> "SANNConfig":
        p1 = float(theory.pstable_p(self.r, self.w))
        p2 = float(theory.pstable_p(self.c * self.r, self.w))
        k = self.k or max(1, math.ceil(math.log(self.n_max) / math.log(1.0 / p2)))
        rho = math.log(1.0 / p1) / math.log(1.0 / p2)
        L = self.L or max(1, math.ceil(self.n_max**rho / p1))
        return dataclasses.replace(self, L=L, k=k)

    @property
    def keep_prob(self) -> float:
        return self.n_max ** (-self.eta)

    @property
    def capacity(self) -> int:
        """Point-store size: E[stored] = n^{1-eta}, padded by slack."""
        expect = self.n_max ** (1.0 - self.eta)
        return max(64, int(self.capacity_slack * expect))

    @property
    def n_buckets(self) -> int:
        return max(64, int(4 * self.capacity))


class SANNState(NamedTuple):
    points: torch.Tensor     # (capacity, dim) float32
    valid: torch.Tensor      # (capacity,) bool
    write_ptr: torch.Tensor  # () int32 slot pointer, kept reduced mod capacity
    n_seen: torch.Tensor     # () int32, saturating
    n_stored: torch.Tensor   # () int32 — live stored points (== valid.sum())
    tables: torch.Tensor     # (L, n_buckets, bucket_cap) int32 slot ids, -1 empty
    table_ptr: torch.Tensor  # (L, n_buckets) int32 cyclic bucket pointers
    stamps: torch.Tensor     # (capacity,) int32 logical arrival time, -1 unwritten


def sann_empty_state(cfg: SANNConfig, device="cuda") -> SANNState:
    """Allocate an empty sketch for a *resolved* config on ``device``."""
    device = resolve_device(device)
    z = torch.zeros((), dtype=_I32, device=device)
    return SANNState(
        points=torch.zeros((cfg.capacity, cfg.dim), dtype=torch.float32,
                           device=device),
        valid=torch.zeros((cfg.capacity,), dtype=torch.bool, device=device),
        write_ptr=z, n_seen=z.clone(), n_stored=z.clone(),
        tables=torch.full((cfg.L, cfg.n_buckets, cfg.bucket_cap), -1,
                          dtype=_I32, device=device),
        table_ptr=torch.zeros((cfg.L, cfg.n_buckets), dtype=_I32, device=device),
        stamps=torch.full((cfg.capacity,), -1, dtype=_I32, device=device),
    )


def sann_init(cfg: SANNConfig, generator: torch.Generator, device="cuda"):
    """Resolve the config, draw p-stable params from ``generator`` and
    allocate an empty sketch on ``device`` (default the card; raises without
    one).  Returns ``(resolved cfg, lsh.PStableParams, SANNState)``."""
    device = resolve_device(device)
    cfg = cfg.resolved()
    params = lsh.init_pstable(generator, cfg.dim, cfg.L, cfg.k, cfg.w,
                              cfg.n_buckets, device=device)
    return cfg, params, sann_empty_state(cfg, device)


class SANNPrep(NamedTuple):
    """Pure per-chunk precomputation (the prepare phase): depends only on
    (params, chunk, keep decisions), never on sketch state."""
    xs: torch.Tensor          # (B, d) float32 — the chunk
    keep: torch.Tensor        # (B,) bool — Bernoulli keep decisions
    kept_rank: torch.Tensor   # (B,) int32 — exclusive prefix sum over keep
    n_kept: torch.Tensor      # () int32
    winner: torch.Tensor      # (B,) bool — keep & survives intra-chunk ring lap
    s_l: torch.Tensor         # (B*L,) int32 — sorted append rows
    s_c: torch.Tensor         # (B*L,) int32 — sorted append codes
    s_b: torch.Tensor         # (B*L,) int32 — sorted append point index
    rank: torch.Tensor        # (B*L,) int32 — within-bucket append rank
    entry_win: torch.Tensor   # (B*L,) bool — append survives the ring cap
    counts: torch.Tensor      # (L, n_buckets) int32 — per-bucket append counts


def sann_prepare_chunk(params, xs: torch.Tensor, generator: torch.Generator,
                       cfg: SANNConfig) -> SANNPrep:
    """Prepare ``xs (B, d)``: draw the keep decisions from ``generator``
    (on its own device), then `sann_prepare_given_keep`."""
    u = torch.rand(xs.shape[0], generator=generator, device=generator.device)
    keep = (u < cfg.keep_prob).to(xs.device)
    return sann_prepare_given_keep(params, xs, keep, cfg)


def sann_prepare_given_keep(params, xs: torch.Tensor, keep: torch.Tensor,
                            cfg: SANNConfig,
                            codes: Optional[torch.Tensor] = None) -> SANNPrep:
    """`sann_prepare_chunk` with the keep mask supplied by the caller:
    prefix ranks, the last-writer mask, one hash matmul (skipped when
    ``codes (B, L) int32`` is given) and the sort-by-(row, code) append
    structure."""
    B = xs.shape[0]
    cap = cfg.capacity
    dev = xs.device
    keep = keep.to(torch.bool)

    # --- slot ranks: prefix sum over kept points ---------------------------
    kept_rank = (torch.cumsum(keep, 0) - keep.long()).to(_I32)   # exclusive
    n_kept = keep.sum().to(_I32)
    # Last writer per slot wins: the shadowed writers are the kept points
    # more than one full lap from the chunk's end.
    winner = keep & (kept_rank >= n_kept - cap)

    # --- ring-buffer appends: sort-by-(row, code) segment structure --------
    if codes is None:
        codes = lsh.hash_points(params, xs)                  # (B, L)
    L, NB = cfg.L, cfg.n_buckets
    l_idx = torch.arange(L, dtype=torch.int64, device=dev).expand(B, L)
    bucket_key = l_idx * NB + codes.long()                   # (B, L)
    n_flat = B * L
    sentinel = L * NB
    kept_flat = keep[:, None].expand(B, L).reshape(-1)
    flat_b = torch.arange(B, dtype=torch.int64, device=dev)[:, None] \
        .expand(B, L).reshape(-1)
    masked_key = torch.where(kept_flat, bucket_key.reshape(-1), sentinel)
    # (bucket key, point id) packed into one int64: the keys of kept entries
    # are unique, so a plain sort gives the reference's stable order.
    packed = torch.sort(masked_key * B + flat_b).values
    s_key = packed // B
    s_b = (packed % B).to(_I32)
    s_kept = s_key < sentinel
    pos_idx = torch.arange(n_flat, dtype=torch.int64, device=dev)
    seg_start = torch.ones(n_flat, dtype=torch.bool, device=dev)
    seg_start[1:] = s_key[1:] != s_key[:-1]
    rank = pos_idx - torch.cummax(torch.where(seg_start, pos_idx, 0), 0).values
    s_l = torch.clamp(s_key // NB, max=L - 1)                # clamp sentinel
    s_c = s_key % NB
    # Per-bucket append counts (also the table_ptr advance); survivors of
    # the ring cap are the last bucket_cap ranks of each bucket.
    counts = torch.zeros(L * NB, dtype=_I32, device=dev)
    counts.index_add_(0, bucket_key.reshape(-1), kept_flat.to(_I32))
    counts = counts.view(L, NB)
    seg_total = counts[s_l, s_c]
    entry_win = s_kept & (rank >= seg_total - cfg.bucket_cap)
    return SANNPrep(xs=xs, keep=keep, kept_rank=kept_rank, n_kept=n_kept,
                    winner=winner, s_l=s_l.to(_I32), s_c=s_c.to(_I32), s_b=s_b,
                    rank=rank.to(_I32), entry_win=entry_win, counts=counts)


def sann_commit_chunk(state: SANNState, prep: SANNPrep, cfg: SANNConfig,
                      count=None) -> SANNState:
    """Commit: rebase a prepared chunk on the state's pointers —

      1. slots = write_ptr + prepared ranks (mod capacity); point-store and
         stamp scatters for the winners;
      2. stale table entries pointing at slots recycled this chunk are
         tombstoned in one masked pass (into a new tables tensor);
      3. ring appends land at (table_ptr + rank) % bucket_cap through the
         `sann_table_scatter` kernel, in place on that new tensor.

    ``count`` (optional) overrides the stream-clock advance (default B)."""
    B = prep.xs.shape[0]
    cap = cfg.capacity
    dev = prep.xs.device
    slot = (state.write_ptr + prep.kept_rank) % cap          # (B,) int32
    win_slot = torch.where(prep.winner, slot, cap)           # OOB → dropped

    points = set_drop(state.points, win_slot, prep.xs)
    # Slots recycled this chunk: ring offsets [0, n_kept) from write_ptr.
    ring_off = (torch.arange(cap, dtype=_I32, device=dev) - state.write_ptr) % cap
    overwritten = ring_off < prep.n_kept
    valid = state.valid | overwritten

    # --- tombstone stale references to every slot recycled this chunk ------
    stale = (state.tables >= 0) & overwritten[state.tables.clamp(min=0).long()]
    tables = torch.where(stale, -1, state.tables)

    # --- ring-buffer appends (kernel, in place on the fresh tables) --------
    s_b = prep.s_b.long()
    val = torch.where(prep.winner[s_b], slot[s_b], -1).to(_I32)
    tables = kernel_ops.sann_table_scatter(
        tables, state.table_ptr, prep.s_l, prep.s_c, prep.rank, val,
        prep.entry_win)
    table_ptr = state.table_ptr + prep.counts

    # Logical arrival stamps: point i arrived at stream time n_seen + i.
    arrival = saturating_add(state.n_seen,
                             torch.arange(B, dtype=_I32, device=dev))
    stamps = set_drop(state.stamps, win_slot, arrival)

    newly = prep.winner & ~state.valid[torch.where(prep.winner, slot, 0).long()]
    return SANNState(
        points=points, valid=valid,
        write_ptr=(state.write_ptr + prep.n_kept) % cap,
        n_seen=saturating_add(state.n_seen, B if count is None else count),
        n_stored=(state.n_stored + newly.sum()).to(_I32),
        tables=tables, table_ptr=table_ptr, stamps=stamps,
    )


def sann_insert_batch(state: SANNState, params, xs: torch.Tensor,
                      generator: torch.Generator, cfg: SANNConfig) -> SANNState:
    """Batched ingest of a chunk ``xs (B, d)``: prepare then commit."""
    return sann_commit_chunk(
        state, sann_prepare_chunk(params, xs, generator, cfg), cfg)


def sann_insert_chunked(state: SANNState, params, xs: torch.Tensor,
                        generator: torch.Generator, cfg: SANNConfig,
                        chunk: int = 1024) -> SANNState:
    """Stream ``xs (T, d)`` through `sann_insert_batch` in chunks of
    ``chunk`` rows (the last one may be shorter)."""
    for i in range(0, xs.shape[0], chunk):
        state = sann_insert_batch(state, params, xs[i:i + chunk], generator,
                                  cfg)
    return state


def sann_merge(a: SANNState, b: SANNState, params, cfg: SANNConfig) -> SANNState:
    """Union of two sketches built with identical params and cfg over
    disjoint streams: the stored points are interleaved by arrival stamp
    (valid first, ties a-before-b), replayed as one pre-sampled chunk from an
    empty state, and given back their true stamps."""
    cap = cfg.capacity
    pts = torch.cat([a.points, b.points])
    valid = torch.cat([a.valid, b.valid])
    stamps = torch.cat([a.stamps, b.stamps])
    # lexsort((stamps, ~valid)): primary ~valid, secondary stamp, stable.
    key = ((~valid).long() << 32) + (stamps.long() + 2**31)
    order = torch.argsort(key, stable=True)
    xs = pts[order]
    keep = valid[order]
    st_sorted = stamps[order]

    prep = sann_prepare_given_keep(params, xs, keep, cfg)
    merged = sann_commit_chunk(sann_empty_state(cfg, xs.device), prep, cfg)
    slot = prep.kept_rank % cap
    win_slot = torch.where(prep.winner, slot, cap)
    return merged._replace(
        stamps=set_drop(merged.stamps, win_slot, st_sorted),
        n_seen=saturating_add(a.n_seen, b.n_seen),
    )


def sann_delete(state: SANNState, params, x: torch.Tensor, cfg: SANNConfig,
                tol: float = 1e-5) -> SANNState:
    """Turnstile delete-by-value (§3.4): tombstone every stored copy of x."""
    d2 = ((state.points - x) ** 2).sum(-1)
    hit = state.valid & (d2 <= tol)
    dead = hit[state.tables.clamp(min=0).long()] & (state.tables >= 0)
    return state._replace(valid=state.valid & ~hit,
                          tables=torch.where(dead, -1, state.tables),
                          n_stored=(state.n_stored - hit.sum()).to(_I32))


class SANNResult(NamedTuple):
    index: torch.Tensor      # slot id of returned point (-1 = NULL)
    distance: torch.Tensor   # distance to returned point (inf = NULL)
    found: torch.Tensor      # bool — success per the (c,r) contract
    n_candidates: torch.Tensor


def sann_bucket_candidates_batch(state: SANNState, params, qs: torch.Tensor,
                                 cfg: SANNConfig):
    """Batched bucket gather: ``qs (B, d)`` → ``(cand (B, L*bucket_cap)
    int32, ok (B, L*bucket_cap) bool)`` in row-major table order."""
    codes = lsh.hash_points(params, qs)                     # (B, L)
    rows = torch.arange(cfg.L, device=qs.device)[None, :]
    cand = state.tables[rows, codes.long()]                  # (B, L, cap)
    cand = cand.reshape(qs.shape[0], cfg.L * cfg.bucket_cap)
    ok = (cand >= 0) & state.valid[cand.clamp(min=0).long()]
    return cand, ok


def sann_score_candidates_batch(points: torch.Tensor, cand: torch.Tensor,
                                ok: torch.Tensor, qs: torch.Tensor,
                                budget: int, cfg: SANNConfig) -> SANNResult:
    """Batched truncate-and-score: keep the first ``budget`` valid
    candidates of each row (the paper's 3L early exit, located by a binary
    search on the running valid count), score them with the fused
    `batch_score_topk` kernel (k = 1) and return the argmin if within c*r."""
    C = cand.shape[1]
    budget_eff = min(budget, C)
    csum = torch.cumsum(ok, dim=1).to(_I32)                  # running count
    targets = torch.arange(1, budget_eff + 1, dtype=_I32, device=cand.device)
    sel = torch.searchsorted(
        csum, targets.expand(cand.shape[0], budget_eff).contiguous(),
        side="left")
    sel_ok = sel < C                  # j-th valid exists ⇔ search stayed in
    sel = sel.clamp(max=C - 1)
    sel_cand = torch.where(sel_ok, torch.gather(cand, 1, sel), -1)
    vecs = points[sel_cand.clamp(min=0).long()]              # (B, budget, d)
    d2, idx = kernel_ops.batch_score_topk(qs, vecs, sel_ok, 1)
    dist = torch.sqrt(d2[:, 0])
    found = dist <= cfg.c * cfg.r
    best = torch.gather(sel_cand, 1, idx.long())[:, 0]
    return SANNResult(
        index=torch.where(found, best, -1),
        distance=torch.where(found, dist, float("inf")),
        found=found,
        n_candidates=torch.clamp(csum[:, -1], max=budget).to(_I32),
    )


def sann_query_batch(state: SANNState, params, qs: torch.Tensor,
                     cfg: SANNConfig) -> SANNResult:
    """Batch queries (§3.3): one hash matmul and one table gather for the
    whole batch, the 3L truncation, one fused scorer call."""
    cand, ok = sann_bucket_candidates_batch(state, params, qs, cfg)
    return sann_score_candidates_batch(state.points, cand, ok, qs,
                                       3 * cfg.L, cfg)


def sann_bytes(cfg: SANNConfig) -> int:
    """Concrete sketch footprint (points + valid + stamps + tables)."""
    cfg = cfg.resolved()
    pts = cfg.capacity * cfg.dim * 4 + cfg.capacity + cfg.capacity * 4
    tbl = cfg.L * cfg.n_buckets * (cfg.bucket_cap + 1) * 4
    return pts + tbl


def _first_occurrence_mask(cand: torch.Tensor, capacity: int) -> torch.Tensor:
    """True at the first occurrence (lowest column) of each slot id per row
    of ``cand (B, C)``: a scatter-min of column positions when the slot-id
    range is small, else one stable argsort along the row."""
    B, C = cand.shape
    dev = cand.device
    pos = torch.arange(C, dtype=torch.int64, device=dev).expand(B, C)
    if capacity + 1 <= max(4096, 8 * C):
        key = (cand + 1).long()             # cand ∈ [-1, capacity)
        first = torch.full((B, capacity + 1), C, dtype=torch.int64, device=dev)
        first.scatter_reduce_(1, key, pos, reduce="amin")
        return torch.gather(first, 1, key) == pos
    order = torch.argsort(cand, dim=1, stable=True)
    sorted_c = torch.gather(cand, 1, order)
    dup = torch.zeros((B, C), dtype=torch.bool, device=dev)
    dup[:, 1:] = sorted_c[:, 1:] == sorted_c[:, :-1]
    return torch.zeros_like(dup).scatter_(1, order, ~dup)


def sann_query_topk_batch(state: SANNState, params, qs: torch.Tensor,
                          cfg: SANNConfig, topk: int = 50):
    """Top-k over the full bucket union (no 3L truncation, no (c,r)
    contract): ``qs (B, d)`` → ``(ids (B, k), dists (B, k))`` with
    ``k = min(topk, L * bucket_cap)``, ascending, padded with -1 / inf."""
    cand, ok = sann_bucket_candidates_batch(state, params, qs, cfg)
    mask = ok & _first_occurrence_mask(cand, state.points.shape[0])
    vecs = state.points[cand.clamp(min=0).long()]            # (B, C, dim)
    k = min(topk, cand.shape[1])
    d2, idx = kernel_ops.batch_score_topk(qs, vecs, mask, k)
    ids = torch.where(torch.isfinite(d2), torch.gather(cand, 1, idx.long()), -1)
    return ids, torch.sqrt(d2)
