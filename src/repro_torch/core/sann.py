"""S-ANN — Streaming (c,r)-Approximate Near Neighbor sketch (paper §3, Alg. 1).

The PyTorch counterpart of the reference's ``core/sann.py``: each arriving
point is kept with probability n^-eta, stored in a ring of ``capacity``
slots, and appended to L p-stable hash tables whose buckets are rings of
``bucket_cap`` slot ids.  A query scores the union of its L buckets.

Ingest paths:

* `sann_insert` / `sann_insert_stream` — the per-point oracle (Alg. 1
  verbatim, one point per step, a Python loop in place of ``lax.scan``);
* `sann_prepare_chunk` / `sann_commit_chunk` — the two-phase batched form
  (DESIGN.md §10): prepare is the pure half (keep decisions, prefix ranks,
  hashing, the sort-by-(row, code) append structure), commit rebases it on
  the live pointers, with the tombstone pass and the ring appends done by
  `ops.sann_table_commit` (the `sann_table_scatter` kernel).
  `sann_insert_batch` is their composition and is bit-identical to
  `sann_insert_stream` under the same key.

Query paths: `sann_query` / `sann_query_topk` score one query's candidates
with the `cand_score` kernel (the oracles); `sann_query_batch` /
`sann_query_topk_batch` are the fused batch engine (§9) on the
`batch_score_topk` kernel's gather entry (`ops.batch_score_topk_gather`:
slot ids in, the candidate rows read in the kernel), with results
identical to the oracles.

Random numbers: keep decisions come from threefry keys (`core.prng`),
``bernoulli(fold_in(key, i), keep_prob)`` for the i-th point of a chunk,
bit-identical to the reference's draws, so the same key stores the same
points in both packages and the schedule is prefix-stable.  Parameters are
drawn from a ``torch.Generator`` (`lsh.init_pstable`); parity tests carry
the reference's parameters across instead.

Commits never modify their input state: the table commit writes a new
tables tensor.  The per-point `sann_insert` likewise returns new tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from . import lsh, prng, theory
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


def _insert_decided(state: SANNState, params, x: torch.Tensor, keep: bool,
                    cfg: SANNConfig) -> SANNState:
    """`sann_insert` with its keep decision already drawn (a host bool).
    A point that is not kept only advances the stream clock; a kept point
    recycles slot ``write_ptr``, and when that slot was live, every table
    entry still pointing at it is tombstoned first (a host branch: the
    whole-table pass runs only when a kept point evicts)."""
    n_seen = saturating_add(state.n_seen, 1)
    if not keep:
        return state._replace(n_seen=n_seen)
    slot = state.write_ptr % cfg.capacity                    # () int32
    si = slot.long()
    evict = bool(state.valid[si])
    if evict:
        tables = torch.where(state.tables == slot, -1, state.tables)
    else:
        tables = state.tables.clone()
    points = state.points.clone()
    points[si] = x
    valid = state.valid.clone()
    valid[si] = True
    stamps = state.stamps.clone()
    stamps[si] = state.n_seen
    codes = lsh.hash_points(params, x).long()                # (L,)
    rows = torch.arange(cfg.L, device=x.device)
    ptr = state.table_ptr[rows, codes]
    tables[rows, codes, (ptr % cfg.bucket_cap).long()] = slot
    table_ptr = state.table_ptr.clone()
    table_ptr[rows, codes] = ptr + 1                         # rows distinct
    return SANNState(
        points=points, valid=valid,
        write_ptr=(state.write_ptr + 1) % cfg.capacity, n_seen=n_seen,
        n_stored=(state.n_stored + (0 if evict else 1)).to(_I32),
        tables=tables, table_ptr=table_ptr, stamps=stamps)


def sann_insert(state: SANNState, params, x: torch.Tensor, key: torch.Tensor,
                cfg: SANNConfig) -> SANNState:
    """Sample-and-store one stream point ``x (d,)`` (Alg. 1 insert; Fig. 1):
    kept with ``bernoulli(key, keep_prob)``.  One host sync for the draw."""
    keep = bool(prng.bernoulli(key.to(x.device), cfg.keep_prob))
    return _insert_decided(state, params, x, keep, cfg)


def sann_row_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """Per-point key schedule for a chunk: ``fold_in(key, i)`` for i < n →
    ``(n, 2)`` keys.  Prefix-stable: ``sann_row_keys(key, m)[:b] ==
    sann_row_keys(key, b)`` for b <= m."""
    return prng.fold_in(key, torch.arange(n, dtype=torch.int64,
                                          device=key.device))


def sann_insert_stream(state: SANNState, params, xs: torch.Tensor,
                       key: torch.Tensor, cfg: SANNConfig) -> SANNState:
    """Per-point reference ingest of ``xs (T, d)``: point i is inserted under
    key ``sann_row_keys(key, T)[i]``.  The T Bernoulli draws are made in one
    vectorised pass (each is a function of its own key alone, so the bits
    are those of a draw per step), then one `sann_insert` step per point.
    `sann_insert_batch` is bit-identical under the same key."""
    keys = sann_row_keys(key.to(xs.device), xs.shape[0])
    keep = prng.bernoulli(keys, cfg.keep_prob).tolist()
    for x, kp in zip(xs, keep):
        state = _insert_decided(state, params, x, kp, cfg)
    return state


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


def sann_prepare_chunk(params, xs: torch.Tensor, key: torch.Tensor,
                       cfg: SANNConfig) -> SANNPrep:
    """Prepare ``xs (B, d)``: one Bernoulli draw per point from the
    `sann_row_keys` schedule of ``key``, then `sann_prepare_given_keep`."""
    keys = sann_row_keys(key.to(xs.device), xs.shape[0])
    keep = prng.bernoulli(keys, cfg.keep_prob)
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
      2. one `ops.sann_table_commit` call writes the new tables: the old
         ones with every entry pointing at a slot recycled this chunk
         tombstoned, then the ring appends at
         (table_ptr + rank) % bucket_cap.

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

    # --- tombstone stale references to recycled slots, then the ring
    # appends, into a new tables tensor (one kernel entry) -----------------
    s_b = prep.s_b.long()
    val = torch.where(prep.winner[s_b], slot[s_b], -1).to(_I32)
    tables = kernel_ops.sann_table_commit(
        state.tables, state.table_ptr, prep.s_l, prep.s_c, prep.rank, val,
        prep.entry_win, state.write_ptr, prep.n_kept, cap)
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
                      key: torch.Tensor, cfg: SANNConfig) -> SANNState:
    """Batched ingest of a chunk ``xs (B, d)``: prepare then commit;
    bit-identical to `sann_insert_stream` under the same key."""
    return sann_commit_chunk(
        state, sann_prepare_chunk(params, xs, key, cfg), cfg)


def sann_insert_chunked(state: SANNState, params, xs: torch.Tensor,
                        key: torch.Tensor, cfg: SANNConfig,
                        chunk: int = 1024) -> SANNState:
    """Stream ``xs (T, d)`` through `sann_insert_batch` in chunks of
    ``chunk`` rows (the last one may be shorter), chunk j under key
    ``split(key, n_chunks)[j]`` as in the reference."""
    n_chunks = -(-xs.shape[0] // chunk)
    ckeys = prng.split(key.to(xs.device), max(n_chunks, 1))
    for j in range(n_chunks):
        state = sann_insert_batch(state, params,
                                  xs[j * chunk:(j + 1) * chunk], ckeys[j], cfg)
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


def sann_bucket_candidates(state: SANNState, params, q: torch.Tensor,
                           cfg: SANNConfig):
    """Gather the colliding buckets for ``q (d,)``: ``(cand (L*bucket_cap,)
    int32, ok (L*bucket_cap,) bool)`` in row-major table order."""
    codes = lsh.hash_points(params, q).long()                # (L,)
    rows = torch.arange(cfg.L, device=q.device)
    cand = state.tables[rows, codes].reshape(-1)
    ok = (cand >= 0) & state.valid[cand.clamp(min=0).long()]
    return cand, ok


def _stable_argsort(v: torch.Tensor) -> torch.Tensor:
    return torch.sort(v, stable=True).indices


def sann_score_candidates(points: torch.Tensor, cand: torch.Tensor,
                          ok: torch.Tensor, q: torch.Tensor, budget: int,
                          cfg: SANNConfig) -> SANNResult:
    """Truncate-and-score one query: keep the first ``budget`` valid
    candidates (the paper's 3L early exit: a stable sort puts invalid
    entries last), score them with the `cand_score` kernel, and return the
    argmin (lowest index on ties) if within c*r (Fig. 2)."""
    sel = _stable_argsort((~ok).to(torch.int32))[:budget]
    cand, ok = cand[sel], ok[sel]
    vecs = points[cand.clamp(min=0).long()]                  # (budget, d)
    d2 = torch.where(ok, kernel_ops.cand_score(q, vecs), float("inf"))
    best = _stable_argsort(d2)[0]
    dist = torch.sqrt(d2[best])
    found = dist <= cfg.c * cfg.r
    return SANNResult(
        index=torch.where(found, cand[best], -1),
        distance=torch.where(found, dist, float("inf")),
        found=found,
        n_candidates=ok.sum().to(_I32),
    )


def sann_query(state: SANNState, params, q: torch.Tensor,
               cfg: SANNConfig) -> SANNResult:
    """Alg. 1 query for ``q (d,)``: gather L buckets, truncate to 3L
    candidates, score, return the argmin if within c*r (Fig. 2); fields are
    0-d tensors (index -1 / distance inf encode NULL)."""
    cand, ok = sann_bucket_candidates(state, params, q, cfg)
    return sann_score_candidates(state.points, cand, ok, q, 3 * cfg.L, cfg)


def sann_query_topk(state: SANNState, params, q: torch.Tensor,
                    cfg: SANNConfig, topk: int = 50):
    """Top-k oracle for ``q (d,)`` (no 3L truncation, no (c,r) contract):
    score the full bucket union with `cand_score`, keep the first occurrence
    of each slot id, return ``(ids (k,), dists (k,))`` with
    ``k = min(topk, L * bucket_cap)``, ascending (lowest index on ties),
    padded with -1 / inf."""
    cand, ok = sann_bucket_candidates(state, params, q, cfg)
    vecs = state.points[cand.clamp(min=0).long()]
    d2 = torch.where(ok, kernel_ops.cand_score(q, vecs), float("inf"))
    order = _stable_argsort(cand)
    sorted_c = cand[order]
    dup = torch.zeros_like(ok)
    dup[1:] = sorted_c[1:] == sorted_c[:-1]
    first = torch.zeros_like(ok)
    first[order] = ~dup
    d2 = torch.where(first, d2, float("inf"))
    vals, idx = torch.sort(d2, stable=True)
    k = min(topk, d2.shape[0])
    vals, idx = vals[:k], idx[:k]
    return torch.where(torch.isfinite(vals), cand[idx], -1), torch.sqrt(vals)


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
    search on the running valid count), score them by slot id with the
    fused `batch_score_topk_gather` kernel (k = 1; the candidate rows are
    read in the kernel) and return the argmin if within c*r."""
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
    d2, idx = kernel_ops.batch_score_topk_gather(qs, points, sel_cand,
                                                 sel_ok, 1)
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
    k = min(topk, cand.shape[1])
    d2, idx = kernel_ops.batch_score_topk_gather(qs, state.points, cand,
                                                 mask, k)
    ids = torch.where(torch.isfinite(d2), torch.gather(cand, 1, idx.long()), -1)
    return ids, torch.sqrt(d2)
