"""Shared streaming-service runtime: two-phase pipelined ingest + snapshot
queries (DESIGN.md §10), durable via snapshot + WAL (DESIGN.md §11).

The port of the reference's ``serve/engine.py``.  Every sketch service is
the same state machine: a stream of embedding chunks folds into sketch
state under a lock, while concurrent queries read a snapshot of that state.
`SketchEngine` owns that machinery once — `RetrievalService`, `KDEService`
and `RACEService` are thin subclasses that plug in the sketch-specific
*prepare* / *commit* pair:

  * **prepare** (`core.*.{sann,race,swakde}_prepare_chunk`) never reads
    sketch state, so the engine runs it on a prepare thread, up to
    ``prepare_depth`` chunks ahead of the commits.  On the card each
    prepare is launched on a side CUDA stream and records an event; the
    commit stream waits on that event (no host wait), and every prepared
    tensor is ``record_stream``-ed on the commit stream so the caching
    allocator cannot hand its memory out while the commit reads it.
  * **commit** (`core.*.*_commit_chunk`) is the only state-sequential part.
    Commits run on the ingest worker thread, in submission order, and are
    the only writers of ``self.state``.  After each commit the worker waits
    for it on the host once (an event synchronize), which paces the
    pipeline as the reference's ``block_until_ready`` does.

Consistency contract: ``self.state`` is only ever replaced *atomically*
under the lock with a fully committed value, and no commit writes into a
tensor that a published state holds (every core commit returns new
tensors), so a query snapshot is always the exact state after some
committed prefix of the submitted stream.  Commits and queries are queued
on the device's current stream in the order the lock publishes them, so a
query reads the device values its snapshot names.  ``flush()`` after any
number of ``ingest_async()`` calls leaves the service in exactly the state
the synchronous ``ingest()`` path produces (``ingest == ingest_async +
flush``).

Chunks from the host: ``ingest_async`` makes one host→device copy per call
(from pinned memory, without waiting) and slices chunks on the device; with
durability it keeps the host copy for the WAL records.

Admission control: ``max_pending`` bounds the rows queued behind the
commit worker; ``ingest_async`` blocks (backpressure) instead of letting
the queue grow without bound.  One chunk is always admitted.

Durability (`persist`): with a `DurabilityConfig`, every operation gets a
global sequence number, chunks are appended to the write-ahead log *at
enqueue time* (before the commit worker can see them), and the commit
worker writes background state snapshots every ``snapshot_every``
operations (WAL segments behind a durable snapshot are compacted away).
``recover()`` = load the newest snapshot + replay the WAL tail through this
same prepare/commit path — bit-identical to the uninterrupted run, because
per-chunk keys are a pure function of the chunk's sequence number (the
``_make_chunk_item(chunk, seq)`` contract).  The formats are the
reference's, so either package recovers the other's directory.

Query-side snapshot caching: every commit bumps a version counter;
`cached()` memoises pure functions of a snapshot (the SW-AKDE (L, W) grid
table) keyed by that version.

Cross-request query micro-batching (`QueryBatcher`, DESIGN.md §13):
concurrent client queries are coalesced into one fused call per tick
(bounded by ``max_batch`` rows and a ``max_wait_us`` latency budget),
served from ONE versioned state snapshot (and, for SW-AKDE, one
grid-cache entry), copied to the host once, and scattered back to the
waiting callers' futures.  Query results are numpy on the host, batched or
not.  Every query block is padded to ``query_block`` rows before it
reaches the device, so each row sees the same matrix-product shape however
the rows were coalesced: the fused engines are row-independent, and with
one shape the hash matmul is too (BLAS and cuBLAS may choose another
reduction order for another shape), so coalesced answers are bit-identical
to uncoalesced ones.
"""
from __future__ import annotations

import collections
import pathlib
import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .. import persist
from ..checkpoint.checkpoint import (AsyncCheckpointer, tree_leaves, tree_map,
                                     tree_unflatten)
from ..core.util import resolve_device
from ..persist import faults

# Queue marker telling the ingest worker to exit (see SketchEngine.close).
_STOP = object()


def durability_from(cfg) -> Optional[persist.DurabilityConfig]:
    """Shared service-config → DurabilityConfig mapping: any config with a
    ``snapshot_dir`` (plus ``snapshot_every`` / ``wal_fsync``) opts into
    the snapshot + WAL subsystem; ``snapshot_dir=None`` stays volatile."""
    if getattr(cfg, "snapshot_dir", None) is None:
        return None
    return persist.DurabilityConfig(
        dir=cfg.snapshot_dir, snapshot_every=cfg.snapshot_every,
        fsync=cfg.wal_fsync, fault_scope=getattr(cfg, "fault_scope", ""))


def to_host(tree):
    """A result tree of tensors → the same tree of numpy arrays.  Leaves on
    the card travel as one byte buffer: one device op and one copy to the
    host for the whole tree."""
    leaves = tree_leaves(tree)
    if not any(t.is_cuda for t in leaves):
        return tree_map(lambda t: t.numpy(), tree)
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in leaves])
    host = flat.cpu().numpy()
    out, off = [], 0
    for t in leaves:
        nb = t.numel() * t.element_size()
        dt = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(host[off:off + nb].view(dt).reshape(tuple(t.shape)))
        off += nb
    return tree_unflatten(tree, out)


def _record_stream(tree, stream) -> None:
    """Mark every CUDA tensor of ``tree`` as in use on ``stream``."""
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(stream)


def host_rows(x) -> np.ndarray:
    """Query or delete rows as a host float32 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def batch_plan(pending: Sequence, now_us: float, max_batch: int,
               max_wait_us: float):
    """Pure admission policy of one `QueryBatcher` tick.

    ``pending`` is the FIFO queue of waiting requests as ``(arrival_us,
    n_rows)`` pairs (non-empty); returns ``(take, wait_us)``:

      * ``take >= 1`` — coalesce the first ``take`` requests into one
        fused batch *now*;
      * ``take == 0`` — no batch yet: sleep at most ``wait_us`` for more
        arrivals (always the *oldest* request's remaining budget, so later
        arrivals can never push the deadline out — no starvation).

    Firing rule: dispatch as soon as the coalesced prefix (a) holds at
    least ``max_batch`` rows, (b) is row-capped (the next request would
    not fit — waiting adds latency without adding rows), or (c) the oldest
    request's ``max_wait_us`` budget is spent.  The prefix never exceeds
    ``max_batch`` rows unless a single request alone does (one-request
    progress guarantee).  Kept free of threads/clocks so the scheduler
    properties are fuzz-testable exactly (tests/test_serve_batching.py).
    """
    take, rows = 0, 0
    for _, n in pending:
        if take and rows + n > max_batch:
            break
        take += 1
        rows += n
    capped = take < len(pending)
    deadline = pending[0][0] + max_wait_us
    if rows >= max_batch or capped or now_us >= deadline:
        return take, 0.0
    return 0, deadline - now_us


class QueryBatcher:
    """Cross-request query micro-batching: an admission queue + tick loop.

    Concurrent ``submit(kind, rows)`` calls enqueue ``(B_i, d)`` query
    blocks and get a `concurrent.futures.Future` back; a dedicated
    scheduler thread coalesces the queue into one execute call per tick
    under the `batch_plan` policy (``max_batch`` rows / ``max_wait_us``
    latency budget) and scatters per-request result slices onto the
    futures.  ``execute(reqs)`` — supplied by the engine — receives the
    FIFO list of ``(kind, rows)`` and must return one result per request;
    it runs *outside* the queue lock, so arrivals during a slow batch
    simply form the next tick (a slow query delays later arrivals by at
    most one in-flight execute, never indefinitely).

    ``close()`` drains: queued requests are still served (in order), then
    the thread exits; ``close(drain=False)`` fails pending futures with
    `RuntimeError` instead.  Either way no future is left hanging and new
    submissions are rejected.

    Lone-client fast path (`try_submit_inline`): in continuous-batching
    mode (``max_wait_us == 0`` — fire the moment the executor is free) a
    *sync* caller that finds the queue empty and no tick in flight can
    run its request as its own tick on the caller thread, skipping both
    scheduler-thread handoffs (C = 1 previously paid ~2.5× the direct
    path on wakeup latency alone).  The inline tick claims the same
    single-executor slot the loop uses (``_busy``), so coalescing under
    load is unchanged: requests arriving while any tick is in flight
    queue up and form the next fused batch.  ``submit`` itself never
    inlines — async callers must get their future back immediately, even
    when the execute is slow.  With ``max_wait_us > 0`` every request
    takes the queued path — an idle-start request must *wait* for
    coalescing partners there, which is exactly what the inline path
    would skip.  Results are bit-identical either way (same execute,
    same rows).
    """

    def __init__(self, execute: Callable[[list], list],
                 max_batch: int = 1024, max_wait_us: float = 200.0):
        self._execute = execute
        self._max_batch = max(1, int(max_batch))
        self._max_wait_us = max(0.0, float(max_wait_us))
        self._cv = threading.Condition()
        self._pending: collections.deque = collections.deque()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # stats (under _cv): ticks = execute calls, queries/rows = totals
        # over all coalesced batches, max_tick_rows = largest single tick.
        self._ticks = 0
        self._queries = 0
        self._rows = 0
        self._max_tick_rows = 0
        self._inline_ticks = 0
        # Ticks in flight (0 or 1): the loop and the inline fast path
        # both claim this slot under _cv, so at most one execute runs.
        self._busy = 0

    @property
    def closed(self) -> bool:
        return self._closed

    def submit(self, kind: str, rows) -> Future:
        """Enqueue one query block; returns a future resolving to the
        engine's result for exactly these rows (bit-identical to an
        uncoalesced call)."""
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("QueryBatcher is closed")
            self._pending.append(
                (time.monotonic() * 1e6, kind, rows, fut))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="query-batcher")
                self._thread.start()
            self._cv.notify_all()
        return fut

    def try_submit_inline(self, kind: str, rows) -> Optional[Future]:
        """Lone-client fast path (see class docstring): when the executor
        is idle and nothing is queued in continuous-batching mode, run
        this request as its own tick on the *caller* thread and return
        its (completed) future.  Returns None when the fast path is
        unavailable — the caller falls back to `submit`.  Only for sync
        callers that would block on the future anyway."""
        with self._cv:
            if self._closed:
                raise RuntimeError("QueryBatcher is closed")
            if (self._max_wait_us != 0.0 or self._pending
                    or self._busy != 0):
                return None
            self._busy = 1
            self._ticks += 1
            self._queries += 1
            self._inline_ticks += 1
            n = int(rows.shape[0])
            self._rows += n
            self._max_tick_rows = max(self._max_tick_rows, n)
        fut: Future = Future()
        try:
            results = self._execute([(kind, rows)])
            fut.set_result(results[0])
        except BaseException as e:
            fut.set_exception(e)
        finally:
            with self._cv:
                self._busy = 0
                self._cv.notify_all()
        return fut

    def stats(self) -> dict:
        """Scheduler counters: ticks (fused execute calls), coalesced
        queries/rows, mean coalesced batch size, largest tick."""
        with self._cv:
            t = max(self._ticks, 1)
            return {"ticks": self._ticks, "queries": self._queries,
                    "rows": self._rows,
                    "mean_batch_queries": self._queries / t,
                    "mean_batch_rows": self._rows / t,
                    "max_tick_rows": self._max_tick_rows,
                    "inline_ticks": self._inline_ticks}

    def close(self, drain: bool = True) -> None:
        """Stop accepting work; serve (``drain=True``) or fail the queue,
        then join the scheduler thread.  Idempotent."""
        with self._cv:
            self._closed = True
            if not drain:
                while self._pending:
                    *_, fut = self._pending.popleft()
                    fut.set_exception(
                        RuntimeError("QueryBatcher closed before serving"))
            thread = self._thread
            self._cv.notify_all()
        if thread is not None:
            thread.join()
            self._thread = None
        with self._cv:
            # Wait out any inline tick so no execute is still running
            # when close() returns.
            while self._busy:
                self._cv.wait()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending:
                    return                       # closed and drained
                take = 0
                while self._pending:
                    # A closing batcher fires the planned prefix at once
                    # (wait budget 0) — drain without the latency budget.
                    take, wait_us = batch_plan(
                        [(arr, r.shape[0]) for arr, _, r, _ in
                         self._pending],
                        time.monotonic() * 1e6, self._max_batch,
                        0.0 if self._closed else self._max_wait_us)
                    if take:
                        break
                    self._cv.wait(wait_us / 1e6)
                while take and self._busy:   # an inline tick is in flight
                    self._cv.wait()
                # Every wait above releases the lock, so close(drain=False)
                # may have failed-and-drained the queue meanwhile: re-clamp
                # the planned prefix to what is still queued before popping
                # (a stale `take` would underflow the deque and kill this
                # thread with an unhandled IndexError).
                take = min(take, len(self._pending))
                if not take:
                    continue
                batch = [self._pending.popleft() for _ in range(take)]
                self._busy = 1
                self._ticks += 1
                self._queries += len(batch)
                rows = sum(r.shape[0] for _, _, r, _ in batch)
                self._rows += rows
                self._max_tick_rows = max(self._max_tick_rows, rows)
            reqs = [(kind, r) for _, kind, r, _ in batch]
            try:
                results = self._execute(reqs)
                for (*_, fut), res in zip(batch, results):
                    fut.set_result(res)
            except BaseException as e:
                for *_, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
            finally:
                with self._cv:
                    self._busy = 0
                    self._cv.notify_all()


class _BatchedQueryMixin:
    """Shared query-side micro-batching API (one snapshot per tick, per-kind
    fused calls, one copy to the host per kind, per-request result scatter).

    Host-class contract: ``_query_kind_fns()`` maps query-kind names to
    ``fn(snapshot_ctx, qs) -> tree of tensors`` with a leading B axis (row
    independent — the fused batch engines), ``qs`` a float32 tensor on the
    engine's device; ``_query_snapshot_ctx()`` captures everything a tick
    shares (state snapshot, version, caches) in ONE lock-consistent read;
    ``_to_device(rows)`` places host rows; ``_default_query_kind`` names the
    plain-``query()`` kind.
    """

    _default_query_kind = "query"
    # Fault-injection naming (DESIGN §14): the engine's query path is
    # ``engine.query``.
    _fault_scope = ""
    _query_fault_site = "engine.query"

    def _init_query_batching(self, batch_queries: bool,
                             max_batch: Optional[int],
                             max_wait_us: float, default_max_batch: int):
        self._batch_queries = bool(batch_queries)
        self._max_batch = (default_max_batch if max_batch is None
                           else max(1, int(max_batch)))
        self._max_wait_us = float(max_wait_us)
        self._batcher: Optional[QueryBatcher] = None
        self._batcher_lock = threading.Lock()
        self._kind_fns: Optional[dict] = None

    # --- host-class hooks ---------------------------------------------------

    def _query_kind_fns(self) -> dict:
        raise NotImplementedError

    def _query_snapshot_ctx(self):
        raise NotImplementedError

    # --- API ----------------------------------------------------------------

    @property
    def batcher(self) -> Optional[QueryBatcher]:
        """The live scheduler (None until the first ``submit_query``)."""
        return self._batcher

    def _kind_fn(self, kind: str) -> Callable:
        if self._kind_fns is None:
            self._kind_fns = self._query_kind_fns()
        try:
            return self._kind_fns[kind]
        except KeyError:
            raise ValueError(
                f"unknown query kind {kind!r}; expected one of "
                f"{sorted(self._kind_fns)}") from None

    def _get_batcher(self) -> QueryBatcher:
        with self._batcher_lock:
            if self._batcher is None:
                self._batcher = QueryBatcher(
                    self._batch_execute, max_batch=self._max_batch,
                    max_wait_us=self._max_wait_us)
            return self._batcher

    def submit_query(self, queries, kind: Optional[str] = None) -> Future:
        """Enqueue a query block ``(B, d)`` with the admission scheduler
        and return a future — the asynchronous client entry point.  The
        result is bit-identical to the corresponding sync call; B = 0
        blocks resolve to the matching empty result."""
        kind = self._default_query_kind if kind is None else kind
        self._kind_fn(kind)                      # validate before enqueue
        # Host-side staging: the tick concatenates numpy rows, so one copy
        # to the device serves every coalesced request.
        return self._get_batcher().submit(kind, host_rows(queries))

    def _serve_query(self, kind: str, queries):
        """Sync query entry: through the scheduler when the service was
        built with ``batch_queries=True`` (and it is still accepting),
        directly against one snapshot otherwise — identical results."""
        qs = host_rows(queries)
        if self._batch_queries and not (
                self._batcher is not None and self._batcher.closed):
            self._kind_fn(kind)                  # validate before enqueue
            batcher = self._get_batcher()
            # Sync callers block on the result either way, so they may
            # take the lone-client inline tick when the scheduler is idle.
            fut = batcher.try_submit_inline(kind, qs)
            if fut is None:
                fut = batcher.submit(kind, qs)
            return fut.result()
        faults.fire(self._fault_scope + self._query_fault_site)
        return to_host(self._kind_fn(kind)(self._query_snapshot_ctx(),
                                           self._to_device(qs)))

    def _close_batcher(self) -> None:
        with self._batcher_lock:
            if self._batcher is not None:
                self._batcher.close()

    # --- the coalesced tick -------------------------------------------------

    def _batch_execute(self, reqs: list) -> list:
        """Serve one coalesced tick: ONE snapshot context for every
        request; per query kind, the requests' rows concatenated on the
        host, one copy to the device, one fused call, one copy of the
        result to the host, and per-request numpy slices scattered back in
        FIFO order.  (No padding here: `SketchEngine._query_blocks` pads
        every block to ``query_block`` rows.)"""
        faults.fire(self._fault_scope + self._query_fault_site)
        ctx = self._query_snapshot_ctx()
        results: list = [None] * len(reqs)
        groups: dict = {}
        for i, (kind, _) in enumerate(reqs):
            groups.setdefault(kind, []).append(i)
        for kind, idxs in groups.items():
            rows = np.concatenate([reqs[i][1] for i in idxs])
            out = to_host(self._kind_fn(kind)(ctx, self._to_device(rows)))
            lo = 0
            for i in idxs:
                hi = lo + reqs[i][1].shape[0]
                results[i] = tree_map(lambda a, lo=lo, hi=hi: a[lo:hi], out)
                lo = hi
        return results


class SketchEngine(_BatchedQueryMixin):
    """Two-phase streaming-ingest runtime shared by the sketch services.

    Subclass contract (all other plumbing lives here, once):

      * set ``self.state`` (a NamedTuple of tensors) before first use;
      * ``_make_chunk_item(chunk, seq)`` — called in submission order under
        the submit lock; returns the argument tuple for ``_prepare``.  Any
        per-chunk randomness must be a pure function of ``seq`` (e.g.
        ``prng.fold_in(base_key, seq)``) so the schedule is identical
        across sync/async ingest *and* across crash recovery replay;
      * ``_prepare(*item)`` — the pure prepare phase (state-independent);
      * ``_commit(state, prep)`` — the commit phase; returns new tensors;
      * optionally ``_apply_wal_record(kind, arrays)`` for service-logged
        mutations (e.g. deletes).

    Knobs: ``ingest_chunk`` rows per prepare/commit pair, ``query_block``
    rows per fused query call, ``pipelined=False`` runs prepare and commit
    strictly in sequence on the worker (bit-identical results),
    ``prepare_depth`` chunks the prepare side may run ahead of the commit
    side, ``max_pending`` bounds queued-but-uncommitted rows (None =
    unbounded), ``durability`` enables the snapshot + WAL subsystem,
    ``device`` places the state (default the card; raises without one).

    Query-side micro-batching (`_BatchedQueryMixin`): ``batch_queries``
    routes the sync query wrappers through the admission scheduler,
    ``max_batch`` bounds the rows coalesced per tick (None = the
    ``query_block``) and ``max_wait_us`` is the scheduler's latency
    budget; ``submit_query`` is always available regardless.
    """

    state: Any

    def __init__(self, ingest_chunk: int, query_block: int = 1024,
                 pipelined: bool = True,
                 prepare_depth: int = 1,
                 max_pending: Optional[int] = None,
                 durability: Optional[persist.DurabilityConfig] = None,
                 batch_queries: bool = False,
                 max_batch: Optional[int] = None,
                 max_wait_us: float = 200.0,
                 fault_scope: str = "",
                 device="cuda"):
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        if self._cuda and self._device.index is None:
            # the worker and prepare threads bind this exact card
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._chunk = max(1, int(ingest_chunk))
        # Fault-injection site prefix (persist.faults; DESIGN §14).
        self._fault_scope = fault_scope or (
            durability.fault_scope if durability is not None else "")
        self._query_block = max(1, int(query_block))
        self._init_query_batching(batch_queries, max_batch, max_wait_us,
                                  default_max_batch=self._query_block)
        self._pipelined = bool(pipelined)
        self._prepare_depth = max(1, int(prepare_depth))
        self._max_pending = (None if max_pending is None
                             else max(1, int(max_pending)))
        # _lock guards state + version + snapshot cache; _submit_lock orders
        # chunk submission (seq numbers + WAL appends happen in queue order).
        self._lock = threading.Lock()
        self._submit_lock = threading.Lock()
        self._version = 0
        self._snap_cache: dict = {}
        self._queue: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._pending = 0
        self._pending_rows = 0
        self._worker: Optional[threading.Thread] = None
        self._ingest_error: Optional[str] = None
        self._closed = False
        self._poisoned = False
        self._poison_reason: Optional[str] = None
        # Durability: global operation sequence (chunks + logged mutations).
        # _seq = next seq to assign, _committed_seq = ops applied to state.
        self._seq = 0
        self._committed_seq = 0
        self._dur = durability
        self._wal: Optional[persist.WriteAheadLog] = None
        self._ckpt: Optional[AsyncCheckpointer] = None
        self._needs_recover = False
        self._snap_inflight: Optional[int] = None
        self._last_snap_seq = 0
        if durability is not None:
            if (pathlib.Path(durability.dir) / "cluster.json").exists():
                raise RuntimeError(
                    f"{durability.dir!r} is a cluster durability directory "
                    "(its state lives under worker_* subdirectories); a "
                    "single engine cannot recover it — reopen with the "
                    "cluster service at the original worker count.")
            self._wal = persist.WriteAheadLog(
                pathlib.Path(durability.dir) / "wal", fsync=durability.fsync,
                fault_scope=self._fault_scope)
            self._ckpt = AsyncCheckpointer()
            self._needs_recover = (
                persist.snapshot.latest_seq(durability.dir) is not None
                or self._wal.has_records())
        # Prepare threads (the host launches prepare k+1.. while the worker
        # launches and waits on commit k); on the card their work goes to a
        # side stream of its own.
        self._prep_pool = (ThreadPoolExecutor(
            max_workers=self._prepare_depth,
            initializer=self._bind_thread)
            if self._pipelined else None)
        self._prep_stream = (torch.cuda.Stream(self._device)
                             if self._cuda and self._pipelined else None)

    def _bind_thread(self) -> None:
        if self._cuda:
            torch.cuda.set_device(self._device)

    def _poison(self, where: str, exc: BaseException) -> None:
        """Fail-stop with a recorded reason (surfaced by `health()`)."""
        self._poisoned = True
        self._poison_reason = f"{where}: {exc!r}"

    # --- subclass hooks ----------------------------------------------------

    def _make_chunk_item(self, chunk: torch.Tensor, seq: int) -> tuple:
        return (chunk,)

    def _prepare(self, *item):
        raise NotImplementedError

    def _commit(self, state, prep):
        raise NotImplementedError

    def _apply_wal_record(self, kind: int, arrays: dict) -> None:
        """Replay a service-logged mutation record (see `_durable_mutate`).
        Subclasses that log mutations must override."""
        raise NotImplementedError(f"unknown WAL record kind {kind}")

    # --- device plumbing ---------------------------------------------------

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        """Host rows → a float32 tensor on the engine's device: one copy,
        from pinned memory and without a host wait on the card."""
        rows = np.ascontiguousarray(rows, np.float32)
        if not self._cuda:
            return torch.from_numpy(rows.copy())
        return torch.from_numpy(rows).pin_memory().to(self._device,
                                                      non_blocking=True)

    def _ready_event(self):
        """An event on the caller's stream after a chunk item was made."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _prepare_ready(self, item: tuple, ready) -> tuple:
        """Launch a chunk's prepare → ``(prep, done)``: on the card on the
        side stream (after ``ready``), with ``done`` an event after it."""
        if not self._cuda:
            return self._prepare(*item), None
        stream = self._prep_stream or torch.cuda.current_stream(self._device)
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            _record_stream(item, stream)
            prep = self._prepare(*item)
            done = torch.cuda.Event()
            done.record(stream)
        return prep, done

    def _wait_prepared(self, prepared: tuple):
        """The commit stream waits (on the device) for a prepare."""
        prep, done = prepared
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            _record_stream(prep, stream)
        return prep

    def _pace(self) -> None:
        """The one host wait per commit: until the device has finished it."""
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()

    # --- ingest ------------------------------------------------------------

    def ingest(self, data) -> None:
        """Synchronous chunked ingest: submit + wait.  Exactly
        ``ingest_async(data)`` followed by ``flush()`` — one code path."""
        self.ingest_async(data)
        self.flush()

    def ingest_async(self, data) -> None:
        """Queue a block of rows ``(n, d)`` (numpy or a tensor) for
        background two-phase ingest and return (mostly) immediately.
        Chunks commit in submission order; concurrent queries observe some
        committed prefix.  With ``max_pending`` set, blocks while the queue
        holds that many uncommitted rows (admission-control backpressure).
        With durability, each chunk is WAL-logged before it becomes
        visible to the commit worker.  Call ``flush()`` to wait for the
        commits."""
        if isinstance(data, torch.Tensor):
            xs = data.detach().to(self._device, torch.float32)
            # Durable path: one host copy of the block, sliced for the WAL.
            host = xs.cpu().numpy() if self._wal is not None else None
        else:
            host = np.asarray(data, np.float32)
            xs = self._to_device(host)
        if xs.shape[0] == 0:
            return
        with self._submit_lock:
            self._check_ingestable()
            for i in range(0, xs.shape[0], self._chunk):
                c = xs[i:i + self._chunk]
                if self._max_pending is not None:
                    with self._cv:
                        while self._pending_rows >= self._max_pending:
                            self._cv.wait()
                seq = self._seq
                item = self._make_chunk_item(c, seq)
                ready = self._ready_event()
                if self._wal is not None:
                    # WAL-before-publish: the record is durable before the
                    # commit worker can see the chunk.  A failed append
                    # leaves seq assignment and the log in sync, but chunks
                    # of this call logged *before* the failure are already
                    # accepted — so the engine poisons itself rather than
                    # invite a blind resubmit; recover() replays exactly the
                    # accepted prefix.  A *transient* fault on the FIRST
                    # chunk of a call accepted nothing: the call is cleanly
                    # rejected and the engine stays live.
                    try:
                        self._wal.append([(seq, persist.KIND_CHUNK,
                                           {"xs": host[i:i + self._chunk]})])
                    except BaseException as e:
                        if not (i == 0 and faults.is_transient(e)):
                            self._poison("wal append (chunk rejected)", e)
                        raise
                self._seq = seq + 1
                with self._cv:
                    self._queue.append(((item, ready), int(c.shape[0])))
                    self._pending += 1
                    self._pending_rows += int(c.shape[0])
                    if self._worker is None:
                        self._worker = threading.Thread(
                            target=self._worker_loop, daemon=True,
                            name=f"{type(self).__name__}-ingest")
                        self._worker.start()
                    self._cv.notify_all()

    def _check_ingestable(self) -> None:
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")
        if self._needs_recover:
            raise RuntimeError(
                f"durable state found under {self._dur.dir!r}: call "
                "recover() before ingesting (or point durability at an "
                "empty directory)")
        if self._poisoned:
            raise RuntimeError(
                "ingest failed on a durable engine: WAL-logged chunks were "
                "dropped by fail-stop, so in-memory state no longer tracks "
                "the log.  Open a fresh engine on the same directory and "
                "recover() — the WAL replays every accepted chunk.")

    def flush(self) -> None:
        """Block until every queued chunk is committed.  The worker waits
        for each commit on the device, so the state is materialised too.
        Re-raises any background ingest failure since the last flush —
        delivered to exactly one caller when several threads flush
        concurrently.  Failure semantics are fail-stop/at-most-once: once a
        chunk fails, the chunks queued behind it are *discarded* (never
        committed out of order, so snapshots stay committed prefixes) until
        the error is consumed here.  After a clean flush, the state equals
        what synchronous ingest of the same stream would have produced."""
        with self._cv:
            while self._pending:
                self._cv.wait()
            err, self._ingest_error = self._ingest_error, None
        if err is not None:
            raise RuntimeError(f"background ingest failed:\n{err}")

    def close(self) -> None:
        """Commit everything already queued, then stop the worker thread,
        the prepare pool, the query batcher and the durability writers.
        Idempotent; the engine rejects new ingests afterwards (sync
        queries keep working through the direct snapshot path).
        Call ``flush()`` first if you need background failures re-raised."""
        self._close_batcher()
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            with self._cv:
                worker = self._worker
                if worker is not None:
                    self._queue.append(_STOP)
                    self._cv.notify_all()
        if worker is not None:
            worker.join()
        if self._prep_pool is not None:
            self._prep_pool.shutdown(wait=True)
            self._prep_pool = None
        try:
            if self._ckpt is not None:
                self._ckpt.wait()       # re-raises a failed background save
        finally:
            if self._wal is not None:
                self._wal.close()       # ... without leaking the handle

    def _worker_loop(self) -> None:
        """THE chunk loop: pipelined prepare/commit over the live queue.
        While this thread launches and waits on chunk k's commit, the
        prepare pool launches chunks k+1..k+prepare_depth — including
        chunks queued after k started.  Commits always apply in submission
        order (the lookahead deque preserves queue order), so any depth is
        bit-identical to depth 1."""
        self._bind_thread()
        ahead: collections.deque = collections.deque()  # (entry, future)
        while True:
            if ahead:
                entry, fut = ahead.popleft()
            else:
                with self._cv:
                    while not self._queue:
                        self._cv.wait()
                    entry = self._queue.popleft()
                if entry is _STOP:
                    return
                fut = None
            item, rows = entry
            try:
                # Fail-stop: after a failure, drop queued chunks (instead
                # of committing a stream with a hole in it) until flush()
                # consumes the error.
                if self._ingest_error is None:
                    if fut is None:
                        fut = self._submit_prepare(item)
                    # top up the lookahead before blocking on this chunk
                    if self._prep_pool is not None:
                        while len(ahead) < self._prepare_depth:
                            with self._cv:
                                nxt = (self._queue.popleft()
                                       if self._queue and
                                       self._queue[0] is not _STOP else None)
                            if nxt is None:
                                break
                            ahead.append((nxt, self._submit_prepare(nxt[0])))
                    prepared = fut.result() if isinstance(fut, Future) else fut
                    self._commit_one(prepared)
            except BaseException as e:
                with self._cv:
                    self._ingest_error = traceback.format_exc()
                    # A durable engine cannot keep accepting work after a
                    # failed commit: the failed/dropped chunks are already
                    # WAL-logged (= accepted); recover() replays them.
                    if self._dur is not None:
                        self._poison("background commit (chunk accepted)", e)
            finally:
                with self._cv:
                    self._pending -= 1
                    self._pending_rows -= rows
                    self._cv.notify_all()

    def _submit_prepare(self, item: tuple):
        """Dispatch a chunk's prepare: on the pool when pipelined (so it
        overlaps this thread's commit), inline otherwise."""
        if self._prep_pool is not None:
            return self._prep_pool.submit(self._prepare_ready, *item)
        return self._prepare_ready(*item)

    def _commit_one(self, prepared: tuple) -> None:
        faults.fire(self._fault_scope + "engine.commit")
        prep = self._wait_prepared(prepared)
        with self._lock:
            self.state = st = self._commit(self.state, prep)
            self._version += 1
            self._committed_seq += 1
            seq = self._committed_seq
        # Pace the pipeline outside the lock: queries snapshot the new state
        # at once; the worker waits here while the prepare side runs ahead.
        self._pace()
        if (self._dur is not None
                and seq - self._last_snap_seq >= self._dur.snapshot_every):
            self._write_snapshot(st, seq)

    # --- durability --------------------------------------------------------

    def _write_snapshot(self, st, seq: int) -> None:
        """Background snapshot of the committed state at operation ``seq``
        (commit-worker thread; the copy to the host happens here).  The
        previous snapshot — durable by the time the checkpointer accepts a
        new one — releases its WAL segments (compaction) and old snapshot
        dirs."""
        faults.fire(self._fault_scope + "snapshot.save")
        root = self._dur.dir
        if self._snap_inflight is not None:
            self._ckpt.wait()
            self._wal.compact(self._snap_inflight - 1)
            persist.snapshot.prune(root, keep=self._dur.keep_snapshots)
        self._snap_inflight = seq
        persist.snapshot.async_save(self._ckpt, root, seq, st,
                                    fsync=self._dur.fsync)
        self._wal.rotate()
        self._last_snap_seq = seq

    def _durable_mutate(self, kind: int, arrays: dict,
                        fn: Callable[[Any], Any]) -> None:
        """Apply an out-of-band mutation (e.g. a turnstile delete) with WAL
        logging.  Pending chunks are flushed first so the WAL's append
        order equals the apply order (the recovery replay order); the
        record must be replayable by `_apply_wal_record`.  The volatile
        path runs the same flush-first protocol (minus the WAL write), so a
        volatile and a durable engine fed the same operations stay
        bit-identical."""
        with self._submit_lock:
            self._check_ingestable()
            self.flush()
            if self._wal is not None:
                # A failed append may have left a torn record mid-log, so
                # poison rather than invite a retry that would append after
                # garbage bytes; a *transient* fault rejected the op before
                # any bytes landed — cleanly retryable.
                try:
                    self._wal.append([(self._seq, kind, arrays)])
                except BaseException as e:
                    if not faults.is_transient(e):
                        self._poison("wal append (mutation rejected)", e)
                    raise
            # Counters advance once the record is durable; if applying `fn`
            # then fails, the op is on disk and recovery will apply it.
            self._seq += 1
            self._committed_seq += 1
            try:
                self._mutate_state(fn)
            except BaseException as e:
                if self._wal is not None:
                    self._poison("mutation apply (op accepted)", e)
                    e.wal_accepted = True
                raise
            # Mutations count toward the snapshot cadence like commits.
            if (self._dur is not None and self._committed_seq -
                    self._last_snap_seq >= self._dur.snapshot_every):
                with self._lock:
                    st = self.state
                self._write_snapshot(st, self._committed_seq)

    def recover(self) -> int:
        """Restore from the durability directory: load the newest snapshot
        onto the engine's device, then replay the WAL tail through the
        engine's own two-phase prepare/commit path — the recovered state is
        bit-identical to the uninterrupted run.  Torn WAL tails (a crash
        mid-append) are truncated.  Must be called on a fresh engine,
        before any ingest; returns the number of WAL records replayed."""
        if self._dur is None:
            raise RuntimeError("recover() requires a DurabilityConfig")
        faults.fire(self._fault_scope + "engine.recover")
        with self._submit_lock:
            if self._seq or self._version or self._closed:
                raise RuntimeError("recover() must run on a fresh engine")
            root = self._dur.dir
            snap = persist.snapshot.latest_seq(root)
            if snap is not None:
                st = persist.snapshot.load(root, snap, self.state,
                                           self._device)
                with self._lock:
                    self.state = st
                self._seq = self._committed_seq = snap
                self._version = snap
                self._last_snap_seq = snap
            n = 0
            # Streaming replay: one decoded record in memory at a time.
            for rec in self._wal.iter_replay(after=self._committed_seq - 1):
                if rec.seq != self._committed_seq:
                    raise RuntimeError(
                        f"WAL gap: expected seq {self._committed_seq}, "
                        f"found {rec.seq}")
                if rec.kind == persist.KIND_CHUNK:
                    chunk = self._to_device(rec.arrays["xs"])
                    item = self._make_chunk_item(chunk, rec.seq)
                    prep = self._wait_prepared(
                        self._prepare_ready(item, self._ready_event()))
                    with self._lock:
                        self.state = self._commit(self.state, prep)
                        self._version += 1
                else:
                    self._apply_wal_record(rec.kind, rec.arrays)
                self._committed_seq += 1
                self._seq = self._committed_seq
                n += 1
            self._wal.truncate_torn_tail()
            self._needs_recover = False
            self._pace()
            return n

    # --- snapshots, caching, queries ---------------------------------------

    def snapshot(self):
        """Atomically read ``(state, version)`` — the lock-consistent way to
        serve a query batch against one committed prefix."""
        with self._lock:
            return self.state, self._version

    def _query_snapshot_ctx(self):
        """Everything one query tick shares, captured in one consistent
        read (services with per-version caches override to resolve them
        here, so a whole coalesced batch shares one cache entry)."""
        return self.snapshot()

    @property
    def version(self) -> int:
        """Commits applied so far (every commit invalidates `cached`)."""
        with self._lock:
            return self._version

    # --- observability ------------------------------------------------------

    def health(self) -> dict:
        """One consistent health report (DESIGN §14): lifecycle state
        (``live`` / ``poisoned`` / ``needs_recover`` / ``closed``), the
        poison reason if any, durable progress (last committed op seq vs
        next to assign), and ingest-queue depth."""
        with self._cv:
            queue_depth = self._pending
            queued_rows = self._pending_rows
        state = ("closed" if self._closed
                 else "poisoned" if self._poisoned
                 else "needs_recover" if self._needs_recover
                 else "live")
        return {"state": state,
                "poison_reason": self._poison_reason,
                "last_committed_seq": self._committed_seq,
                "next_seq": self._seq,
                "version": self.version,
                "queue_depth": queue_depth,
                "queued_rows": queued_rows,
                "durable": self._dur is not None}

    def stats(self) -> dict:
        """`health()` plus the query-scheduler counters (when batching
        has served anything)."""
        out = self.health()
        if self._batcher is not None:
            out["batcher"] = self._batcher.stats()
        return out

    def cached(self, name: str, version: int, compute: Callable[[], Any]):
        """Memoise a pure function of the snapshot at ``version`` (e.g. the
        SW-AKDE grid-estimate table).  A commit bumps the version, so stale
        entries are never served; concurrent same-version computes are
        benign (identical values, last install wins)."""
        with self._lock:
            ent = self._snap_cache.get(name)
            if ent is not None and ent[0] == version:
                return ent[1]
        val = compute()                      # outside the lock: may be slow
        with self._lock:
            ent = self._snap_cache.get(name)
            if ent is None or ent[0] <= version:
                self._snap_cache[name] = (version, val)
        return val

    def _mutate_state(self, fn: Callable[[Any], Any]) -> None:
        """Apply an out-of-band state update atomically; bumps the version
        so snapshot caches invalidate."""
        with self._lock:
            self.state = fn(self.state)
            self._version += 1

    def _query_blocks(self, fn: Callable[[torch.Tensor], Any],
                      qs: torch.Tensor):
        """Run ``fn`` over ``qs`` in blocks of exactly ``query_block`` rows
        (the last one zero-padded, and B = 0 one padded block) and
        concatenate the result trees, cut back to B rows.  One block shape
        makes every row's answer independent of how rows were batched (see
        the module docstring)."""
        qb = self._query_block
        n = qs.shape[0]
        outs = []
        for i in range(0, max(n, 1), qb):
            blk = qs[i:i + qb]
            m = blk.shape[0]
            if m < qb:
                blk = torch.cat([blk, blk.new_zeros((qb - m,) + blk.shape[1:])])
            out = fn(blk)
            outs.append(out if m == qb else tree_map(lambda a, m=m: a[:m], out))
        if len(outs) == 1:
            return outs[0]
        return tree_unflatten(outs[0], [torch.cat(parts) for parts in
                                        zip(*map(tree_leaves, outs))])
