"""Merge-based multi-worker streaming cluster (DESIGN.md §11.4–11.5).

The port of the reference's ``serve/cluster.py``: the in-process cluster,
every worker one of the port's `SketchEngine` services on one device (the
card by default), each with its own commit worker, prepare thread and, on
the card, side stream; every worker thread binds the card by index (the
engine resolves it).  The coordinator reads the merged state through
worker 0's query kinds, so its answers come in the engine's
``query_block`` blocks, padded, and coalesced answers stay bit-identical.
Fault-injection sites keep the reference's names.

Scales ingest past one engine: N worker `SketchEngine`s (the existing
single-engine services, unchanged) ingest **hash-partitioned substreams**
concurrently — each worker has its own commit worker + prepare thread, so
K workers drive up to 2K host threads — and a coordinator combines the per-worker
sketch states through the merge algebra the cores already expose:

  * RACE      — `core.race.race_merge` (exact counter addition): cluster
                estimates are *bit-identical* to a single engine over the
                whole stream, any partition.
  * SW-AKDE   — `core.swakde.swakde_merge` (canonical DGIM bucket-union):
                bit-identical while nothing has expired from the window;
                once worker windows expire, estimate-level (per-input eps')
                like any EH merge.  Worker clocks tick per *local* point —
                size worker windows as window/K for a balanced partition.
  * S-ANN     — `core.sann.sann_merge` (stamp-interleaved union under the
                paper's n^-eta sampling: a union of independently sampled
                substreams is exactly a sample of the union stream).
                Workers share LSH params (same seed) but salt their keep
                decisions (`ingest_salt`), and the merged sketch equals a
                single engine fed the canonical interleaving
                (tests/test_cluster.py).

Sharded workers: a worker (and the template) may be a service built with
``num_shards > 1`` or a ``mesh``.  The coordinator folds each worker's
state through its single-device form (`SketchEngine.gather_state`) on the
template's first device, merges there, and places the merge on the
template's mesh for its query kinds; `merged_state` returns the
single-device form.  A sharded worker's state equals an unsharded one's,
so the merge and the answers do too.

Merge cadence: the coordinator folds worker snapshots into a cached merged
state whenever the summed worker commit count has advanced by
``merge_every`` since the last merge (checked at submit/flush time), and
*at query time* whenever the cache is stale — so queries always see every
committed chunk, and ``merge_every`` only tunes how much merge latency is
paid inline by queries vs amortised into ingest.  Worker snapshots are
lock-consistent committed prefixes; the merged view is a committed prefix
per worker.

The cluster exposes the same ``ingest`` / ``ingest_async`` / ``flush`` /
query API as the single-engine services, plus per-worker durability:
with ``snapshot_dir`` set, worker w persists under ``<dir>/worker_<w>``
and ``recover()`` recovers every worker (bit-identically) and re-merges.

Query-side micro-batching (DESIGN.md §13): the coordinator owns its own
`engine.QueryBatcher` — with ``batch_queries`` set on the service config,
concurrent client queries coalesce into one fused batch per tick served
from ONE ``merged_snapshot()``.  This matters more here than on a single
engine: a stale merge cache makes every query pay a query-time tail merge
under the coordinator lock, so K concurrent clients used to pay K merges —
the batcher folds them into one merge + one fused call per tick
(tests/test_serve_batching.py pins that query cost does not scale with
the concurrent-client count).  Workers never enable their own batcher
(the coordinator reads them through their query kinds directly).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import persist
from ..core import race, sann, swakde
from ..core.util import saturating_add
from ..parallel import sketch_sharding as ss
from ..persist import faults
from .engine import SketchEngine, _BatchedQueryMixin
from .kde_service import KDEService, KDEServiceConfig
from .race_service import RACEService, RACEServiceConfig
from .retrieval import RetrievalConfig, RetrievalService

_MIX0 = np.uint64(0x9E3779B97F4A7C15)   # splitmix64 golden-ratio constant
_MIX1 = np.uint64(0xFF51AFD7ED558CCD)
_MIX2 = np.uint64(0xC4CEB9FE1A85EC53)


def _mix_u64(xs: np.ndarray) -> np.ndarray:
    """splitmix64-style content hash of each row's raw float32 bit
    patterns: ``xs (B, d) float32`` → ``(B,) uint64``.  A pure function of
    the row's bytes — stable across runs, processes and recovery replays,
    and independent of arrival order."""
    b = np.ascontiguousarray(np.asarray(xs, np.float32)).view(np.uint32)
    with np.errstate(over="ignore"):
        w = (_MIX0 * (np.arange(b.shape[1], dtype=np.uint64) * np.uint64(2)
                      + np.uint64(1)))
        h = (b.astype(np.uint64) * w[None, :]).sum(axis=1)
        h ^= h >> np.uint64(33)
        h *= _MIX1
        h ^= h >> np.uint64(33)
        h *= _MIX2
        h ^= h >> np.uint64(33)
    return h


def hash_partition(xs: np.ndarray, num_workers: int) -> np.ndarray:
    """Deterministic content-hash worker assignment: ``xs (B, d) float32``
    → worker ids ``(B,) int64`` in [0, num_workers).

    The partition is a pure function of the row's bytes (`_mix_u64`) —
    the property the S-ANN "union of samples" merge argument needs: each
    point's owner is fixed, so substreams are disjoint."""
    if num_workers <= 1:
        return np.zeros(len(xs), np.int64)
    return (_mix_u64(xs) % np.uint64(num_workers)).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class FailoverConfig:
    """Worker-failover policy for a `ClusterService` (DESIGN.md §14).

    ``on_degraded`` — query behaviour while any worker is DEAD:
      * ``"fail"``    raise `ClusterDegradedError` (loud, strict);
      * ``"block"``   wait up to ``block_deadline_s`` for the cluster's
        data to be whole again (poisoned workers recovered, every dead
        worker's WAL tail fully re-partitioned), then serve — or raise at
        the deadline;
      * ``"partial"`` serve the live subset, with coverage metadata
        (``worker_coverage < 1``) on every answer.

    ``max_retries``/``backoff_s`` — in-place retries with exponential
    backoff for *transient* faults (`faults.is_transient`), and the
    rebuild-and-`recover()` attempt budget for a poisoned worker.
    ``repartition`` — when a worker is unrecoverable, re-ingest its
    replayable WAL tail into the surviving workers through the normal
    content-hash route (exact for every sketch via the merge algebra;
    §14 has the per-sketch argument).  Passing ``failover=None`` to the
    cluster keeps the legacy fail-stop semantics: the first worker error
    propagates and queries keep re-raising until an operator intervenes.
    """
    on_degraded: str = "fail"        # "fail" | "block" | "partial"
    block_deadline_s: float = 10.0
    max_retries: int = 3
    backoff_s: float = 0.01
    repartition: bool = True

    def __post_init__(self):
        if self.on_degraded not in ("fail", "block", "partial"):
            raise ValueError(f"on_degraded={self.on_degraded!r}")
        if self.max_retries < 0 or self.backoff_s < 0:
            raise ValueError("max_retries/backoff_s must be >= 0")


class ClusterDegradedError(RuntimeError):
    """Raised by queries under the ``fail``/``block`` degraded policies
    while the cluster cannot answer from complete data.  Carries the dead
    worker ids (``.dead``) and whether each one's WAL tail was fully
    re-partitioned (``.salvaged``)."""

    def __init__(self, msg: str, dead: Sequence[int] = (),
                 salvaged: Sequence[int] = ()):
        super().__init__(msg)
        self.dead = sorted(dead)
        self.salvaged = sorted(salvaged)


class ClusterService(_BatchedQueryMixin):
    """Coordinator over N worker engines + a merge function (base class;
    use the sketch-specific subclasses below).

    ``make_worker(w)`` must build workers with *identical* sketch params
    (same seed) — the precondition of every merge.  ``merge_states`` folds
    a list of worker states into one (worker order fixes the canonical
    interleaving for S-ANN).  ``merge_every`` is the proactive merge
    cadence in summed worker commits.  ``batch_queries`` routes the sync
    query wrappers through the coordinator's admission scheduler: one
    merged snapshot (and, when stale, one tail merge) serves the whole
    coalesced batch instead of one per client query."""

    _query_fault_site = "cluster.query"

    def __init__(self, make_worker: Callable[[int], SketchEngine],
                 num_workers: int, merge_every: int,
                 merge_states: Callable[[Sequence], object],
                 snapshot_dir: Optional[str] = None,
                 batch_queries: bool = False,
                 max_batch: Optional[int] = None,
                 max_wait_us: float = 200.0,
                 failover: Optional[FailoverConfig] = None):
        if num_workers < 1:
            raise ValueError(f"num_workers={num_workers}")
        if snapshot_dir is not None:
            self._check_cluster_dir(snapshot_dir, num_workers)
        self._make_worker = make_worker
        self.workers: List[SketchEngine] = [make_worker(w)
                                            for w in range(num_workers)]
        self._merge_every = max(1, int(merge_every))
        self._merge_fn = merge_states
        self._mlock = threading.Lock()
        self._merged = None
        self._merged_versions: Optional[tuple] = None
        self._merged_meta: Optional[dict] = None
        self._merged_epoch = 0
        self._last_merge_total = 0
        # Failover (DESIGN §14).  _flock orders failure handling; it is
        # reentrant because salvage re-ingests through ingest_async, which
        # may itself hit (and handle) another worker's failure.  Lock
        # order: _flock before _mlock, never the reverse.
        self._failover = failover
        self._flock = threading.RLock()
        self._health: List[str] = ["live"] * num_workers
        self._dead: set = set()
        self._salvaged: set = set()      # dead workers whose full WAL tail
        #                                  was re-partitioned (no data lost)
        # Per-dead-worker salvage checkpoint: last WAL seq durably handed
        # to the survivors — a coordinator crash mid-salvage resumes past
        # this prefix instead of re-ingesting the whole log.
        self._salvage_progress: dict = {}
        self._epoch = 0                  # partition epoch: bumps per death
        self._counters = {"retries": 0, "recoveries": 0,
                          "repartitions": 0, "salvaged_records": 0,
                          "salvaged_rows": 0}
        self._meta_path = (None if snapshot_dir is None
                           else pathlib.Path(snapshot_dir) / "cluster.json")
        if self._meta_path is not None and self._meta_path.exists():
            saved = json.loads(self._meta_path.read_text())
            self._dead = set(saved.get("dead_workers", []))
            self._salvaged = set(saved.get("salvage_complete", []))
            self._salvage_progress = {
                int(k): int(v)
                for k, v in saved.get("salvage_progress", {}).items()}
            self._epoch = int(saved.get("epoch", 0))
            for w in self._dead:
                self._health[w] = "dead"
        self._init_query_batching(
            batch_queries, max_batch, max_wait_us,
            default_max_batch=self._ref._query_block)

    @property
    def _ref(self):
        """The *template engine* supplying query kinds, sketch params and
        shape knobs for the coordinator's read path.  Workers share
        identical params (same seed), so any worker serves; the in-process
        cluster uses worker 0."""
        return self.workers[0]

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        """Query rows onto the workers' device (worker 0's placement)."""
        return self._ref._to_device(rows)

    @staticmethod
    def _check_cluster_dir(snapshot_dir: str, num_workers: int) -> None:
        """Refuse to open a durable cluster directory with a different
        worker count than it was written with: hash ownership is a
        function of the count, so a mismatched reopen would silently drop
        the missing workers' WAL-logged data (and mis-route new points).
        The count is pinned in ``cluster.json`` on first open."""
        root = pathlib.Path(snapshot_dir)
        root.mkdir(parents=True, exist_ok=True)
        meta_path = root / "cluster.json"
        # A root holding single-engine durable state (root-level WAL or
        # snapshots) must not be quietly re-pinned as a cluster dir — the
        # workers would open empty worker_* subdirs and the existing index
        # would be silently absent after "recovery".  (The engine-level
        # cluster.json guard covers the converse direction.)
        if any(root.glob("step_*")) or (root / "wal").exists():
            raise RuntimeError(
                f"{snapshot_dir!r} holds single-engine durable state "
                "(root-level snapshots/WAL); a cluster persists under "
                "worker_* subdirectories and cannot recover it.  Use a "
                "fresh directory, or reopen with the single-engine "
                "service.")
        existing = sorted(p.name for p in root.glob("worker_*") if p.is_dir())
        if meta_path.exists():
            saved = json.loads(meta_path.read_text()).get("num_workers")
        elif existing:
            saved = len(existing)        # legacy dir without metadata
        else:
            saved = None
        if saved is not None and saved != num_workers:
            raise RuntimeError(
                f"cluster durability dir {snapshot_dir!r} was written with "
                f"num_workers={saved}, reopened with {num_workers}: hash "
                "partition ownership depends on the worker count, so "
                "recovery would silently lose the other workers' data.  "
                "Reopen with the original count.")
        if saved is None:
            meta_path.write_text(json.dumps({"num_workers": num_workers}))

    # --- ingest ------------------------------------------------------------

    def ingest(self, data) -> None:
        """Hash-partition ``data`` across the workers and wait for every
        chunk to commit (``ingest_async`` + ``flush``)."""
        self.ingest_async(data)
        self.flush()

    def ingest_async(self, data) -> None:
        """Hash-partition ``data (B, d)`` and submit each worker's substream
        to its background ingest queue (order-preserving within a worker).

        Submission interleaves one engine-chunk per worker, round-robin:
        with ``max_pending`` admission control on, a backpressured worker
        then only stalls the cluster once *its own* bound is hit with every
        other queue already fed — submitting whole substreams in worker
        order would instead park the caller inside worker 0's bound while
        workers 1..K-1 sit idle (head-of-line blocking).  Per-worker chunk
        boundaries are identical either way, so states are unchanged."""
        xs = np.asarray(data, np.float32)
        if xs.shape[0] == 0:
            return
        pid = self._partition(xs)
        n = len(self.workers)
        parts = [xs[pid == w] for w in range(n)]
        offs = [0] * n
        pending = True
        while pending:
            pending = False
            for w in range(n):
                if offs[w] >= parts[w].shape[0]:
                    continue
                worker = self.workers[w]
                chunk = parts[w][offs[w]:offs[w] + worker._chunk]
                try:
                    self._with_retries(
                        w, lambda w=w, c=chunk: self.workers[w]
                        .ingest_async(c))
                except BaseException as e:
                    if self._failover is None:
                        raise
                    if self._handle_worker_failure(w, e):
                        # Recovered bit-identically: the failed chunk was
                        # rejected (an ingest_async raise never accepts the
                        # submitted chunk), so resubmitting it — and only
                        # it — is exact.
                        pending = True
                        continue
                    # Unrecoverable: the worker's accepted tail was
                    # re-partitioned by _declare_dead; its unsubmitted
                    # substream (this chunk included) re-routes to the
                    # survivors through the normal dead-aware hash path.
                    rest = parts[w][offs[w]:]
                    offs[w] = parts[w].shape[0]
                    if rest.shape[0]:
                        self.ingest_async(rest)
                    continue
                offs[w] += chunk.shape[0]
                pending = pending or offs[w] < parts[w].shape[0]
        self._maybe_merge()

    def flush(self) -> None:
        """Wait for every worker's queued chunks to commit (re-raising any
        worker's background failure), then apply the merge cadence.

        With failover: a worker whose background commit failed poisoned
        itself with the failing chunk already WAL-logged (accepted), so
        the handler recovers it in place — the replay re-commits the
        chunk, nothing is resubmitted, nothing is lost."""
        for w in range(len(self.workers)):
            if w in self._dead:
                continue
            try:
                self.workers[w].flush()
            except BaseException as e:
                if self._failover is None:
                    raise
                self._handle_worker_failure(w, e)
        self._maybe_merge()

    def close(self) -> None:
        """Drain the coordinator's query batcher, then close every worker.
        Every worker is closed even when some fail (no leaked WAL handles
        or threads behind an early error); all failures are aggregated
        into ONE exception naming the failed workers (`__cause__` = the
        first).  Idempotent: a retry after a partial failure re-closes
        only what is still open (worker close is itself idempotent)."""
        self._close_batcher()
        errs: List[tuple] = []
        for w, worker in enumerate(self.workers):
            try:
                worker.close()
            except BaseException as e:
                errs.append((w, e))
        if errs:
            names = ", ".join(f"worker_{w}" for w, _ in errs)
            err = RuntimeError(
                f"cluster close failed on {len(errs)} worker(s) [{names}]: "
                + "; ".join(f"worker_{w}: {e!r}" for w, e in errs))
            raise err from errs[0][1]

    def recover(self) -> int:
        """Recover every live worker from its durability directory
        (snapshot + WAL replay, bit-identical per worker) and rebuild the
        merged view.  Workers marked dead in ``cluster.json`` (their WAL
        tails were re-partitioned to the survivors in a previous run) are
        skipped — their salvaged data replays from the survivors' logs.
        A salvage a previous coordinator crash left unfinished is resumed
        from its checkpointed prefix (`_resume_salvage`).  Returns the
        total number of WAL records replayed."""
        n = sum(self.workers[w].recover() for w in range(len(self.workers))
                if w not in self._dead)
        self._resume_salvage()
        self._refresh()
        return n

    def _resume_salvage(self) -> None:
        """Finish any re-partition a previous coordinator crash left
        incomplete: a worker that is DEAD but not salvage-complete still
        has replayable WAL records the survivors never received.  The
        resumed salvage skips everything up to the checkpointed progress
        seq (already durable in the survivors' logs), so at most one
        in-flight hand-off batch is re-ingested.  A worker whose log
        genuinely cannot reach back to seq 0 (compacted prefix) re-checks
        as incomplete without re-ingesting anything."""
        fo = self._failover
        if fo is None or not fo.repartition or self._meta_path is None:
            return
        with self._flock:
            for w in sorted(self._dead - self._salvaged):
                try:
                    complete = self._salvage(w)
                except BaseException:
                    complete = False     # still partial: DEAD, resumable
                if complete:
                    self._salvaged.add(w)
                    self._salvage_progress.pop(w, None)
                self._persist_meta()

    # --- failover (DESIGN.md §14) -------------------------------------------

    def _partition(self, xs: np.ndarray) -> np.ndarray:
        """Dead-aware content-hash routing: owner = hash % N as ever; rows
        owned by a dead worker re-route to a live worker picked by an
        independent slice of the same hash — a pure function of (row
        bytes, dead set), so re-routing is identical across retries,
        processes and salvage replays.  The dead set is pinned (with its
        partition epoch) in ``cluster.json``."""
        n = len(self.workers)
        if n == 1:
            if 0 in self._dead:
                raise ClusterDegradedError("no live workers", dead=[0],
                                           salvaged=self._salvaged)
            return np.zeros(len(xs), np.int64)
        h = _mix_u64(xs)
        pid = (h % np.uint64(n)).astype(np.int64)
        if self._dead:
            live = np.array([w for w in range(n) if w not in self._dead],
                            np.int64)
            if live.size == 0:
                raise ClusterDegradedError(
                    "no live workers", dead=sorted(self._dead),
                    salvaged=self._salvaged)
            mask = np.isin(pid, np.fromiter(self._dead, np.int64))
            if mask.any():
                pid[mask] = live[(h[mask] // np.uint64(n))
                                 % np.uint64(live.size)]
        return pid

    def _with_retries(self, w: Optional[int], fn: Callable):
        """Run a worker/coordinator op, retrying *transient* faults
        (`faults.is_transient`) in place with exponential backoff; the
        worker is DEGRADED while retrying and LIVE again on success.
        Non-transient failures (and exhausted budgets) propagate to the
        caller's failure handling.  Safe only for ops whose failure
        rejects the attempted work (WAL appends, merges) — never for a
        failed flush, whose chunk was already accepted."""
        fo = self._failover
        if fo is None:
            return fn()
        delay = fo.backoff_s
        for attempt in range(fo.max_retries + 1):
            try:
                out = fn()
                if w is not None and self._health[w] == "degraded":
                    self._health[w] = "live"
                return out
            except BaseException as e:
                if not faults.is_transient(e) or attempt == fo.max_retries:
                    raise
                if w is not None:
                    self._health[w] = "degraded"
                self._counters["retries"] += 1
                time.sleep(delay)
                delay *= 2

    def _mutate_live(self, w: int, fn: Callable) -> None:
        """Apply a mutation op to live worker ``w`` under failover:
        transient faults retry in place; a hard failure recovers (or
        kills) the worker.  The op is resubmitted after a recovery only
        when it was *rejected* (never WAL-logged): the engine marks the
        raised exception with ``wal_accepted=True`` iff THIS op's record
        hit the log before the failure (`_durable_mutate`) — the worker's
        poison *reason* is never consulted, because it can describe an
        earlier op (e.g. a background commit failure) and would then
        silently drop a rejected mutation.  An *accepted* op already
        replayed from the log, and resubmitting would double-apply it
        (RACE decrements are not idempotent)."""
        try:
            self._with_retries(w, fn)
        except BaseException as e:
            if self._failover is None:
                raise
            accepted = bool(getattr(e, "wal_accepted", False))
            if self._handle_worker_failure(w, e) and not accepted:
                fn()

    def _handle_worker_failure(self, w: int, exc: BaseException) -> bool:
        """Fail over worker ``w``: rebuild a fresh engine on its durability
        directory and `recover()` (bit-identical: snapshot + accepted WAL
        tail) with retries; if unrecoverable, declare it DEAD — salvaging
        its replayable WAL tail into the survivors first (`_declare_dead`).
        Returns True when the worker is LIVE again, False when DEAD."""
        fo = self._failover
        with self._flock:
            if w in self._dead:
                return False
            self._health[w] = "degraded"
            old = self.workers[w]
            durable = old._dur is not None
            try:
                old.close()
            except BaseException:
                pass                     # the old engine is being replaced
            delay = fo.backoff_s
            if durable:
                for attempt in range(max(fo.max_retries, 1)):
                    fresh = None
                    try:
                        fresh = self._make_worker(w)
                        fresh.recover()
                        self.workers[w] = fresh
                        self._health[w] = "live"
                        self._counters["recoveries"] += 1
                        return True
                    except BaseException:
                        if fresh is not None:
                            try:
                                fresh.close()
                            except BaseException:
                                pass
                        time.sleep(delay)
                        delay *= 2
            self._declare_dead(w, exc)
            return False

    def _declare_dead(self, w: int, exc: BaseException) -> None:
        """Mark worker ``w`` DEAD under a new partition epoch, then
        re-partition its replayable WAL tail to the survivors (the dead
        set must be in place first so the salvage re-ingest routes around
        ``w``), and pin the outcome in ``cluster.json``.

        Crash-safety (§14): the dead set + epoch persist *before* salvage
        starts (routing stays dead-aware across a coordinator restart),
        and salvage checkpoints its progress — the last seq durably
        handed to the survivors — into ``cluster.json`` after every
        hand-off.  A coordinator crash mid-salvage therefore resumes
        (`recover()` → `_resume_salvage`) from the checkpointed prefix:
        at-least-once only within the single in-flight hand-off batch,
        never a full-WAL replay, never silent loss."""
        self._health[w] = "dead"
        self._dead.add(w)
        self._epoch += 1
        self._persist_meta()
        complete = False
        if self._failover.repartition and self._meta_path is not None:
            try:
                complete = self._salvage(w)
            except BaseException:
                complete = False         # partial salvage: DEAD, lossy
        if complete:
            self._salvaged.add(w)
            self._salvage_progress.pop(w, None)
        self._persist_meta()

    def _salvage(self, w: int) -> bool:
        """Stream the dead worker's readable WAL records back through the
        cluster's own ingest/delete path (content-hash re-route to the
        survivors).  Exactness per sketch is the merge-algebra argument of
        DESIGN §14: RACE counters add, SW-AKDE buckets union, S-ANN keep
        decisions are per-point functions of (bytes, salt) — so replayed
        rows land exactly as if originally routed there.

        Resumable: records with seq <= the checkpointed salvage progress
        for ``w`` were already durably handed to the survivors (their own
        WALs logged them before the hand-off returned) and are skipped;
        progress re-checkpoints into ``cluster.json`` after every
        hand-off, so a coordinator crash mid-salvage re-ingests at most
        one in-flight batch on resume, not the whole log.  Returns True
        when the *whole* history was replayable (records from seq 0:
        nothing was compacted behind an unloadable snapshot)."""
        wdir = pathlib.Path(self._meta_path.parent) / f"worker_{w}"
        wal = persist.WriteAheadLog(wdir / "wal")
        done = self._salvage_progress.get(w, -1)
        first_seq: Optional[int] = None
        last_seq = done
        nrec = nrows = 0
        buf: List[np.ndarray] = []

        def _checkpoint() -> None:
            # Everything handed off so far is durable on the survivors
            # (ingest_async WAL-logs at enqueue time; deletes log inside
            # _durable_mutate before returning), so last_seq is safe to
            # skip on a post-crash resume.
            self._salvage_progress[w] = last_seq
            self._persist_meta()
            # Coordinator-death stand-in (DESIGN §14): a crash injected
            # here leaves a checkpointed prefix for recover() to resume.
            faults.fire("cluster.salvage")

        def _drain():
            if buf:
                self.ingest_async(np.concatenate(buf))
                buf.clear()
                _checkpoint()

        it = wal.iter_replay()
        try:
            for rec in it:
                if first_seq is None:
                    first_seq = rec.seq
                if rec.seq <= done:
                    continue             # salvaged before a prior crash
                nrec += 1
                if rec.kind == persist.KIND_CHUNK:
                    rows = np.asarray(rec.arrays["xs"], np.float32)
                    nrows += rows.shape[0]
                    buf.append(rows)
                    last_seq = rec.seq
                    if sum(b.shape[0] for b in buf) >= 4096:
                        _drain()
                else:
                    # Order matters: mutations apply after every chunk
                    # logged before them, exactly as the worker would
                    # have replayed.
                    _drain()
                    self.flush()
                    self._salvage_delete(rec.kind, rec.arrays)
                    last_seq = rec.seq
                    _checkpoint()
            _drain()
        finally:
            # Close the (possibly suspended) generator *before* closing
            # the WAL: iter_replay holds the non-reentrant WAL lock across
            # yields, so on a GC-based interpreter — or whenever the loop
            # body raises while the generator stays referenced —
            # wal.close() would otherwise deadlock on that lock while this
            # thread holds _flock, freezing queries and failure handling.
            it.close()
            wal.close()
        if nrec:
            self._counters["repartitions"] += 1
            self._counters["salvaged_records"] += nrec
            self._counters["salvaged_rows"] += nrows
        # Complete iff the log still reaches back to the first op (no
        # snapshot-covered prefix was compacted away — resume skips
        # records but still *observes* the log's true first seq), or
        # nothing was ever written.
        return (first_seq == 0
                or (first_seq is None and done < 0
                    and persist.snapshot.latest_seq(str(wdir)) is None))

    def _salvage_delete(self, kind: int, arrays: dict) -> None:
        """Re-apply a dead worker's logged mutation through the cluster
        API (subclasses with mutation kinds override)."""
        raise NotImplementedError(
            f"cannot re-partition WAL record kind {kind}")

    def _ensure_live(self) -> None:
        """Query-path health gate (failover mode only): recover any
        poisoned worker in place, then apply the ``on_degraded`` policy
        while workers are DEAD.  ``block`` waits for the cluster's data to
        be *whole* — every dead worker fully re-partitioned — not for the
        workers themselves (death is permanent within an epoch)."""
        fo = self._failover
        if fo is None:
            return
        deadline = time.monotonic() + fo.block_deadline_s
        while True:
            with self._flock:
                for w in range(len(self.workers)):
                    if w not in self._dead and self.workers[w]._poisoned:
                        self._handle_worker_failure(
                            w, RuntimeError(self.workers[w]._poison_reason
                                            or "poisoned"))
                if not self._dead or fo.on_degraded == "partial":
                    return
                whole = self._dead <= self._salvaged
                if whole and fo.on_degraded == "block":
                    return
                if fo.on_degraded == "fail" or time.monotonic() >= deadline:
                    raise ClusterDegradedError(
                        f"cluster degraded: workers {sorted(self._dead)} "
                        f"dead ({'fully' if whole else 'not fully'} "
                        "re-partitioned); on_degraded="
                        f"{fo.on_degraded!r}", dead=self._dead,
                        salvaged=self._salvaged)
            # Sleep outside _flock: another thread's failure handling (and
            # its salvage re-ingest) must be able to make progress while a
            # blocked query waits for the data to be whole.
            time.sleep(min(0.05, fo.block_deadline_s / 10 or 0.05))

    def _persist_meta(self) -> None:
        # Atomic replace: salvage checkpoints rewrite this file once per
        # hand-off, and a crash mid-write must never leave a torn
        # cluster.json behind (the next open json-parses it).
        if self._meta_path is None:
            return
        tmp = self._meta_path.with_name(self._meta_path.name + ".tmp")
        tmp.write_text(json.dumps(
            {"num_workers": len(self.workers),
             "dead_workers": sorted(self._dead),
             "salvage_complete": sorted(self._salvaged),
             "salvage_progress": {str(w): s for w, s in
                                  sorted(self._salvage_progress.items())},
             "epoch": self._epoch}))
        tmp.replace(self._meta_path)

    # --- observability ------------------------------------------------------

    @property
    def coverage(self) -> float:
        """Fraction of workers serving queries (< 1 while any is DEAD —
        even after a complete re-partition, which restores the *data* but
        not the worker)."""
        return 1.0 - len(self._dead) / len(self.workers)

    def health(self) -> dict:
        """Coordinator + per-worker health (DESIGN §14): health states,
        dead set + partition epoch, failover counters, and each live
        engine's own `health()` (poison reason, committed seq, queue
        depth)."""
        fo = self._failover
        return {"workers": [
                    {"worker": w, "health": self._health[w],
                     **self.workers[w].health()}
                    for w in range(len(self.workers))],
                "dead_workers": sorted(self._dead),
                "salvage_complete": sorted(self._salvaged),
                "salvage_progress": dict(sorted(
                    self._salvage_progress.items())),
                "epoch": self._epoch,
                "coverage": self.coverage,
                "counters": dict(self._counters),
                "on_degraded": None if fo is None else fo.on_degraded}

    def stats(self) -> dict:
        """`health()` plus the coordinator's query-scheduler counters."""
        out = self.health()
        if self._batcher is not None:
            out["batcher"] = self._batcher.stats()
        return out

    # --- merged view ---------------------------------------------------------

    @property
    def versions(self) -> tuple:
        """Per-worker commit versions (the merge-cadence clock); a DEAD
        worker holds the sentinel ``-1`` (its commits now live in the
        survivors' logs via re-partition)."""
        return tuple(-1 if w in self._dead else self.workers[w].version
                     for w in range(len(self.workers)))

    @property
    def version(self) -> int:
        """Summed live-worker commit count."""
        return sum(v for v in self.versions if v >= 0)

    def _maybe_merge(self) -> None:
        if self.version - self._last_merge_total >= self._merge_every:
            self._refresh()

    def _refresh(self):
        """Fold the live workers' current committed snapshots into the
        merged cache (no-op when the cache already matches).  Returns the
        consistent ``(state, meta, versions)`` triple.  The cache clock is
        ``(versions, epoch)``: the partition epoch bumps on every worker
        death, so a merge that predates a death can never be mistaken for
        fresh (the live sum *drops* when a worker dies — the old
        sum-ordered install guard alone would wedge the cache)."""
        epoch = self._epoch
        live = [w for w in range(len(self.workers)) if w not in self._dead]
        if not live:
            raise ClusterDegradedError("no live workers",
                                       dead=sorted(self._dead),
                                       salvaged=self._salvaged)
        snaps = {w: self.workers[w].snapshot() for w in live}
        # sharded workers fold through their single-device form
        states = [self.workers[w].gather_state(snaps[w][0]) for w in live]
        vers = tuple(-1 if w in self._dead else snaps[w][1]
                     for w in range(len(self.workers)))
        with self._mlock:
            if self._merged_versions == vers and self._merged_epoch == epoch:
                return self._merged, self._merged_meta, vers
            self._with_retries(None, lambda: faults.fire("cluster.merge"))
            # the merge is read through the template's query kinds, so it
            # lies where the template's state does (its mesh, if any)
            merged = self._ref._place_state(self._combine(states, live))
            meta = dict(self._meta(states) or {})
            meta.update(workers_live=len(live),
                        workers_total=len(self.workers),
                        worker_coverage=len(live) / len(self.workers))
            vsum = sum(v for v in vers if v >= 0)
            if (self._merged_versions is None
                    or epoch > self._merged_epoch
                    or (epoch == self._merged_epoch
                        and sum(v for v in self._merged_versions
                                if v >= 0) <= vsum)):
                # Install only if not older than the cache: a racing
                # _refresh whose snapshots were taken later may already
                # have installed a newer merge (live worker versions are
                # monotone within an epoch, so the live sum orders
                # snapshots; across epochs the epoch orders them).
                self._merged = merged
                self._merged_versions = vers
                self._merged_meta = meta
                self._merged_epoch = epoch
                self._last_merge_total = vsum
            return merged, meta, vers

    def merged_snapshot(self):
        """``(state, meta, versions)`` of one consistent merge covering
        every live worker commit: the cached merge when fresh, else a
        query-time merge of the unmerged tails.  Numerator and any
        normalising scalars of one answer must come from a single call —
        state and meta are written together under the merge lock.

        With failover configured this is also the degraded-policy gate:
        poisoned workers are recovered in place first, then the
        ``on_degraded`` policy decides whether a cluster with DEAD workers
        fails, blocks, or serves the live subset (`_ensure_live`)."""
        self._ensure_live()
        epoch = self._epoch
        vers = self.versions
        with self._mlock:
            if self._merged_versions == vers and self._merged_epoch == epoch:
                return self._merged, self._merged_meta, vers
        return self._refresh()

    def merged_state(self):
        """The merged sketch alone, in its single-device form on the
        coordinator's device (see `merged_snapshot`)."""
        return self._ref.gather_state(self.merged_snapshot()[0])

    def _combine(self, states, live):
        """Subclass hook: fold the live workers' snapshot states into one
        merged state (called under ``_mlock`` from `_refresh`).  Default:
        the full ``merge_states`` fold, with the single-worker
        short-circuit.  Overrides must return a result bit-identical to
        the full fold (`ClusterRACEService._combine` folds only counter
        deltas)."""
        if len(states) == 1:
            return states[0]
        return self._merge_fn(states)

    def _meta(self, states) -> Optional[dict]:
        """Subclass hook: scalars to capture alongside a merge (same
        snapshot the merged state came from)."""
        return None

    def _query_state(self, kind: str, st, qs, *extra):
        """Run worker 0's query kind ``kind`` over the merged state ``st``
        (the kind's snapshot context is ``(st, None, *extra)``) — the shared
        read path of every subclass's query API: worker params are
        identical, so worker 0's query kinds serve the merged sketch, in its
        ``query_block`` blocks, padded."""
        return self._ref._kind_fn(kind)((st, None, *extra), qs)

    def _query_snapshot_ctx(self):
        """One consistent merged ``(state, meta, versions)`` triple serving
        a whole query tick — a stale merge cache costs ONE tail merge per
        coalesced batch, not one per client (subclasses with extra
        per-merge caches extend this)."""
        return self.merged_snapshot()

    def _batch_query_block(self) -> int:
        return self._ref._query_block

    @property
    def sketch_bytes(self) -> int:
        """Total sketch footprint across the workers (N replicas of the
        same allocation)."""
        return sum(w.sketch_bytes for w in self.workers)


# ---------------------------------------------------------------------------
# Sketch-specific clusters
# ---------------------------------------------------------------------------

def _worker_cfg(cfg, w: int, **extra):
    """Per-worker config: same seed (identical params), per-worker
    durability subdirectory and fault-injection scope (so a `FaultPlan`
    can target ``worker_<w>/<site>`` deterministically), plus
    sketch-specific fields via ``extra``."""
    sub = (None if getattr(cfg, "snapshot_dir", None) is None
           else f"{cfg.snapshot_dir}/worker_{w}")
    return dataclasses.replace(cfg, snapshot_dir=sub,
                               fault_scope=f"worker_{w}/", **extra)


class ClusterRetrievalService(ClusterService):
    """N-worker S-ANN cluster: hash-partitioned ingest, `sann_merge`-based
    coordinator, single-service query API (`query`, `delete`)."""

    def __init__(self, cfg: RetrievalConfig, num_workers: int = 2,
                 merge_every: int = 8,
                 failover: Optional[FailoverConfig] = None,
                 make_worker: Optional[Callable] = None,
                 device="cuda", params=None):
        def make(w: int) -> RetrievalService:
            # Same seed → identical LSH params (merge precondition); the
            # salt decorrelates the workers' Bernoulli keep decisions.
            # Workers never run their own query batcher — the coordinator
            # coalesces and reads them through their query kinds.
            return RetrievalService(
                _worker_cfg(cfg, w, ingest_salt=w, batch_queries=False),
                device=device, params=params)

        super().__init__(
            make_worker or make, num_workers, merge_every,
            lambda states: functools.reduce(
                lambda a, b: sann.sann_merge(
                    a, b, ss.gather_params(self._ref.params, self._ref._ctx),
                    self._ref.cfg),
                states),
            snapshot_dir=cfg.snapshot_dir,
            batch_queries=cfg.batch_queries,
            max_batch=cfg.max_batch, max_wait_us=cfg.max_wait_us,
            failover=failover)

    _default_query_kind = "cr"

    def _query_kind_fns(self):
        def cr(ctx, qs):
            return self._query_state("cr", ctx[0], qs)

        def topk(ctx, qs):
            return self._query_state("topk", ctx[0], qs)

        return {"cr": cr, "topk": topk}

    def query(self, queries: np.ndarray) -> sann.SANNResult:
        """Batched (c, r)-queries against the merged sketch, in the worker
        engine's ``query_block`` blocks (coalesced with concurrent clients
        when ``batch_queries`` — one merged snapshot per tick)."""
        return self._serve_query("cr", queries)

    def query_topk(self, queries: np.ndarray):
        """Batched top-k queries against the merged sketch (same snapshot
        and micro-batching semantics as `query`)."""
        return self._serve_query("topk", queries)

    def delete(self, embedding: np.ndarray) -> None:
        """Turnstile delete-by-value, broadcast to every worker.

        `sann_delete` tombstones every stored point within ``tol`` of the
        value, so a near-copy with different float bits can live on *any*
        worker (hash ownership is per bit pattern) — routing to the exact
        owner alone would miss it.  Broadcasting reproduces single-engine
        semantics exactly; workers without a match apply a no-op.  Under
        failover the broadcast covers the live workers (a dead worker's
        surviving points were re-partitioned onto them)."""
        x = np.asarray(embedding, np.float32)
        for w in range(len(self.workers)):
            if w not in self._dead:
                self._mutate_live(w, lambda w=w: self.workers[w].delete(x))

    def _salvage_delete(self, kind: int, arrays: dict) -> None:
        if kind != persist.KIND_DELETE:
            return super()._salvage_delete(kind, arrays)
        self.delete(arrays["x"])

    @property
    def stored(self) -> int:
        """Live stored points in the merged sketch (post union-eviction)."""
        return int(self.merged_state().n_stored)


class ClusterKDEService(ClusterService):
    """N-worker SW-AKDE cluster: hash-partitioned ingest, EH bucket-union
    coordinator.  Worker windows tick per local point — configure
    ``window`` as the per-worker span (≈ global window / K for a balanced
    partition); estimates are bit-identical to one engine until window
    expiry, estimate-level after (DESIGN.md §11.5).

    ``global_clock=True`` switches the windows to *stream* time: the
    coordinator keeps a logical clock of total points submitted and, after
    every ingest call, folds it into each live worker
    (`KDEService.advance_clock` — max-monotone, WAL-logged).  Configure
    ``window`` as the full global span; expiry then happens at the
    coordinator's ingest-call granularity (points inside one call still
    tick worker-locally), so per-call streams match a single global-window
    engine exactly (tests/test_cluster.py)."""

    def __init__(self, cfg: KDEServiceConfig, num_workers: int = 2,
                 merge_every: int = 8,
                 failover: Optional[FailoverConfig] = None,
                 global_clock: bool = False,
                 make_worker: Optional[Callable] = None,
                 device="cuda", params=None):
        super().__init__(
            make_worker or (lambda w: KDEService(
                _worker_cfg(cfg, w, batch_queries=False), device=device,
                params=params)),
            num_workers, merge_every,
            lambda states: functools.reduce(
                lambda a, b: swakde.swakde_merge(
                    a, b, self._ref.sketch_cfg),
                states),
            snapshot_dir=cfg.snapshot_dir,
            batch_queries=cfg.batch_queries,
            max_batch=cfg.max_batch, max_wait_us=cfg.max_wait_us,
            failover=failover)
        self.cfg = cfg
        self.global_clock = bool(global_clock)
        self._global_steps = 0
        self._clock_local = threading.local()   # re-entrancy guard
        # cache_grid over the merged sketch: the (L, W) grid-estimate table
        # is pure given the merged state, so it is cached per merged
        # versions tuple (same invalidation clock as the merge cache).
        self._grid = None
        self._grid_versions: Optional[tuple] = None

    def _meta(self, states):
        if self.global_clock:
            # All live clocks were folded to the coordinator's logical
            # clock after the last ingest, so the workers share ONE stream
            # clock (= the max over this snapshot set) and their window
            # coverages overlap instead of summing.
            t = max((int(s.t) for s in states), default=0)
            return {"coverage": min(t, self.cfg.window)}
        # Captured from the *same* snapshots the merged state came from:
        # the density denominator is the number of points the merged grid
        # can still see — each worker contributes its last
        # min(t_w, window) steps (worker windows tick on local clocks), so
        # the coverages sum; summing raw clocks would overestimate density
        # by up to K once the windows saturate.
        return {"coverage": int(sum(min(int(s.t), self.cfg.window)
                                    for s in states))}

    # --- global-clock plumbing ---------------------------------------------

    def ingest_async(self, data) -> None:
        if not self.global_clock:
            return super().ingest_async(data)
        xs = np.asarray(data, np.float32)
        # Failover hand-offs re-enter ingest_async with rows that were
        # already counted (a dead worker's unsubmitted tail, a salvage
        # batch replayed mid-call): only the outermost call advances the
        # logical clock, and only by its own row count.
        outer = not getattr(self._clock_local, "active", False)
        if outer:
            self._clock_local.active = True
            self._global_steps += int(xs.shape[0])
        try:
            super().ingest_async(xs)
        finally:
            if outer:
                self._clock_local.active = False
        if outer:
            self._advance_clocks(self._global_steps)

    def _advance_clocks(self, target: int) -> None:
        """Fold the coordinator clock into every live worker.  The advance
        is max-monotone and WAL-logged per worker (``KIND_CLOCK``), so
        retries, failover recoveries and salvage replays are idempotent."""
        for w in range(len(self.workers)):
            if w in self._dead:
                continue
            try:
                self._with_retries(
                    w, lambda w=w: self.workers[w].advance_clock(target))
            except BaseException as e:
                if self._failover is None:
                    raise
                self._handle_worker_failure(w, e)
        self._maybe_merge()

    def recover(self) -> int:
        n = super().recover()
        if self.global_clock:
            # Every live worker replayed its clock advances; the newest
            # one IS the coordinator clock at the last durable ingest.
            self._global_steps = max(
                (self.workers[w].steps for w in range(len(self.workers))
                 if w not in self._dead), default=0)
        return n

    def _salvage(self, w: int) -> bool:
        if not self.global_clock:
            return super()._salvage(w)
        # Salvaged rows replay a dead worker's log — the coordinator clock
        # counted them when they were first submitted, so the re-ingest
        # must not advance it again.
        outer = not getattr(self._clock_local, "active", False)
        if outer:
            self._clock_local.active = True
        try:
            return super()._salvage(w)
        finally:
            if outer:
                self._clock_local.active = False

    def _salvage_delete(self, kind: int, arrays: dict) -> None:
        if kind != persist.KIND_CLOCK:
            return super()._salvage_delete(kind, arrays)
        # A dead worker's logged clock advance: every survivor received
        # the same coordinator advance already, so re-folding it is a
        # max-monotone no-op — applied anyway for the resume case where a
        # survivor recovered from an older snapshot.
        t = int(np.asarray(arrays["t"]))
        self._advance_clocks(t)

    def _merged_grid(self, st, vers):
        """The (L, W) grid-estimate table of merged state ``st`` (computed
        at most once per merged versions tuple; concurrent same-version
        computes are benign, last install wins)."""
        with self._mlock:
            if self._grid_versions == vers:
                return self._grid
        w0 = self._ref
        grid = ss.sharded_swakde_grid_estimates(st, w0.sketch_cfg, w0._ctx)
        with self._mlock:
            self._grid, self._grid_versions = grid, vers
        return grid

    def _estimates(self, st, vers, queries) -> torch.Tensor:
        """Batched Ŷ against one merged snapshot — from the per-merge grid
        cache when ``cache_grid`` is on (bit-identical either way), else
        the fused engine."""
        grid = self._merged_grid(st, vers) if self.cfg.cache_grid else None
        return self._query_state("kde", st, queries, grid)

    _default_query_kind = "kde"

    def _query_kind_fns(self):
        def kde(ctx, qs):
            st, _, vers = ctx
            return self._estimates(st, vers, qs)

        def density(ctx, qs):
            # coverage and estimates from the *same* merged snapshot; the
            # batch-wide scalar divide keeps coalescing bit-identical.
            st, meta, vers = ctx
            return (self._estimates(st, vers, qs)
                    / max((meta or {}).get("coverage", 0), 1))

        return {"kde": kde, "density": density}

    def query(self, queries: np.ndarray) -> np.ndarray:
        """Batched unnormalised window-density estimates Ŷ against the
        merged grid (coalesced with concurrent clients when
        ``batch_queries`` — one merged snapshot + one grid per tick)."""
        return self._serve_query("kde", queries)

    def density(self, queries: np.ndarray) -> np.ndarray:
        """Normalised density: Ŷ / (summed per-worker window coverage) —
        the coverage and the estimates come from the *same* merged
        snapshot (micro-batched like `query`)."""
        return self._serve_query("density", queries)

    @property
    def steps(self) -> int:
        """Stream steps consumed across the live workers (a dead worker's
        salvaged steps were re-ingested by the survivors).  Under
        ``global_clock`` every live clock equals the coordinator's, so the
        stream length is their max, not their sum."""
        live = [self.workers[w].steps for w in range(len(self.workers))
                if w not in self._dead]
        if self.global_clock:
            return max(live, default=0)
        return sum(live)


class ClusterRACEService(ClusterService):
    """N-worker RACE cluster: hash-partitioned ingest, exact counter-sum
    coordinator — cluster estimates are bit-identical to a single engine
    over the whole stream (tests/test_cluster.py)."""

    def __init__(self, cfg: RACEServiceConfig, num_workers: int = 2,
                 merge_every: int = 8,
                 failover: Optional[FailoverConfig] = None,
                 make_worker: Optional[Callable] = None,
                 device="cuda", params=None):
        super().__init__(
            make_worker or (lambda w: RACEService(
                _worker_cfg(cfg, w, batch_queries=False), device=device,
                params=params)),
            num_workers, merge_every,
            lambda states: functools.reduce(race.race_merge, states),
            snapshot_dir=cfg.snapshot_dir,
            batch_queries=cfg.batch_queries,
            max_batch=cfg.max_batch, max_wait_us=cfg.max_wait_us,
            failover=failover)
        self.cfg = cfg
        # Delta-merge base (under _mlock): the previous merged counters
        # plus each live worker's counters at that merge, keyed by
        # (live set, partition epoch) so any death/re-partition falls
        # back to a full fold.
        self._delta_base = None
        self._delta_fn = self._delta_merge
        self._counters["delta_merges"] = 0
        self._counters["full_merges"] = 0

    @staticmethod
    def _delta_merge(prev_merged_counts, prev_counts, states):
        """``prev_merged + Σ_w (counts_now_w - counts_then_w)``.

        int32 addition is associative/commutative (wrapping included), so
        this equals the full ``reduce(race_merge, states)`` counter fold
        bit-exactly while moving only the *delta* arithmetic; ``n``
        saturates, so it is re-folded from the current scalars directly
        (O(workers) scalar work)."""
        counts = prev_merged_counts
        for prev, st in zip(prev_counts, states):
            counts = counts + (st.counts - prev)
        n = functools.reduce(saturating_add, [st.n for st in states])
        return race.RACEState(counts=counts, n=n)

    def _combine(self, states, live):
        """Incremental coordinator fold: after the first full merge, each
        refresh folds only the counter delta each worker accumulated since
        the last merge.  Falls back to the
        full fold on the first merge, a live-set change, or a partition-
        epoch bump (death/re-partition invalidates the base).  Pinned
        bit-exact against the full fold in tests/test_cluster.py."""
        if len(states) == 1:
            self._delta_base = None
            return states[0]
        key = (tuple(live), self._epoch)
        base = self._delta_base
        if base is not None and base[0] == key:
            merged = self._delta_fn(base[1], base[2], states)
            self._counters["delta_merges"] += 1
        else:
            merged = self._merge_fn(states)
            self._counters["full_merges"] += 1
        self._delta_base = (key, merged.counts,
                            [st.counts for st in states])
        return merged

    _default_query_kind = "kde"

    def _query_kind_fns(self):
        def kde(ctx, qs):
            return self._query_state("kde", ctx[0], qs)

        def density(ctx, qs):
            # counters and n from the *same* merged snapshot; one fp32
            # division by max(n, 1) on the device (no host read of n)
            st = ss.first_shard(ctx[0], self._ref._ctx)
            return kde(ctx, qs) / torch.clamp(st.n.float(), min=1.0)

        return {"kde": kde, "density": density}

    def query(self, queries: np.ndarray) -> np.ndarray:
        """Batched unnormalised KDE estimates against the merged counters
        (coalesced with concurrent clients when ``batch_queries`` — one
        merged snapshot, and at most one tail merge, per tick)."""
        return self._serve_query("kde", queries)

    def kde(self, queries: np.ndarray) -> np.ndarray:
        """Normalised density — counters and ``n`` from the *same* merged
        snapshot (micro-batched like `query`)."""
        return self._serve_query("density", queries)

    def delete(self, embeddings: np.ndarray) -> None:
        """Turnstile decrements, routed to each row's hash owner (dead
        owners re-route to the survivors exactly like ingest — the
        decrement must land where the original increment did or will,
        which the shared dead-aware hash guarantees)."""
        xs = np.atleast_2d(np.asarray(embeddings, np.float32))
        pid = self._partition(xs)
        for w in range(len(self.workers)):
            rows = xs[pid == w]
            if rows.shape[0]:
                self._mutate_live(w, lambda w=w, r=rows:
                                  self.workers[w].delete(r))

    def _salvage_delete(self, kind: int, arrays: dict) -> None:
        if kind != persist.KIND_DELETE:
            return super()._salvage_delete(kind, arrays)
        self.delete(arrays["xs"])

    @property
    def count(self) -> int:
        """Signed stream size across the live workers (a dead worker's
        salvaged rows were re-ingested by the survivors)."""
        return sum(self.workers[w].count for w in range(len(self.workers))
                   if w not in self._dead)
