"""SW-AKDE density service: streaming sliding-window KDE with pipelined
ingest and batched queries (paper §4).

The port of the reference's ``serve/kde_service.py``: points arrive as a
stream of embeddings, the service maintains the sliding-window EH grid
(each commit one launch of the `swakde_segment_pass` kernel's drained
entry; SRP hashing through the `srp_hash` kernel) and answers batched
density queries.

Query-side snapshot cache: the (L, W) grid-estimate table
(`core.swakde.swakde_grid_estimates`) is pure given the committed state, so
the service caches it per commit version (``cache_grid=True``) and serves
every query batch from it — one hash + one table gather per block,
bit-identical to the uncached fused path.  Any commit invalidates the
cache; ``grid_computes`` counts the tables built.

Runtime, durability and micro-batching: `serve.engine.SketchEngine`; the
clock advance (`advance_clock`) is WAL-logged as ``KIND_CLOCK``.
Parameters: drawn from a CPU ``torch.Generator`` seeded with ``cfg.seed``,
or passed in with ``params=`` (the parity tests carry the reference's).
Multi-device sharding is not ported (``num_shards > 1`` raises).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import persist
from ..core import swakde
from ..parallel import sketch_sharding as ss
from .engine import SketchEngine, durability_from
from .race_service import init_params


@dataclasses.dataclass
class KDEServiceConfig:
    dim: int
    L: int = 16              # sketch rows (repetitions)
    W: int = 128             # LSH range after rehash
    window: int = 10_000     # sliding-window length N (stream steps)
    eh_eps: float = 0.1      # per-cell EH relative error eps'
    hash_family: str = "srp"  # "srp" (angular) | "pstable" (Euclidean)
    k: int = 2               # concatenation power p
    w: float = 4.0           # p-stable bucket width (pstable only)
    seed: int = 0
    # Batched-ingest chunk: one prepare/commit pair per chunk.
    ingest_chunk: int = 1024
    # Two-phase pipelining (identical results either way).
    pipelined: bool = True
    # Prepare lookahead depth (bit-identical at any depth).
    prepare_depth: int = 1
    # Skew guard (DESIGN.md §12): bound how many adds one (row, cell)
    # segment absorbs per commit pass; 0 = uncapped.  Bit-identical for
    # any value.
    heavy_cell_cap: int = 0
    # Query block: queries are answered in blocks of exactly this many rows.
    query_block: int = 1024
    # Snapshot cache: memoise the (L, W) grid-estimate table per committed
    # state and serve all query batches from it (bit-identical results
    # either way).
    cache_grid: bool = True
    # Cross-request query micro-batching (DESIGN.md §13), sharing one
    # state snapshot and one grid-cache entry across the coalesced batch.
    batch_queries: bool = False
    max_batch: Optional[int] = None
    max_wait_us: float = 200.0
    # Multi-device sharding: not ported (num_shards > 1 or a mesh raises).
    num_shards: int = 0
    mesh: Optional[object] = None
    # Admission control: bound on queued-but-uncommitted rows (None = off).
    max_pending: Optional[int] = None
    # Durability (persist): WAL-logged chunks + background snapshots
    # under ``snapshot_dir``; ``recover()`` restores bit-identically.
    snapshot_dir: Optional[str] = None
    snapshot_every: int = 64
    wal_fsync: bool = False
    # Fault-injection site-name prefix (persist.faults, DESIGN.md §14).
    fault_scope: str = ""


class KDEService(SketchEngine):
    """Thread-safe streaming sliding-window KDE with pipelined ingest,
    batched queries and a per-commit grid snapshot cache (shared runtime:
    `serve.engine.SketchEngine`)."""

    def __init__(self, cfg: KDEServiceConfig, device="cuda", params=None):
        self.cfg = cfg
        self.sketch_cfg = swakde.SWAKDEConfig(
            L=cfg.L, W=cfg.W, window=cfg.window, eh_eps=cfg.eh_eps,
            heavy_cell_cap=cfg.heavy_cell_cap)
        self._ctx = ss.make_service_ctx(cfg.mesh, cfg.num_shards)
        super().__init__(ingest_chunk=cfg.ingest_chunk,
                         query_block=cfg.query_block,
                         pipelined=cfg.pipelined,
                         prepare_depth=cfg.prepare_depth,
                         max_pending=cfg.max_pending,
                         durability=durability_from(cfg),
                         batch_queries=cfg.batch_queries,
                         max_batch=cfg.max_batch,
                         max_wait_us=cfg.max_wait_us,
                         fault_scope=cfg.fault_scope,
                         device=device)
        self.params = params if params is not None else init_params(
            cfg, torch.Generator().manual_seed(cfg.seed), self._device)
        self.state = swakde.swakde_init(self.sketch_cfg, self._device)
        self.grid_computes = 0

    # --- engine hooks (two-phase ingest) -----------------------------------

    def _prepare(self, chunk: torch.Tensor) -> swakde.SWAKDEPrep:
        return ss.sharded_swakde_prepare_chunk(self.params, chunk,
                                               self.sketch_cfg, self._ctx)

    def _commit(self, state: swakde.SWAKDEState, prep: swakde.SWAKDEPrep):
        return ss.sharded_swakde_commit_chunk(state, prep, self.sketch_cfg,
                                              self._ctx)

    @staticmethod
    def _clock_fn(t: int):
        return lambda st: st._replace(t=torch.clamp(st.t, min=t))

    def _apply_wal_record(self, kind: int, arrays: dict) -> None:
        if kind == persist.KIND_CLOCK:
            self._mutate_state(self._clock_fn(int(np.asarray(arrays["t"]))))
            return
        super()._apply_wal_record(kind, arrays)

    # --- serving API -------------------------------------------------------

    def advance_clock(self, target: int) -> None:
        """Advance the sliding-window clock to ``max(t, target)`` without
        ingesting points — expiring EH buckets exactly as if ``target - t``
        empty stream steps had passed (the reference's coordinator-assigned
        global clock).  Pending async chunks flush first; when durable the
        advance is WAL-logged (``KIND_CLOCK``) and replays bit-identically
        on ``recover()``."""
        t = int(target)
        self._durable_mutate(persist.KIND_CLOCK, {"t": np.asarray(t, np.int32)},
                             self._clock_fn(t))

    @property
    def num_shards(self) -> int:
        """Devices the rows are split across (1: the single-device path)."""
        return ss.ctx_num_shards(self._ctx)

    # --- query kinds (micro-batching; engine._BatchedQueryMixin) -----------

    _default_query_kind = "kde"

    def _grid(self, state):
        with self._lock:
            self.grid_computes += 1
        return ss.sharded_swakde_grid_estimates(state, self.sketch_cfg,
                                                self._ctx)

    def _query_snapshot_ctx(self):
        """One lock-consistent ``(state, version, grid)`` serving a whole
        query tick: with ``cache_grid`` the per-version grid table is
        resolved here — computed at most once per commit and shared by
        every query of the coalesced batch."""
        state, version = self.snapshot()
        grid = None
        if self.cfg.cache_grid:
            grid = self.cached("grid", version, lambda: self._grid(state))
        return state, version, grid

    def _query_kind_fns(self):
        def kde(ctx, qs):
            state, _, grid = ctx
            if grid is not None:
                return self._query_blocks(
                    lambda b: ss.sharded_swakde_query_from_grid(
                        grid, self.params, b, self.sketch_cfg, self._ctx), qs)
            return self._query_blocks(
                lambda b: ss.sharded_swakde_query_batch(
                    state, self.params, b, self.sketch_cfg, self._ctx), qs)

        def density(ctx, qs):
            # Ŷ and the window clock from the *same* snapshot; one fp32
            # division by min(t, N) (at least 1), elementwise.
            state = ctx[0]
            denom = torch.clamp(torch.clamp(state.t, max=self.cfg.window),
                                min=1)
            return kde(ctx, qs) / denom.float()

        return {"kde": kde, "density": density}

    def query(self, queries) -> np.ndarray:
        """Batched unnormalised window-density estimates Ŷ (Thm 4.1)
        ``(B, d)`` → numpy ``(B,)`` against one committed snapshot.  With
        ``batch_queries`` the call is coalesced with concurrent clients'
        queries sharing one grid-cache entry (bit-identical results)."""
        return self._serve_query("kde", queries)

    def density(self, queries) -> np.ndarray:
        """Normalised sliding-window density: Ŷ / min(t, N) — the state and
        the clock come from the *same* snapshot."""
        return self._serve_query("density", queries)

    @property
    def steps(self) -> int:
        """Stream steps consumed so far."""
        return int(self.state.t)

    @property
    def sketch_bytes(self) -> int:
        return swakde.swakde_bytes(self.sketch_cfg)
