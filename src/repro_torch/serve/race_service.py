"""RACE density service: streaming (whole-stream) KDE counters with
pipelined ingest and batched queries (paper §2.3, [CS20]).

The port of the reference's ``serve/race_service.py``: points arrive as a
stream of embeddings, the service maintains the (L, W) RACE counter grid
(`race_hist` kernel in the prepare, one dense add in the commit; SRP
hashing through the `srp_hash` kernel) and answers batched unnormalised KDE
queries.  Deletions are native turnstile decrements (`delete`), WAL-logged
as ``KIND_DELETE`` when durable.

Runtime, durability and micro-batching: `serve.engine.SketchEngine`.
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
from ..core import lsh, race
from ..parallel import sketch_sharding as ss
from .engine import SketchEngine, durability_from, host_rows


@dataclasses.dataclass
class RACEServiceConfig:
    dim: int
    L: int = 32               # sketch rows (repetitions)
    W: int = 128              # LSH range after rehash
    hash_family: str = "srp"  # "srp" (angular) | "pstable" (Euclidean)
    k: int = 2                # concatenation power p
    w: float = 4.0            # p-stable bucket width (pstable only)
    median_of_means: int = 0  # 0/1 = row mean; g > 1 = median of g means
    seed: int = 0
    # Batched-ingest chunk: one prepare/commit pair per chunk.
    ingest_chunk: int = 1024
    # Two-phase pipelining (identical results either way).
    pipelined: bool = True
    # Query block: queries are answered in blocks of exactly this many rows.
    query_block: int = 1024
    # Multi-device sharding: not ported (num_shards > 1 or a mesh raises).
    num_shards: int = 0
    mesh: Optional[object] = None
    # Admission control: bound on queued-but-uncommitted rows (None = off).
    max_pending: Optional[int] = None
    # Cross-request query micro-batching (DESIGN.md §13).
    batch_queries: bool = False
    max_batch: Optional[int] = None
    max_wait_us: float = 200.0
    # Durability (persist): WAL-logged chunks + background snapshots
    # under ``snapshot_dir``; ``recover()`` restores bit-identically.
    snapshot_dir: Optional[str] = None
    snapshot_every: int = 64
    wal_fsync: bool = False
    # Fault-injection site-name prefix (persist.faults, DESIGN.md §14).
    fault_scope: str = ""


def init_params(cfg, generator: torch.Generator, device):
    """LSH params of a service config's ``hash_family`` (shared with
    `serve.kde_service`)."""
    if cfg.hash_family == "srp":
        return lsh.init_srp(generator, cfg.dim, L=cfg.L, k=cfg.k,
                            n_buckets=cfg.W, device=device)
    if cfg.hash_family == "pstable":
        return lsh.init_pstable(generator, cfg.dim, L=cfg.L, k=cfg.k,
                                w=cfg.w, n_buckets=cfg.W, device=device)
    raise ValueError(cfg.hash_family)


class RACEService(SketchEngine):
    """Thread-safe streaming RACE KDE counters with pipelined ingest and
    batched queries (shared runtime: `serve.engine.SketchEngine`)."""

    def __init__(self, cfg: RACEServiceConfig, device="cuda", params=None):
        self.cfg = cfg
        self._ctx = ss.make_service_ctx(cfg.mesh, cfg.num_shards)
        super().__init__(ingest_chunk=cfg.ingest_chunk,
                         query_block=cfg.query_block,
                         pipelined=cfg.pipelined,
                         max_pending=cfg.max_pending,
                         durability=durability_from(cfg),
                         batch_queries=cfg.batch_queries,
                         max_batch=cfg.max_batch,
                         max_wait_us=cfg.max_wait_us,
                         fault_scope=cfg.fault_scope,
                         device=device)
        self.params = params if params is not None else init_params(
            cfg, torch.Generator().manual_seed(cfg.seed), self._device)
        self.state = race.race_init(cfg.L, cfg.W, self._device)

    # --- engine hooks (two-phase ingest) -----------------------------------

    def _prepare(self, chunk: torch.Tensor) -> race.RACEPrep:
        return ss.sharded_race_prepare_chunk(self.params, chunk, self.cfg.W,
                                             self._ctx)

    def _commit(self, state: race.RACEState, prep: race.RACEPrep):
        return ss.sharded_race_commit_chunk(state, prep, self._ctx)

    def _delete_fn(self, xs: torch.Tensor):
        return lambda st: ss.sharded_race_commit_chunk(
            st, self._prepare(xs), self._ctx, sign=-1)

    def _apply_wal_record(self, kind: int, arrays: dict) -> None:
        if kind == persist.KIND_DELETE:
            self._mutate_state(self._delete_fn(self._to_device(arrays["xs"])))
            return
        super()._apply_wal_record(kind, arrays)

    # --- serving API -------------------------------------------------------

    @property
    def num_shards(self) -> int:
        """Devices the rows are split across (1: the single-device path)."""
        return ss.ctx_num_shards(self._ctx)

    def delete(self, embeddings) -> None:
        """Turnstile deletion: decrement the counters for a batch of rows
        ``(B, d)``.  Pending async chunks flush first, then the decrement
        applies atomically (WAL-logged before applying when durable)."""
        xs = np.atleast_2d(host_rows(embeddings))
        self._durable_mutate(persist.KIND_DELETE, {"xs": xs},
                             self._delete_fn(self._to_device(xs)))

    # --- query kinds (micro-batching; engine._BatchedQueryMixin) -----------

    _default_query_kind = "kde"

    def _query_kind_fns(self):
        def kde(ctx, qs):
            state, _ = ctx
            return self._query_blocks(lambda b: ss.sharded_race_query_batch(
                state, self.params, b, self._ctx,
                median_of_means=self.cfg.median_of_means), qs)

        def density(ctx, qs):
            # estimates and n from the *same* snapshot; one fp32 division
            # by max(n, 1), elementwise, as the reference's numpy divide.
            state = ctx[0]
            return kde(ctx, qs) / torch.clamp(state.n.float(), min=1.0)

        return {"kde": kde, "density": density}

    def query(self, queries) -> np.ndarray:
        """Batched unnormalised KDE estimates (Theorem 2.3) ``(B, d)`` →
        numpy ``(B,)`` against one committed snapshot.  With
        ``batch_queries`` the call is coalesced with concurrent clients'
        queries (bit-identical results)."""
        return self._serve_query("kde", queries)

    def kde(self, queries) -> np.ndarray:
        """Normalised density: raw estimate / signed stream size, from one
        snapshot (micro-batched like `query` when ``batch_queries``)."""
        return self._serve_query("density", queries)

    @property
    def count(self) -> int:
        """Signed stream size (insertions - deletions) consumed so far."""
        return int(self.state.n)

    @property
    def sketch_bytes(self) -> int:
        return self.cfg.L * self.cfg.W * 4 + 4
