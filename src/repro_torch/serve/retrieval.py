"""S-ANN retrieval service: streaming index + batched queries (paper §3).

The port of the reference's ``serve/retrieval.py``: documents (or cached
hidden states) arrive as a stream of embeddings; the service maintains the
sublinear S-ANN sketch and answers batched (c, r)-ANN and top-k queries.

Runtime: the service is a `serve.engine.SketchEngine` — the shared
streaming runtime owns the lock, the chunk loop, the two-phase pipelined
ingest (`core.sann.sann_prepare_chunk` for chunk k+1 launched while
`sann_commit_chunk` folds chunk k in, whose tables go through the
`sann_table_scatter` kernel's commit entry), the background queue
(``ingest_async`` / ``flush``), durability and the versioned query
snapshots.  Queries run the fused batch engine, whose scorer is the
`batch_score_topk` kernel's gather entry.

Parameters: drawn from a CPU ``torch.Generator`` seeded with ``cfg.seed``
(so a seed gives the same parameters on every device; they are not the
reference's, whose draws are JAX's), or passed in with ``params=`` (the
reference's, carried across by `convert.params_from_numpy`, as the parity
tests do).  Keep decisions use the reference's key schedule bit for bit:
chunk ``seq`` is kept under ``fold_in(fold_in(PRNGKey(seed + 1), salt),
seq)`` (`core.prng`).

Multi-device sharding is not ported: ``num_shards > 1`` or a ``mesh``
raises `NotImplementedError` (`parallel.sketch_sharding`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import persist
from ..core import prng, sann
from ..parallel import sketch_sharding as ss
from .engine import SketchEngine, durability_from, host_rows


@dataclasses.dataclass
class RetrievalConfig:
    dim: int
    n_max: int = 100_000
    eta: float = 0.5
    r: float = 0.9
    c: float = 2.0
    w: float = 4.0
    L: Optional[int] = 16
    k: Optional[int] = 8
    bucket_cap: int = 16
    seed: int = 0
    # Ingest-key salt: folded into the per-chunk key schedule so workers
    # sharing one `seed` (→ identical LSH params) still draw independent
    # keep decisions.
    ingest_salt: int = 0
    # Batched-ingest chunk: each chunk is one prepare (hash matmul + sort)
    # plus one commit (segment scatter).
    ingest_chunk: int = 1024
    # Two-phase pipelining: prepare chunk k+1 on the engine's prepare thread
    # (a side stream on the card) while chunk k commits.  False = strictly
    # sequential phases (identical results).
    pipelined: bool = True
    # Prepare lookahead depth (bit-identical at any depth).
    prepare_depth: int = 1
    # Query block: queries are served through the fused batch engine in
    # blocks of exactly this many rows (the last one padded).
    query_block: int = 1024
    # Top-k result width for `query_topk` / the "topk" query kind (recall
    # workloads; no (c, r) contract) — capped at L * bucket_cap.
    topk: int = 50
    # Cross-request query micro-batching (DESIGN.md §13); answers stay
    # bit-identical to unbatched calls.
    batch_queries: bool = False
    max_batch: Optional[int] = None
    max_wait_us: float = 200.0
    # Multi-device sharding: not ported (num_shards > 1 or a mesh raises).
    num_shards: int = 0
    mesh: Optional[object] = None
    # Admission control: bound on queued-but-uncommitted rows (None = off).
    max_pending: Optional[int] = None
    # Durability (persist): set ``snapshot_dir`` to WAL-log every ingest
    # chunk at enqueue time and write background state snapshots every
    # ``snapshot_every`` committed operations; ``recover()`` then restores
    # snapshot + WAL tail bit-identically after a crash.
    snapshot_dir: Optional[str] = None
    snapshot_every: int = 64
    wal_fsync: bool = False
    # Fault-injection site-name prefix (persist.faults, DESIGN.md §14).
    fault_scope: str = ""


class RetrievalService(SketchEngine):
    """Thread-safe streaming ANN index with pipelined ingest and batched
    queries (shared runtime: `serve.engine.SketchEngine`).  ``device``
    defaults to the card; ``params`` (optional) are p-stable parameters
    for the resolved config, on ``device``."""

    def __init__(self, cfg: RetrievalConfig, device="cuda", params=None):
        self.service_cfg = cfg
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
        base = sann.SANNConfig(
            dim=cfg.dim, n_max=cfg.n_max, eta=cfg.eta, r=cfg.r, c=cfg.c,
            w=cfg.w, L=cfg.L, k=cfg.k, bucket_cap=cfg.bucket_cap)
        if params is None:
            self.cfg, self.params, state = sann.sann_init(
                base, torch.Generator().manual_seed(cfg.seed), self._device)
        else:
            self.cfg, self.params = base.resolved(), params
            state = sann.sann_empty_state(self.cfg, self._device)
        self.state = state
        # Per-chunk keys are fold_in(base, chunk seq): a pure function of
        # the chunk's global sequence number, so the schedule is identical
        # across sync/async ingest and across crash-recovery replay.
        self._ingest_key = prng.fold_in(
            prng.PRNGKey(cfg.seed + 1, self._device), cfg.ingest_salt)

    # --- engine hooks (two-phase ingest) -----------------------------------

    def _make_chunk_item(self, chunk: torch.Tensor, seq: int) -> tuple:
        return (chunk, prng.fold_in(self._ingest_key, seq))

    def _prepare(self, chunk: torch.Tensor, key: torch.Tensor) -> sann.SANNPrep:
        return ss.sharded_sann_prepare_chunk(self.params, chunk, key,
                                             self.cfg, self._ctx)

    def _commit(self, state: sann.SANNState, prep: sann.SANNPrep):
        return ss.sharded_sann_commit_chunk(state, prep, self.cfg, self._ctx)

    def _delete_fn(self, x: torch.Tensor):
        return lambda st: ss.sharded_sann_delete(st, self.params, x, self.cfg,
                                                 self._ctx)

    def _apply_wal_record(self, kind: int, arrays: dict) -> None:
        if kind == persist.KIND_DELETE:
            self._mutate_state(self._delete_fn(self._to_device(arrays["x"])))
            return
        super()._apply_wal_record(kind, arrays)

    # --- query kinds (micro-batching; engine._BatchedQueryMixin) -----------

    _default_query_kind = "cr"

    def _query_kind_fns(self):
        """Both S-ANN query kinds — the (c, r) contract and the top-k
        recall variant — read one snapshot's state through the fused batch
        engine in ``query_block`` blocks, so a coalesced tick can mix
        them against the same committed prefix."""
        def cr(ctx, qs):
            state, _ = ctx
            return self._query_blocks(lambda b: ss.sharded_sann_query_batch(
                state, self.params, b, self.cfg, self._ctx), qs)

        def topk(ctx, qs):
            state, _ = ctx
            return self._query_blocks(
                lambda b: ss.sharded_sann_query_topk_batch(
                    state, self.params, b, self.cfg, self._ctx,
                    topk=self.service_cfg.topk), qs)

        return {"cr": cr, "topk": topk}

    # --- serving API -------------------------------------------------------

    @property
    def num_shards(self) -> int:
        """Devices the tables are split across (1: the single-device path)."""
        return ss.ctx_num_shards(self._ctx)

    def delete(self, embedding) -> None:
        """Turnstile deletion (paper §3.4).  Pending async chunks are
        flushed first, then the delete applies atomically — so apply order
        equals submission order (and, with durability, WAL order; the
        delete is logged before it applies)."""
        x = host_rows(embedding)
        self._durable_mutate(persist.KIND_DELETE, {"x": x},
                             self._delete_fn(self._to_device(x)))

    def query(self, queries) -> sann.SANNResult:
        """Batched (c, r)-queries (paper §3.3) ``(B, d)`` → `SANNResult` of
        numpy arrays, all blocks against one lock-consistent snapshot of
        the committed state.  With ``batch_queries`` the call is coalesced
        with concurrent clients' queries (bit-identical results)."""
        return self._serve_query("cr", queries)

    def query_topk(self, queries):
        """Batched top-k queries (no (c, r) contract): ``(B, d)`` →
        numpy ``(ids (B, k), dists (B, k))`` with ``k = min(cfg.topk,
        L * bucket_cap)``, padded with id -1 / distance inf."""
        return self._serve_query("topk", queries)

    @property
    def stored(self) -> int:
        return int(self.state.n_stored)

    @property
    def sketch_bytes(self) -> int:
        return sann.sann_bytes(self.cfg)
