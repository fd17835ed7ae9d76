"""Durability subsystem: snapshots + write-ahead log for the streaming
engines (DESIGN.md §11).

The port's counterpart of the reference's ``persist`` package, with the
same on-disk formats.  Two cooperating pieces, wired into
`serve.engine.SketchEngine`:

  * `snapshot` — full sketch-state checkpoints over the atomic/async
    `checkpoint` layer, labelled by the engine's operation sequence
    number;
  * `wal` — a chunk-granular write-ahead log appended at ``ingest_async``
    enqueue time, so the stream tail past the newest snapshot is always
    replayable through the engine's own prepare/commit path.

``recover()`` (on the engine) = load latest snapshot + replay the WAL
tail; the result is bit-identical to the uninterrupted run
(tests/test_torch_persist.py, tests/test_torch_services.py).
"""
from __future__ import annotations

import dataclasses

from . import faults, snapshot, wal  # noqa: F401
from .faults import (FaultError, FaultPlan, FaultSpec,  # noqa: F401
                     InjectedDisconnect, InjectedIOError)
from .wal import (KIND_CHUNK, KIND_CLOCK, KIND_DELETE,  # noqa: F401
                  KIND_TENANT_CHUNK, WALRecord, WriteAheadLog)


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    """Durability knobs for a `SketchEngine`.

    ``dir`` — root directory (snapshots in ``step_<seq>/``, WAL segments in
    ``wal/``).  ``snapshot_every`` — background snapshot cadence in
    committed operations (chunks + logged mutations); smaller = shorter
    recovery replay, more checkpoint I/O.  ``fsync`` — fsync every WAL
    append (power-loss durability) instead of flush-only (process-death
    durability; also applied to snapshots, which license WAL compaction).
    ``keep_snapshots`` — completed snapshots retained after compaction
    (min 1: the newest snapshot is what recovery starts from once its WAL
    records are compacted away).  ``fault_scope`` — prefix for this
    engine's fault-injection site names (`persist.faults`); a cluster
    coordinator sets ``worker_<w>/`` so a `FaultPlan` can target one
    worker deterministically."""
    dir: str
    snapshot_every: int = 64
    fsync: bool = False
    keep_snapshots: int = 2
    fault_scope: str = ""

    def __post_init__(self):
        if self.snapshot_every < 1:
            raise ValueError(f"snapshot_every={self.snapshot_every} (< 1)")
        if self.keep_snapshots < 1:
            raise ValueError(
                f"keep_snapshots={self.keep_snapshots}: the newest snapshot "
                "must survive pruning — its covered WAL records are already "
                "compacted away")
