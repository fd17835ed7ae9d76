"""Chunk-granular write-ahead log for the streaming engines (DESIGN.md §11).

The port's own copy of the reference's ``persist/wal.py``: the same record
framing, npz bodies, segment names, rotation and compaction, so each
package replays the other's log (bodies carry zip timestamps, so two logs
of the same records are equal record for record, not byte for byte).

The WAL is the durability half of the engine's two-phase ingest contract:
`serve.engine.SketchEngine` appends one record per ingest chunk *at
enqueue time* (before the chunk becomes visible to the commit worker), so
after a crash the uncommitted tail of the stream is replayable through the
exact same prepare/commit path — recovery is bit-identical to the
uninterrupted run because it *is* the same computation.

Format — append-only segment files ``wal_<index>.log`` under one directory,
each a sequence of CRC-framed records:

    record := header | body
    header := magic u32 | seq u64 | kind u8 | body_len u32 | crc32(body) u32
    body   := an ``.npz`` archive of the record's named numpy arrays

Record ``seq`` numbers are the engine's global operation sequence (chunks
and mutations share one counter) and are strictly increasing across the
whole log.  Replay is tolerant of a *torn tail*: a short or CRC-corrupt
record ends the replay (everything before it is intact), and
`truncate_torn_tail` drops the garbage so post-recovery appends extend the
good prefix.  ``fsync=False`` (the default) flushes to the OS on every
append — surviving process death; ``fsync=True`` additionally survives
host power loss at a per-append fsync cost.

Segments exist for compaction: `rotate()` seals the active segment (the
engine rotates at every snapshot) and `compact(upto)` deletes sealed
segments whose records are all covered by a durable snapshot.
"""
from __future__ import annotations

import io
import os
import pathlib
import struct
import threading
import zlib
from typing import Iterable, Iterator, NamedTuple, Optional

import numpy as np

from ..checkpoint.checkpoint import fsync_path
from . import faults

_MAGIC = 0x53574C31  # "SWL1"
_HEADER = struct.Struct("<IQBII")

# Record kinds.  The engine owns CHUNK; services register their own
# mutation kinds (e.g. RetrievalService's delete-by-value).
KIND_CHUNK = 1
KIND_DELETE = 2
# Tenant-tagged mixed chunk (the reference's serve.tenant_fleet.TenantFleet): body carries
# the chunk plus its per-point tenant ids — same framing, one extra array.
KIND_TENANT_CHUNK = 3
# Coordinator-assigned logical clock advance (serve.kde_service /
# the reference's serve.cluster global-clock option): body carries the target clock.
KIND_CLOCK = 4


class WALRecord(NamedTuple):
    seq: int
    kind: int
    arrays: dict  # name -> np.ndarray


def _encode_body(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def _decode_body(body: bytes) -> dict:
    with np.load(io.BytesIO(body)) as z:
        return {k: z[k] for k in z.files}


class WriteAheadLog:
    """Segmented append-only record log (see module docstring).

    Thread-safe: one internal lock serializes appends / rotation /
    compaction (the engine already orders appends under its submit lock;
    the WAL lock makes maintenance callable from the commit worker too).
    """

    def __init__(self, root: str | os.PathLike, fsync: bool = False,
                 fault_scope: str = ""):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._fsync = bool(fsync)
        self._fault_scope = fault_scope
        self._lock = threading.Lock()
        self._segments = sorted(self.root.glob("wal_*.log"))
        # max record seq per segment — learned from appends and/or replay;
        # compaction only deletes segments whose max is known and covered.
        self._seg_max: dict[pathlib.Path, int] = {}
        self._torn: Optional[tuple[pathlib.Path, int]] = None
        self._fh = None
        # fsync mode: the active segment's *dirent* must also be durable
        # before its first record is acknowledged (POSIX: a new file needs
        # its parent directory fsynced); done once per segment.
        self._dir_synced = False

    # --- write path --------------------------------------------------------

    def _next_index(self) -> int:
        if not self._segments:
            return 0
        return int(self._segments[-1].stem.split("_")[1]) + 1

    def _open_active(self):
        if self._fh is None:
            if not self._segments:
                self._segments.append(self.root / "wal_000000.log")
            self._fh = open(self._segments[-1], "ab")

    def append(self, records: Iterable[tuple[int, int, dict]]) -> None:
        """Durably append ``(seq, kind, arrays)`` records, in order.
        Returns only after the bytes are flushed (+fsynced if configured) —
        the engine calls this *before* publishing a chunk to its queue."""
        with self._lock:
            self._open_active()
            active = self._segments[-1]
            recs = list(records)

            def _tear():
                # Death mid-write: a valid header followed by a truncated
                # body — replay must stop here and `truncate_torn_tail`
                # must drop exactly these bytes.
                if recs:
                    seq, kind, arrays = recs[0]
                    body = _encode_body(arrays)
                    self._fh.write(_HEADER.pack(_MAGIC, seq, kind,
                                                len(body), zlib.crc32(body)))
                    self._fh.write(body[: max(len(body) // 2, 1)])
                    self._fh.flush()

            # Fires before any full record lands: an injected crash here
            # models process death just before the record is durable.
            faults.fire(self._fault_scope + "wal.append", tear=_tear)
            for seq, kind, arrays in recs:
                body = _encode_body(arrays)
                self._fh.write(_HEADER.pack(_MAGIC, seq, kind, len(body),
                                            zlib.crc32(body)))
                self._fh.write(body)
                self._seg_max[active] = int(seq)
            self._fh.flush()
            if self._fsync:
                os.fsync(self._fh.fileno())
                if not self._dir_synced:
                    fsync_path(self.root)
                    self._dir_synced = True

    def rotate(self) -> None:
        """Seal the active segment; the next append opens a fresh one.  The
        engine rotates at every snapshot so `compact` can delete whole
        segments once a later snapshot covers them."""
        faults.fire(self._fault_scope + "wal.rotate")
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            if self._segments and self._segments[-1].exists() \
                    and self._segments[-1].stat().st_size == 0:
                return  # active segment never written — reuse it
            self._segments.append(
                self.root / f"wal_{self._next_index():06d}.log")
            self._dir_synced = False

    def compact(self, upto: int) -> int:
        """Delete sealed segments whose every record has seq <= ``upto``
        (i.e. is covered by a durable snapshot).  The active segment is
        never deleted.  Returns the number of segments removed."""
        faults.fire(self._fault_scope + "wal.compact")
        removed = 0
        with self._lock:
            for p in list(self._segments[:-1]):
                mx = self._seg_max.get(p)
                if mx is not None and mx <= upto:
                    p.unlink(missing_ok=True)
                    self._segments.remove(p)
                    self._seg_max.pop(p, None)
                    removed += 1
        return removed

    # --- read path ---------------------------------------------------------

    def has_records(self) -> bool:
        return any(p.exists() and p.stat().st_size > 0 for p in self._segments)

    def iter_replay(self, after: int = -1) -> Iterator[WALRecord]:
        """Stream every intact record with ``seq > after``, in seq order,
        decoding one record at a time — replaying a long tail holds one
        record in host memory, not the whole log (`replay` keeps the
        list-returning form for small logs and tests).

        Stops at the first torn/corrupt record (remembered for
        `truncate_torn_tail`); segments behind a torn one are unreachable
        by construction (seqs are append-ordered across segments).

        The WAL lock is held until the generator is exhausted or closed;
        do not call other WAL methods mid-iteration (the engine's
        `recover()` drains it in one pass, then truncates any torn tail).
        """
        with self._lock:
            self._torn = None
            for p in self._segments:
                if not p.exists():
                    continue
                good = 0          # offset just past the last intact record
                torn = False
                with open(p, "rb") as f:
                    while True:
                        head = f.read(_HEADER.size)
                        if not head:
                            break                       # clean segment end
                        if len(head) < _HEADER.size:
                            torn = True
                            break
                        magic, seq, kind, blen, crc = _HEADER.unpack(head)
                        if magic != _MAGIC:
                            torn = True
                            break
                        body = f.read(blen)
                        if len(body) < blen or zlib.crc32(body) != crc:
                            torn = True
                            break
                        good += _HEADER.size + blen
                        self._seg_max[p] = int(seq)
                        if seq > after:
                            yield WALRecord(int(seq), int(kind),
                                            _decode_body(body))
                if torn:
                    self._torn = (p, good)
                    return

    def replay(self, after: int = -1) -> list[WALRecord]:
        """Materialized form of `iter_replay` (every record in one list)."""
        return list(self.iter_replay(after))

    def truncate_torn_tail(self) -> None:
        """Drop the garbage bytes found by the last `replay` (and any
        unreachable later segments), so new appends extend the good
        prefix.  No-op when the log ended cleanly."""
        with self._lock:
            if self._torn is None:
                return
            p, good = self._torn
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            with open(p, "ab") as f:
                f.truncate(good)
            for later in self._segments[self._segments.index(p) + 1:]:
                later.unlink(missing_ok=True)
            self._segments = self._segments[:self._segments.index(p) + 1]
            self._torn = None

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
