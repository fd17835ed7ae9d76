"""Sketch-state snapshots over the atomic/async checkpoint layer.

A snapshot is one `checkpoint.checkpoint` directory
(``<root>/step_<seq>/``) holding the full sketch-state pytree; ``seq`` is
the engine's *operation sequence number* at capture time — the number of
WAL records (ingest chunks + logged mutations) already applied.  That
makes the snapshot/WAL contract trivial: a snapshot labelled ``seq``
together with the WAL records ``seq, seq+1, ...`` reconstructs the exact
engine state (DESIGN.md §11.2).

All three sketches' states (and the EH grids inside SW-AKDE) are plain
pytrees of dense arrays, so serialization is the generic checkpoint path:
atomic tmp-file + rename writes, numpy ``.npz`` leaves, dtype-exact
restore onto a device; the layout is the reference's, so each package
loads the other's snapshots.
"""
from __future__ import annotations

import pathlib
import shutil
from typing import Any, Optional

from ..checkpoint import checkpoint


def snapshot_path(root: str | pathlib.Path, seq: int) -> pathlib.Path:
    return pathlib.Path(root) / f"step_{seq}"


def latest_seq(root: str | pathlib.Path) -> Optional[int]:
    """Newest complete (manifest present) snapshot's seq, or None."""
    return checkpoint.latest_step(root)


def save(root: str | pathlib.Path, seq: int, state: Any,
         fsync: bool = False) -> None:
    """Atomic synchronous snapshot of ``state`` at operation ``seq``.
    ``fsync`` must match the WAL's setting: a snapshot only licenses WAL
    compaction at the durability level it was written with."""
    checkpoint.save(snapshot_path(root, seq), {"state": state}, seq,
                    fsync=fsync)


def async_save(ckpt: checkpoint.AsyncCheckpointer, root: str | pathlib.Path,
               seq: int, state: Any, fsync: bool = False) -> None:
    """Background snapshot: the caller thread only pays the copy to the host;
    serialization + atomic rename happen on the checkpointer thread.  The
    previous async save is waited for first (at most one in flight)."""
    ckpt.save(snapshot_path(root, seq), {"state": state}, seq, fsync=fsync)


def load(root: str | pathlib.Path, seq: int, state_like: Any,
         device="cuda") -> Any:
    """Restore the snapshot at ``seq`` into the structure of
    ``state_like``, its tensors on ``device``."""
    tree, _ = checkpoint.restore(snapshot_path(root, seq),
                                 {"state": state_like}, device)
    return tree["state"]


def prune(root: str | pathlib.Path, keep: int = 2) -> int:
    """Delete all but the newest ``keep`` complete snapshots (and any
    orphaned incomplete ones older than them).  Returns dirs removed.

    ``keep`` is clamped to >= 1: the newest snapshot is never deleted —
    by the time prune runs, the WAL records it covers are gone, so
    removing it would make the directory unrecoverable."""
    root = pathlib.Path(root)
    keep = max(1, int(keep))
    steps = []
    for d in root.glob("step_*"):
        try:
            steps.append((int(d.name.split("_")[1]), d))
        except ValueError:
            continue
    steps.sort()
    removed = 0
    for _, d in steps[:-keep]:
        shutil.rmtree(d, ignore_errors=True)
        removed += 1
    return removed
