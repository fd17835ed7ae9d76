"""Atomic, async checkpointing of trees of tensors, in the reference's format.

Format: one ``.npz`` per process (``shard_0.npz``) holding every leaf as a
numpy array (``leaf_<i>``), plus a JSON manifest (step, leaf key strings,
numpy dtype names, shapes).  Writes are atomic (tmp file + rename) and can
run on a background thread (`AsyncCheckpointer`).  The layout is the
reference's ``checkpoint/checkpoint.py``, so each package restores the
other's checkpoints:

* leaf keys are the strings ``jax.tree_util.tree_flatten_with_path`` gives,
  joined by ``/``: dict keys (sorted), NamedTuple field names, sequence
  indices, so ``{"state": SANNState}`` gives ``state/points``,
  ``state/valid``, ...; ``None`` is an empty subtree;
* dtypes are numpy names (``int32``, ``bool``, ``float32``); bfloat16
  leaves are widened to float32 in the file (exact) and narrowed back on
  restore.

`restore` places the leaves on a device (default the card, raising without
one, like every allocating entry point of the port).
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.util import resolve_device


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: tuple = ()):
    """``[(key, leaf), ...]`` in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), prefix + (f,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are taken, in `_flatten`'s
    order, from the iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` (dicts, NamedTuples, lists, tuples), in JAX's
    flattening order."""
    return [leaf for _, leaf in _flatten(tree)]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` with ``leaves`` in `tree_leaves`' order."""
    return _unflatten(like, iter(leaves))


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of ``tree``."""
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array that shares no memory with it (a leaf
    already on the host is copied: the tree may change in place while an
    async write runs); bfloat16 widened to float32 (exact)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy()          # a new tensor already
        a = t.cpu().numpy()
        return a.copy() if t.device.type == "cpu" else a
    return np.array(leaf)


def fsync_path(p: str | pathlib.Path) -> None:
    """fsync a file or directory by path — the POSIX dirent-durability
    idiom (a new/renamed file is only crash-durable once its parent
    directory is fsynced too).  Shared with the WAL (`persist.wal`)."""
    fd = os.open(p, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _host_leaves(tree):
    """``(keys, host arrays, dtype names)`` of a tree's leaves."""
    pairs = _flatten(tree)
    return ([k for k, _ in pairs], [_to_host(leaf) for _, leaf in pairs],
            [_dtype_name(leaf) for _, leaf in pairs])


def _write(path, keys, arrays, dtypes, step: int, fsync: bool) -> None:
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    manifest = {"step": int(step), "keys": keys, "dtypes": dtypes,
                "shapes": [list(a.shape) for a in arrays]}
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
    os.close(fd)
    # savez appends .npz unless the name already ends so
    np.savez(tmp, **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    if fsync:
        fsync_path(pathlib.Path(tmp))
    os.replace(tmp, path / "shard_0.npz")
    mtmp = path / "manifest.json.tmp"
    mtmp.write_text(json.dumps(manifest))
    if fsync:
        fsync_path(mtmp)
    os.replace(mtmp, path / "manifest.json")
    if fsync:
        fsync_path(path)          # the renames themselves ...
        fsync_path(path.parent)   # ... and this step dir's own dirent


def save(path: str | pathlib.Path, tree: Any, step: int,
         fsync: bool = False) -> None:
    """Atomic synchronous save.

    ``fsync=True`` additionally fsyncs the data/manifest files before their
    renames and the directory after — required when a caller treats a
    completed save as surviving *power loss* (the engine's WAL-compaction
    rule deletes log records once a snapshot covering them is durable).
    The default (flush-only) survives process death."""
    _write(path, *_host_leaves(tree), step, fsync)


class AsyncCheckpointer:
    """Background-thread writer: the copy to the host happens on the caller
    thread (so the tree may change in place right after, on the card or on
    the host), the serialization on the worker.

    A failed background write is re-raised on the next ``wait()`` / ``save()``
    instead of dying silently in the worker thread — callers that rely on a
    checkpoint being durable (the engine's WAL compaction) must see it."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _run(self, path, leaves, step: int, fsync: bool) -> None:
        try:
            _write(path, *leaves, step, fsync)
        except BaseException as e:      # surfaced on the next wait()
            self._error = e

    def save(self, path, tree, step: int, fsync: bool = False) -> None:
        self.wait()
        self._thread = threading.Thread(
            target=self._run, args=(path, _host_leaves(tree), step, fsync),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err


def latest_step(root: str | pathlib.Path) -> Optional[int]:
    root = pathlib.Path(root)
    steps = []
    for d in root.glob("step_*"):
        if (d / "manifest.json").exists():
            try:
                steps.append(int(d.name.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore(path: str | pathlib.Path, tree_like: Any,
            device="cuda") -> tuple[Any, int]:
    """Restore into the structure of ``tree_like``, every leaf a tensor on
    ``device`` with the manifest's dtype.  Raises when the checkpoint's
    leaf keys are not ``tree_like``'s."""
    device = resolve_device(device)
    path = pathlib.Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    keys = [k for k, _ in _flatten(tree_like)]
    if keys != manifest["keys"]:
        raise ValueError(f"checkpoint/tree structure mismatch at {path}: "
                         f"{manifest['keys']} vs {keys}")
    out = []
    with np.load(path / "shard_0.npz") as data:
        for i, dt in enumerate(manifest["dtypes"]):
            x = torch.from_numpy(np.require(data[f"leaf_{i}"], requirements="C"))
            want = getattr(torch, dt)
            if x.dtype != want:
                x = x.to(want)       # narrow back (f32 → bf16, exact)
            out.append(x.to(device))
    return _unflatten(tree_like, iter(out)), manifest["step"]
