"""TenantFleet: many small sketches behind one stacked device state.

The port of the reference's ``serve/tenant_fleet.py``.  The tenant-axis
machinery (`repro_torch.core.fleet`) turns T independent sketches into ONE
stacked state committed in one launch of each kernel a chunk; this module
adds the operational layer that makes "T" elastic:

  * **LRU hot set** — at most ``hot_slots`` tenants live in the stacked
    device state at once (slot map tenant id → row).  Touching a tenant
    (ingest or query) activates it: a free slot if any, else the
    least-recently-used *unpinned* tenant is evicted — its row is copied to
    the host and, when durable, spilled through `persist.snapshot`
    (``<dir>/tenants/t_<id>/step_<seq>``) — and the activated tenant's
    state is loaded (host cache, else newest spill, else empty) into the
    freed row.
  * **Mixed-chunk ingest** — ``ingest(xs, tids)`` takes one chunk tagged
    with per-point tenant ids.  Chunks whose *distinct* tenant set exceeds
    ``hot_slots`` are split (in stream order) into sub-chunks that fit;
    each sub-chunk is one operation: one WAL record, one routed commit.
  * **Durability** — with ``snapshot_dir`` set, every operation appends a
    `persist.KIND_TENANT_CHUNK` WAL record (``xs`` and ``tids``) before
    committing, and the hot stacked state + slot/LRU maps are snapshotted
    every ``snapshot_every`` operations.  ``recover()`` = newest fleet
    snapshot + WAL-tail replay through this same ingest path.  The layout
    and formats are the reference's, so each package recovers the other's
    fleet directory.

Determinism contract (what makes recovery bit-identical): every
state-changing decision in the ingest path — chunk splitting, slot
assignment, LRU victims, spill contents, the S-ANN per-tenant chunk keys
``fold_in(fold_in(base, seq), tenant_id)`` — is a pure function of the WAL
op sequence.  Queries may also activate or evict tenants (they are not
logged); a spill written at op seq ``s`` always holds the tenant's state
after its logged ingests with seq <= ``s``, and activation loads the
newest spill with seq <= the current op seq, so a replay never observes a
future or torn tenant state (DESIGN.md §15.3).

Synchronous by design, as the reference: one lock, no prepare thread —
the fleet's gain is one commit for T tenants, not pipelining.  Parameters
come from a CPU ``torch.Generator`` seeded with ``seed`` (the reference's
are JAX draws), or from ``params=`` (the reference's, carried across by
`convert.params_from_numpy`, as the parity tests do).  Activation writes
the loaded row into the stacked state in place (the fleet owns it; a
functional copy would move the whole stacked state per activation), so
what it hands out never aliases a slot: `tenant_state` and `peek_state`
return copies of rows, and once `stacked` has been read the next activation
first moves the stacked state to new tensors.
"""
from __future__ import annotations

import dataclasses
import pathlib
import shutil
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .. import persist
from ..core import fleet, lsh, prng, race, sann, swakde
from ..core.util import resolve_device
from .engine import to_host

_KINDS = ("race", "swakde", "sann")


@dataclasses.dataclass(frozen=True)
class TenantFleetConfig:
    """Knobs for a `TenantFleet` (the reference's fields and defaults).

    ``kind`` selects the sketch family; ``hot_slots`` is the stacked-state
    tenant capacity T (device memory = T x one sketch); every sketch shares
    one set of LSH params derived from ``seed``.  ``L / W / k`` for RACE
    (SRP) and SW-AKDE (p-stable, plus ``window`` / ``eh_eps`` / ``w`` /
    ``heavy_cell_cap``), the `core.sann.SANNConfig` fields for S-ANN
    (``bucket_cap`` too, which the reference's config leaves at its
    default of 16).
    ``snapshot_dir`` opts into WAL + snapshot durability."""
    kind: str
    dim: int
    hot_slots: int = 8
    seed: int = 0
    # RACE / SW-AKDE
    L: Optional[int] = None
    W: int = 64
    k: Optional[int] = None
    w: float = 1.0
    window: int = 1024
    eh_eps: float = 0.2
    heavy_cell_cap: int = 0
    # S-ANN
    n_max: int = 1024
    eta: float = 0.0
    r: float = 0.5
    c: float = 2.0
    bucket_cap: int = 16     # the port's addition: S-ANN bucket ring size.
                             # The reference's fleets use SANNConfig's 16, so
                             # only a directory written at 16 crosses
                             # packages; `recover` refuses another's tables
    # durability
    snapshot_dir: Optional[str] = None
    snapshot_every: int = 64
    wal_fsync: bool = False

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind={self.kind!r}: expected one of {_KINDS}")
        if self.hot_slots < 1:
            raise ValueError(f"hot_slots={self.hot_slots} (< 1)")


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


def plan_ops(tids, hot_slots: int) -> list[np.ndarray]:
    """Split a mixed batch's tenant ids (stream order) into index blocks
    whose distinct tenant sets fit in ``hot_slots`` — a pure function of the
    id sequence, so a replay re-splits identically."""
    blocks, start, seen = [], 0, set()
    for i, t in enumerate(np.asarray(tids).tolist()):
        if t not in seen:
            if len(seen) == hot_slots:
                blocks.append(np.arange(start, i))
                start, seen = i, set()
            seen.add(t)
    blocks.append(np.arange(start, len(tids)))
    return blocks


def _host_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` on the host, never a view of the fleet.  From the card
    it goes into pinned memory without a host wait: the caller synchronizes
    once for a whole batch of spills."""
    if not x.is_cuda:
        return x.clone()
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return buf.copy_(x, non_blocking=True)


class TenantFleet:
    """Elastic multi-tenant sketch service over one stacked device state.
    ``device`` defaults to the card; ``params`` (optional) are the fleet's
    LSH params on ``device``.  All public methods are thread-safe under one
    lock."""

    def __init__(self, cfg: TenantFleetConfig, device="cuda", params=None):
        self.cfg = cfg
        self._device = resolve_device(device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        dev = self._device
        self._lock = threading.RLock()
        self._base_key = prng.fold_in(prng.PRNGKey(cfg.seed, dev), 1)
        gen = torch.Generator().manual_seed(cfg.seed)
        T = cfg.hot_slots
        if cfg.kind == "race":
            L, k = cfg.L or 8, cfg.k or 4
            self._params = params if params is not None else lsh.init_srp(
                gen, cfg.dim, L, k, cfg.W, device=dev)
            self._empty = race.race_init(L, cfg.W, dev)
        elif cfg.kind == "swakde":
            L, k = cfg.L or 8, cfg.k or 2
            self._scfg = swakde.SWAKDEConfig(
                L=L, W=cfg.W, window=cfg.window, eh_eps=cfg.eh_eps,
                heavy_cell_cap=cfg.heavy_cell_cap)
            self._params = params if params is not None else lsh.init_pstable(
                gen, cfg.dim, L, k, cfg.w, cfg.W, device=dev)
            self._empty = swakde.swakde_init(self._scfg, dev)
        else:
            base = sann.SANNConfig(
                dim=cfg.dim, n_max=cfg.n_max, eta=cfg.eta, r=cfg.r,
                c=cfg.c, w=cfg.w, L=cfg.L, k=cfg.k, bucket_cap=cfg.bucket_cap)
            self._sann_cfg, drawn, self._empty = sann.sann_init(base, gen,
                                                                 dev)
            self._params = drawn if params is None else params
        self._stacked = fleet.fleet_broadcast(self._empty, T)
        self._handed_out = False      # `stacked` was read: copy before writes
        # slot bookkeeping: tenant id -> row, LRU order (oldest first), and
        # the per-slot external ids (-1 = free) for the S-ANN key schedule
        self._slots: dict[int, int] = {}
        self._lru: OrderedDict[int, None] = OrderedDict()
        self._free = list(range(T - 1, -1, -1))       # pop() -> slot 0 first
        self._ext = np.full((T,), -1, np.int64)
        self._cold: dict[int, object] = {}            # host-state cache
        self._seq = 0                                 # applied ingest ops
        # stats
        self.activations = 0
        self.spills = 0
        self.splits = 0
        # durability
        self._wal = None
        self._root: Optional[pathlib.Path] = None
        self._needs_recover = False
        self._last_snap = 0
        if cfg.snapshot_dir is not None:
            self._root = pathlib.Path(cfg.snapshot_dir)
            self._wal = persist.WriteAheadLog(
                self._root / "wal", fsync=cfg.wal_fsync)
            self._needs_recover = (
                persist.snapshot.latest_seq(self._root) is not None
                or self._wal.has_records())

    # --- properties --------------------------------------------------------

    @property
    def params(self):
        return self._params

    @property
    def stacked(self):
        """The hot tenants' stacked state (row = slot).  The tensors stay as
        they are: a later activation writes into a copy."""
        with self._lock:
            self._handed_out = True
            return self._stacked

    @property
    def sketch_cfg(self):
        """The resolved `SWAKDEConfig` / `SANNConfig` (None for RACE)."""
        return {"swakde": getattr(self, "_scfg", None),
                "sann": getattr(self, "_sann_cfg", None)}.get(self.cfg.kind)

    @property
    def empty_state(self):
        """One empty sketch of the fleet's kind, on its device."""
        return self._empty

    @property
    def base_key(self):
        """The S-ANN key schedule's base: operation ``seq`` keeps tenant
        ``t``'s points under ``fold_in(fold_in(base_key, seq), t)``."""
        return self._base_key

    @property
    def seq(self) -> int:
        return self._seq

    @property
    def hot_tenants(self) -> list[int]:
        with self._lock:
            return list(self._lru)

    @property
    def known_tenants(self) -> set[int]:
        with self._lock:
            known = set(self._slots) | set(self._cold)
            if self._root is not None and (self._root / "tenants").exists():
                for d in (self._root / "tenants").glob("t_*"):
                    known.add(int(d.name[2:]))
            return known

    def _row_copy(self, tid: int):
        row = fleet.fleet_row(self._stacked, self._slots[tid])
        return type(row)(*(x.clone() for x in row))

    def tenant_state(self, tid: int):
        """Tenant ``tid``'s sketch (activating it): a copy of its row, which
        later evictions and ingests leave as it is."""
        with self._lock:
            self._activate([tid])
            return self._row_copy(tid)

    def peek_state(self, tid: int):
        """Tenant ``tid``'s sketch without touching the hot set: a copy of its
        row if hot, else its host copy or newest usable spill, else empty."""
        with self._lock:
            if tid in self._slots:
                return self._row_copy(tid)
            if tid in self._cold:
                return self._cold[tid]
            return self._load_row(tid)

    # --- slot management ---------------------------------------------------

    def _tenant_dir(self, tid: int) -> pathlib.Path:
        return self._root / "tenants" / f"t_{tid}"

    def _spill_seqs(self, tid: int) -> list[int]:
        if self._root is None:
            return []
        d = self._tenant_dir(tid)
        if not d.exists():
            return []
        out = []
        for p in d.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def _spill(self, victims: list) -> None:
        """Evict ``victims`` (``(tenant, slot)`` pairs already unmapped):
        copy their rows to the host (pinned memory on the card, one host wait
        for the batch), cache them, and (durable) write a per-tenant
        snapshot labelled with the current op seq.  The content is
        deterministic, so an existing spill at this seq (a replay's
        re-eviction) is kept."""
        rows = [(tid, type(self._empty)(*(_host_copy(x[slot])
                                          for x in self._stacked)))
                for tid, slot in victims]
        if self._device.type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()
        for tid, row in rows:
            self._cold[tid] = row
            if self._root is not None:
                d = self._tenant_dir(tid)
                if not persist.snapshot.snapshot_path(d, self._seq).exists():
                    persist.snapshot.save(d, self._seq, row,
                                          fsync=self.cfg.wal_fsync)

    def _load_row(self, tid: int):
        """Tenant state on activation: host cache, else the newest spill with
        seq <= the current op seq (the replay-safe bound), else empty."""
        if tid in self._cold:
            return self._cold.pop(tid)
        best = None
        for s in self._spill_seqs(tid):
            if s <= self._seq:
                best = s
        if best is not None:
            row = persist.snapshot.load(self._tenant_dir(tid), best,
                                        self._empty, self._device)
            self._check_layout(row, (), f"tenant {tid}'s spill {best}")
            return row
        return self._empty

    def _check_layout(self, state, lead: tuple, what: str) -> None:
        """Refuse a stored state whose shapes are not this fleet's: another
        fleet's sizes, or S-ANN tables of another ``bucket_cap`` (a
        reference fleet's is 16)."""
        for name, x, e in zip(state._fields, state, self._empty):
            want = lead + tuple(e.shape)
            if tuple(x.shape) != want:
                hint = (f"; its S-ANN tables have bucket_cap {x.shape[-1]}, "
                        f"this fleet's config has {self.cfg.bucket_cap}"
                        if name == "tables" and x.shape[-1] != e.shape[-1]
                        else "")
                raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}"
                                 f", this fleet's is {want}{hint}")

    def _activate(self, tids: list[int]) -> None:
        """Make every tenant in ``tids`` hot (len(tids) <= hot_slots),
        evicting LRU victims outside ``tids`` as needed.  The slot and LRU
        decisions are made tenant by tenant, as the reference makes them;
        the victims' rows are then copied out in one batch, before the
        loaded rows are written into their slots (asynchronously on the
        card)."""
        pinned = set(tids)
        victims, loads = [], []
        for tid in tids:
            if tid in self._slots:
                self._lru.move_to_end(tid)
                continue
            if not self._free:
                victim = next(t for t in self._lru if t not in pinned)
                slot = self._slots.pop(victim)
                self._lru.pop(victim)
                self._free.append(slot)
                self._ext[slot] = -1
                self.spills += 1
                victims.append((victim, slot))
            slot = self._free.pop()
            self._slots[tid] = slot
            self._lru[tid] = None
            self._ext[slot] = tid
            self.activations += 1
            loads.append((tid, slot))
        if victims:
            self._spill(victims)
        if loads and self._handed_out:
            self._stacked = type(self._stacked)(*(x.clone()
                                                  for x in self._stacked))
            self._handed_out = False
        for tid, slot in loads:
            for x, r in zip(self._stacked, self._load_row(tid)):
                x[slot].copy_(r, non_blocking=True)

    def _plan_ops(self, tids: np.ndarray) -> list[np.ndarray]:
        """`plan_ops` at this fleet's ``hot_slots``, counting the splits."""
        blocks = plan_ops(tids, self.cfg.hot_slots)
        if len(blocks) > 1:
            self.splits += len(blocks) - 1
        return blocks

    # --- ingest ------------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.clone()

    def _apply_chunk(self, xs: np.ndarray, tids: np.ndarray) -> None:
        """One WAL-recorded operation: activate the chunk's tenants and run
        one routed commit.  ``self._seq`` is the op's seq for spill labels
        and the S-ANN key schedule."""
        uniq = list(dict.fromkeys(tids.tolist()))     # stream order
        self._activate(uniq)
        slot_ids = np.asarray([self._slots[t] for t in tids.tolist()],
                              np.int32)
        counts = np.bincount(slot_ids, minlength=self.cfg.hot_slots)
        cap = _next_pow2(int(counts.max()))
        x = self._to_device(np.asarray(xs, np.float32))
        t = self._to_device(slot_ids)
        kind = self.cfg.kind
        if kind == "race":
            self._stacked = fleet.race_fleet_ingest(self._stacked,
                                                    self._params, x, t)
        elif kind == "swakde":
            self._stacked = fleet.swakde_fleet_ingest(
                self._stacked, self._params, x, t, self._scfg, cap)
        else:
            exts = self._to_device(np.maximum(self._ext, 0).astype(np.int64))
            keys = fleet.sann_fleet_keys(
                prng.fold_in(self._base_key, self._seq), exts)
            self._stacked = fleet.sann_fleet_ingest(
                self._stacked, self._params, x, t, keys, self._sann_cfg, cap)
        self._seq += 1

    def ingest(self, xs, tids) -> None:
        """Ingest one mixed chunk: ``xs (B, dim)`` float32, ``tids (B,)``
        non-negative int tenant ids.  Splits into hot-set-sized operations,
        WAL-logs each (durable mode) and commits each at once."""
        xs = np.asarray(xs, np.float32)
        tids = np.asarray(tids, np.int64)
        if xs.ndim != 2 or xs.shape[0] != tids.shape[0]:
            raise ValueError(f"xs {xs.shape} vs tids {tids.shape}")
        if tids.size and tids.min() < 0:
            raise ValueError("tenant ids must be non-negative")
        if xs.shape[0] == 0:
            return
        with self._lock:
            if self._needs_recover:
                raise RuntimeError(
                    f"{self._root!r} holds recoverable fleet state; call "
                    "recover() before ingesting")
            for idx in self._plan_ops(tids):
                cx, ct = xs[idx], tids[idx]
                if self._wal is not None:
                    self._wal.append(
                        [(self._seq, persist.KIND_TENANT_CHUNK,
                          {"xs": cx, "tids": ct})])
                self._apply_chunk(cx, ct)
            self._maybe_snapshot()

    # --- queries -----------------------------------------------------------

    def _query_blocks(self, qs, tids, run):
        """The shared query path: activate each block's tenants, run the fused
        fleet query on slot ids, copy to the host and scatter results back
        to request order.  ``run(qs_block, slot_ids)`` returns a tensor (or
        a tuple of tensors) with leading axis B; the result is numpy."""
        qs = np.asarray(qs, np.float32)
        tids = np.asarray(tids, np.int64)
        if qs.shape[0] != tids.shape[0]:
            raise ValueError(f"qs {qs.shape} vs tids {tids.shape}")
        with self._lock:
            outs = []
            for idx in self._plan_ops(tids):
                block = tids[idx]
                self._activate(list(dict.fromkeys(block.tolist())))
                slot_ids = np.asarray([self._slots[t] for t in block.tolist()],
                                      np.int32)
                out = run(self._to_device(qs[idx]), self._to_device(slot_ids))
                outs.append((idx, to_host(out)))
        if len(outs) == 1:
            return outs[0][1]
        first = outs[0][1]
        parts = first if isinstance(first, tuple) else (first,)
        merged = []
        for j, p0 in enumerate(parts):
            buf = np.empty((len(tids),) + p0.shape[1:], p0.dtype)
            for idx, o in outs:
                buf[idx] = o[j] if isinstance(first, tuple) else o
            merged.append(buf)
        return tuple(merged) if isinstance(first, tuple) else merged[0]

    def query(self, qs, tids):
        """Per-request sketch estimates: RACE collision estimates, SW-AKDE
        window Ŷ, or S-ANN (c, r)-NN `SANNResult` fields — each request
        served from its own tenant's sketch, one fused read per block."""
        kind, p = self.cfg.kind, self._params
        if kind == "race":
            return self._query_blocks(qs, tids, lambda q, t: fleet.race_fleet_query(
                self._stacked, p, q, t))
        if kind == "swakde":
            return self._query_blocks(qs, tids, lambda q, t: fleet.swakde_fleet_query(
                self._stacked, p, q, t, self._scfg))
        out = self._query_blocks(qs, tids, lambda q, t: tuple(
            fleet.sann_fleet_query(self._stacked, p, q, t, self._sann_cfg)))
        return sann.SANNResult(*out)

    def density(self, qs, tids):
        """Normalised per-tenant KDE reads (RACE / SW-AKDE)."""
        kind, p = self.cfg.kind, self._params
        if kind == "race":
            return self._query_blocks(qs, tids, lambda q, t: fleet.race_fleet_kde(
                self._stacked, p, q, t))
        if kind == "swakde":
            return self._query_blocks(qs, tids, lambda q, t: fleet.swakde_fleet_kde(
                self._stacked, p, q, t, self._scfg))
        raise ValueError("density() is for race/swakde fleets")

    def query_topk(self, qs, tids, topk: int = 50):
        """Per-tenant top-k retrieval (S-ANN fleets): ``(ids (B, k),
        dists (B, k))`` in request order."""
        if self.cfg.kind != "sann":
            raise ValueError("query_topk() is for sann fleets")
        return self._query_blocks(qs, tids, lambda q, t: tuple(
            fleet.sann_fleet_query_topk(self._stacked, self._params, q, t,
                                        self._sann_cfg, topk)))

    # --- durability --------------------------------------------------------

    def _snapshot_like(self):
        """The snapshot's tree structure (the restore reads only its keys)."""
        T = self.cfg.hot_slots
        return {"stacked": self._empty, "ext": np.zeros((T,), np.int32),
                "lru": np.zeros((T,), np.int32)}

    def _maybe_snapshot(self) -> None:
        if (self._root is None
                or self._seq - self._last_snap < self.cfg.snapshot_every):
            return
        self.snapshot()

    def snapshot(self) -> None:
        """Synchronous fleet snapshot (hot stacked state + slot/LRU maps) at
        the current op seq; compacts the WAL behind it and prunes the
        per-tenant spills it supersedes."""
        if self._root is None:
            return
        with self._lock:
            lru = np.full((self.cfg.hot_slots,), -1, np.int32)
            order = list(self._lru)
            lru[:len(order)] = order
            persist.snapshot.save(
                self._root, self._seq,
                {"stacked": self._stacked,
                 "ext": self._ext.astype(np.int32), "lru": lru},
                fsync=self.cfg.wal_fsync)
            self._last_snap = self._seq
            self._wal.compact(self._seq - 1)
            persist.snapshot.prune(self._root, keep=2)
            self._prune_spills(self._seq)

    def _prune_spills(self, snap_seq: int) -> None:
        """Per tenant, spills older than the newest spill with seq <=
        ``snap_seq`` can never be loaded again (every later activation bound
        is >= ``snap_seq``): delete them."""
        tdir = self._root / "tenants"
        if not tdir.exists():
            return
        for d in tdir.glob("t_*"):
            seqs = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
            covered = [s for s in seqs if s <= snap_seq]
            for s in covered[:-1]:
                shutil.rmtree(d / f"step_{s}", ignore_errors=True)

    def recover(self) -> int:
        """Load the newest fleet snapshot and replay the WAL tail through the
        normal ingest path; returns the number of replayed ops.
        Bit-identical to the uninterrupted run."""
        if self._root is None:
            return 0
        with self._lock:
            if self._seq:
                raise RuntimeError("recover() must run on a fresh fleet")
            snap = persist.snapshot.latest_seq(self._root)
            if snap is not None:
                tree = persist.snapshot.load(self._root, snap,
                                             self._snapshot_like(),
                                             self._device)
                self._check_layout(tree["stacked"], (self.cfg.hot_slots,),
                                   f"fleet snapshot {snap}")
                self._stacked = tree["stacked"]
                self._ext = tree["ext"].cpu().numpy().astype(np.int64)
                self._seq = self._last_snap = snap
                self._slots = {int(t): s for s, t in enumerate(self._ext)
                               if t >= 0}
                self._lru = OrderedDict(
                    (int(t), None) for t in tree["lru"].tolist() if t >= 0)
                self._free = [s for s in range(self.cfg.hot_slots - 1, -1, -1)
                              if self._ext[s] < 0]
            n = 0
            for rec in self._wal.iter_replay(after=self._seq - 1):
                if rec.seq != self._seq:
                    raise RuntimeError(
                        f"WAL gap: expected seq {self._seq}, got {rec.seq}")
                if rec.kind != persist.KIND_TENANT_CHUNK:
                    raise RuntimeError(f"unexpected WAL kind {rec.kind}")
                self._apply_chunk(np.asarray(rec.arrays["xs"], np.float32),
                                  np.asarray(rec.arrays["tids"], np.int64))
                n += 1
            self._wal.truncate_torn_tail()
            self._needs_recover = False
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            return n

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
