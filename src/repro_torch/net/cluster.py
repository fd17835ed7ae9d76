"""Coordinator side of the network cluster (DESIGN.md §16): the in-process
merge cluster with its workers as separate *processes* behind the RPC
front door.

The port of the reference's ``net/cluster.py``.  `RPCClusterRetrievalService`
/ `RPCClusterKDEService` / `RPCClusterRACEService` ARE the port's in-process
coordinators (`serve.cluster.Cluster*Service`) with only the worker
construction swapped: ``make_worker(w)`` spawns (or dials) a worker process
and returns a `RemoteEngine` proxy speaking the engine surface over one
RPC channel.  Everything above the worker boundary is shared code: the
splitmix64 content-hash partition (a pure function of row bytes, identical
in every process), the merge fold, merge cadence, and the failover
machinery (DESIGN §14), which retries transient RPC faults in place,
rebuilds a lost worker by **respawning its process** and `recover()`-ing
it from its WAL, and — when respawn is impossible — declares it DEAD and
re-partitions its WAL tail, read off the shared filesystem, to the
survivors.

Exactness: an RPC cluster equals the in-process cluster bit for bit,
because every divergence point is pinned — the same `_worker_cfg(cfg, w,
...)` dict is shipped to worker w and rebuilt there; the coordinator
submits the same engine-chunk slices in the same round-robin order on one
lockstep channel a worker; snapshots travel as ``.npz`` leaves (dtype and
byte exact) and are folded by the same merge on the coordinator's device.
The wire is the reference's, so a port coordinator drives reference workers
(``RPCConfig.peers``) and a reference coordinator drives port workers.

The coordinator keeps a local **template engine** (same config, no
durability, never ingested) on its own device, with the caller's
``params``: it supplies the query and merge functions and the sketch
params of the read path (the `_ref` hook of `ClusterService`).  Spawned
workers get the same params as numpy when the caller passed them, and
otherwise draw them from the config's seed exactly as the template did.

Lifecycle: the constructor starts every worker process at once (spawn
context, daemon children) and then connects to each in turn; `close()`
SHUTDOWNs and reaps every process even when some fail, and a constructor
that fails mid-startup reaps the processes it started before re-raising.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import convert
from ..checkpoint.checkpoint import tree_leaves, tree_unflatten
from ..serve.cluster import (ClusterKDEService, ClusterRACEService,
                             ClusterRetrievalService, FailoverConfig,
                             _worker_cfg)
from ..serve.kde_service import KDEService, KDEServiceConfig
from ..serve.race_service import RACEService, RACEServiceConfig
from ..serve.retrieval import RetrievalConfig, RetrievalService
from . import protocol as P
from . import worker as W

# `RemoteEngine._dur` sentinel: the failover layer only asks "is this
# worker durable?" (`old._dur is not None`) — the actual durability config
# lives in the worker process.
_REMOTE_DURABLE = object()


@dataclasses.dataclass(frozen=True)
class RPCConfig:
    """Network knobs for an RPC cluster.

    ``rpc_timeout_s`` bounds every request/reply round trip; a timed-out
    channel is *broken* (a late reply would desync the framing) and the
    worker goes through failover.  ``connect_retries``/``connect_backoff_s``
    retry the initial connect+handshake with exponential backoff.
    ``respawn`` — whether failover may restart a lost worker's process
    (False forces the DEAD + WAL-tail re-partition path).  ``peers`` —
    connect to externally-started workers (`worker.run_worker` in another
    terminal or host, or a reference worker) instead of spawning: one
    ``(host, port)`` per worker.
    """
    host: str = "127.0.0.1"
    rpc_timeout_s: float = 300.0
    connect_retries: int = 3
    connect_backoff_s: float = 0.2
    spawn_timeout_s: float = 300.0
    respawn: bool = True
    peers: Optional[Sequence[Tuple[str, int]]] = None


def _leaf_tensor(a: np.ndarray, like: torch.Tensor, i: int) -> torch.Tensor:
    """Wire leaf ``i`` as a tensor on ``like``'s device; a leaf of another
    dtype or shape than the template's is a peer fault, refused loudly."""
    t = torch.from_numpy(np.asarray(a))
    if t.dtype != like.dtype or t.shape != like.shape:
        raise P.ProtocolError(
            f"snapshot leaf {i}: {a.dtype}{list(a.shape)} from the worker, "
            f"the template holds {like.dtype}{list(like.shape)}")
    return t.to(like.device)


def _stop_process(proc) -> None:
    """Terminate a worker process that was never shut down cleanly (a
    failed startup or a coordinator backstop), then reap it."""
    if proc is not None and proc.is_alive():
        proc.terminate()
    W.reap_process(proc)


class RemoteEngine:
    """Client-side proxy for one worker process, speaking the
    `SketchEngine` surface the cluster coordinator drives.

    Mutations (`ingest_async`, `flush`, `delete`, `advance_clock`,
    `recover`) are one RPC each; `snapshot()` pulls the worker's committed
    state as npz leaves and rebuilds the state tree on the template's
    device.  Worker-side failures arrive as `protocol.RemoteError`
    carrying the failover markers (``transient``, ``wal_accepted``), so
    `ClusterService._with_retries` / `_mutate_live` work unchanged.
    Channel-level failures mark the channel broken; the proxy then reads
    as poisoned and the coordinator's failover rebuilds it (respawn) or
    declares it dead (salvage)."""

    def __init__(self, channel: P.Channel, template, proc=None,
                 durable: bool = False):
        self._ch = channel
        self._tpl = template
        self.proc = proc
        self._chunk = template._chunk
        self._query_block = template._query_block
        self._dur = _REMOTE_DURABLE if durable else None
        self._closed = False
        self._last_health: Optional[dict] = None

    # --- engine surface -----------------------------------------------------

    def ingest_async(self, chunk) -> None:
        self._ch.call(P.K_INGEST,
                      arrays={"xs": np.asarray(chunk, np.float32)})

    def flush(self) -> None:
        self._ch.call(P.K_FLUSH)

    def delete(self, x) -> None:
        self._ch.call(P.K_DELETE, arrays={"x": np.asarray(x, np.float32)})

    def advance_clock(self, target: int) -> None:
        self._ch.call(P.K_ADVANCE_CLOCK, {"target": int(target)})

    def recover(self) -> int:
        meta, _ = self._ch.call(P.K_RECOVER)
        return int(meta["replayed"])

    def snapshot(self):
        meta, arrays = self._ch.call(P.K_SNAPSHOT)
        # a worker sends its state in single-device form (`gather_state`)
        like_tree = self._tpl.gather_state(self._tpl.state)
        like = tree_leaves(like_tree)
        n = int(meta["num_leaves"])
        if n != len(like):
            raise P.ProtocolError(
                f"snapshot from {self._ch.remote} has {n} leaves, the "
                f"template's state {len(like)}")
        leaves = [_leaf_tensor(arrays[f"l{i}"], t, i)
                  for i, t in enumerate(like)]
        return tree_unflatten(like_tree, leaves), int(meta["version"])

    @staticmethod
    def gather_state(state):
        """Snapshots arrive in single-device form already."""
        return state

    def query(self, queries, kind: Optional[str] = None):
        """Direct worker-local query (not the merged cluster view) — the
        per-worker substream answer as numpy leaves, mainly for tooling
        and tests."""
        meta, arrays = self._ch.call(
            P.K_QUERY, {"kind": kind},
            arrays={"qs": np.asarray(queries, np.float32)})
        return [arrays[f"l{i}"] for i in range(int(meta["num_leaves"]))]

    def _health_rpc(self) -> dict:
        meta, _ = self._ch.call(P.K_HEALTH)
        self._last_health = meta
        return meta

    def health(self) -> dict:
        """Worker health; a worker behind a broken channel reports itself
        poisoned (like an in-process poisoned engine still does) instead
        of raising — the coordinator's `health()` polls dead workers
        too."""
        if self._ch.broken is not None:
            return {"state": "poisoned",
                    "poison_reason": f"rpc channel broken: "
                                     f"{self._ch.broken}"}
        try:
            return self._health_rpc()
        except (P.ProtocolError, OSError) as e:
            return {"state": "poisoned",
                    "poison_reason": f"rpc health poll failed: {e!r}"}

    def stats(self) -> dict:
        """The worker's `stats()`; a port worker adds its process's kernel
        launch counts under ``launches``."""
        meta, _ = self._ch.call(P.K_STATS)
        return meta

    def close(self) -> None:
        """Graceful SHUTDOWN + channel close + process reap.  Idempotent;
        the process is reaped even when the shutdown RPC fails, and a
        remote close failure re-raises afterwards (the cluster's close
        aggregates it)."""
        if self._closed:
            return
        self._closed = True
        err: Optional[BaseException] = None
        try:
            if self._ch.broken is None:
                self._ch.call(P.K_SHUTDOWN)
        except (P.ProtocolError, OSError):
            pass                        # the process is reaped below
        except Exception as e:
            err = e
        finally:
            self._ch.close()
            W.reap_process(self.proc)
        if err is not None:
            raise err

    # --- polled properties --------------------------------------------------

    @property
    def version(self) -> int:
        # Fail-stop read: a broken channel raises here (unlike health()).
        return int(self._health_rpc()["version"])

    @property
    def steps(self) -> int:
        return int(self._health_rpc().get("steps", 0))

    @property
    def count(self) -> int:
        return int(self._health_rpc().get("count", 0))

    @property
    def stored(self) -> int:
        return int(self._health_rpc().get("stored", 0))

    @property
    def sketch_bytes(self) -> int:
        return self._tpl.sketch_bytes      # same allocation, same config

    @property
    def _poisoned(self) -> bool:
        return self.health().get("state") == "poisoned"

    @property
    def _poison_reason(self) -> Optional[str]:
        if self._ch.broken is not None:
            return f"rpc channel broken: {self._ch.broken}"
        return (self._last_health or {}).get("poison_reason")


class _RPCClusterMixin:
    """Worker-construction override shared by the three RPC coordinators:
    start every worker at once, connect with retry+backoff, respawn on
    failover, reap on startup failure and on close.  Subclasses set
    ``_service_kind`` and ``_worker_cfg_extra``."""

    _service_kind = ""

    def _rpc_setup(self, cfg, template, rpc: Optional[RPCConfig],
                   num_workers: int, params) -> None:
        self._procs: dict = {}
        self._remotes: dict = {}
        self._spawned_once: set = set()
        self._starting: dict = {}
        self._rpc = rpc or RPCConfig()
        self._template = template
        self._base_cfg = cfg
        self._rpc_durable = cfg.snapshot_dir is not None
        self._worker_device = str(template._device)
        self._worker_params = (None if params is None
                               else convert.to_numpy(params))
        if self._rpc.peers is None:
            for w in range(num_workers):
                self._starting[w] = self._start(w)
                self._procs[w] = self._starting[w][0]

    @property
    def _ref(self):
        return self._template

    def _worker_cfg_extra(self, w: int) -> dict:
        return dict(batch_queries=False)

    def _start(self, w: int):
        wcfg = dataclasses.asdict(
            _worker_cfg(self._base_cfg, w, **self._worker_cfg_extra(w)))
        return W.start_worker(self._service_kind, wcfg, self._worker_device,
                              self._worker_params, host=self._rpc.host)

    def _remote_worker(self, w: int) -> RemoteEngine:
        """``make_worker`` for the RPC cluster: take (or dial) worker
        ``w`` and return its proxy.  On a failover *rebuild* (the worker
        was built once already) this respawns the process — the old
        proxy's `close()` reaped the old one — unless ``respawn`` is off
        or the worker is an external peer, in which case the rebuild
        fails and the failover layer falls through to DEAD + salvage."""
        rc = self._rpc
        first = w not in self._spawned_once
        if not first and rc.peers is not None:
            raise RuntimeError(
                f"worker {w} is an external peer; the coordinator cannot "
                "respawn it")
        if not first and not rc.respawn:
            raise RuntimeError(
                f"worker {w} lost and respawn is disabled "
                "(RPCConfig.respawn=False)")
        self._spawned_once.add(w)
        proc = None
        if rc.peers is not None:
            host, port = rc.peers[w]
        else:
            host = rc.host
            proc, rx = self._starting.pop(w, None) or self._start(w)
            self._procs[w] = proc
            port = W.wait_worker(proc, rx, rc.spawn_timeout_s)
        try:
            ch = self._connect(host, port, scope=f"worker_{w}/")
        except BaseException:
            _stop_process(proc)
            self._procs.pop(w, None)
            raise
        eng = RemoteEngine(ch, self._template, proc=proc,
                           durable=self._rpc_durable)
        self._remotes[w] = eng
        return eng

    def _connect(self, host: str, port: int, scope: str) -> P.Channel:
        rc = self._rpc
        delay = rc.connect_backoff_s
        for attempt in range(rc.connect_retries + 1):
            try:
                return P.Channel(host, port, timeout_s=rc.rpc_timeout_s,
                                 fault_scope=scope)
            except (OSError, P.ProtocolError):
                if attempt == rc.connect_retries:
                    raise
                time.sleep(delay)
                delay *= 2

    def _reap_all(self) -> None:
        """Close every channel and collect every worker process this
        coordinator ever created — the mid-startup failure path (no
        orphan PIDs when a connect fails after some workers started) and
        the close() backstop.  A process still alive here was never shut
        down cleanly (`close()` shut the others down), so it is terminated
        at once."""
        for eng in list(self._remotes.values()):
            eng._ch.close()
        for _, rx in self._starting.values():
            rx.close()
        self._starting.clear()
        for proc in list(self._procs.values()):
            _stop_process(proc)
        self._procs.clear()

    def _abort_startup(self) -> None:
        self._reap_all()
        self._template.close()

    def close(self) -> None:
        try:
            super().close()
        finally:
            self._reap_all()
            self._template.close()


class RPCClusterRetrievalService(_RPCClusterMixin, ClusterRetrievalService):
    """N-process S-ANN cluster behind the RPC front door (bit-exact vs
    `ClusterRetrievalService`)."""

    _service_kind = "retrieval"

    def __init__(self, cfg: RetrievalConfig, num_workers: int = 2,
                 merge_every: int = 8,
                 failover: Optional[FailoverConfig] = None,
                 rpc: Optional[RPCConfig] = None,
                 device="cuda", params=None):
        template = RetrievalService(dataclasses.replace(
            cfg, snapshot_dir=None, batch_queries=False), device=device,
            params=params)
        try:
            self._rpc_setup(cfg, template, rpc, num_workers, params)
            super().__init__(cfg, num_workers, merge_every=merge_every,
                             failover=failover,
                             make_worker=self._remote_worker)
        except BaseException:
            self._abort_startup()
            raise

    def _worker_cfg_extra(self, w: int) -> dict:
        return dict(ingest_salt=w, batch_queries=False)


class RPCClusterKDEService(_RPCClusterMixin, ClusterKDEService):
    """N-process SW-AKDE cluster behind the RPC front door (bit-exact vs
    `ClusterKDEService`, including the ``global_clock`` stream-time
    option — clock advances are one RPC per worker per ingest call)."""

    _service_kind = "kde"

    def __init__(self, cfg: KDEServiceConfig, num_workers: int = 2,
                 merge_every: int = 8,
                 failover: Optional[FailoverConfig] = None,
                 global_clock: bool = False,
                 rpc: Optional[RPCConfig] = None,
                 device="cuda", params=None):
        template = KDEService(dataclasses.replace(
            cfg, snapshot_dir=None, batch_queries=False), device=device,
            params=params)
        try:
            self._rpc_setup(cfg, template, rpc, num_workers, params)
            super().__init__(cfg, num_workers, merge_every=merge_every,
                             failover=failover, global_clock=global_clock,
                             make_worker=self._remote_worker)
        except BaseException:
            self._abort_startup()
            raise


class RPCClusterRACEService(_RPCClusterMixin, ClusterRACEService):
    """N-process RACE cluster behind the RPC front door (bit-exact vs
    `ClusterRACEService` — and therefore vs a single engine over the
    whole stream)."""

    _service_kind = "race"

    def __init__(self, cfg: RACEServiceConfig, num_workers: int = 2,
                 merge_every: int = 8,
                 failover: Optional[FailoverConfig] = None,
                 rpc: Optional[RPCConfig] = None,
                 device="cuda", params=None):
        template = RACEService(dataclasses.replace(
            cfg, snapshot_dir=None, batch_queries=False), device=device,
            params=params)
        try:
            self._rpc_setup(cfg, template, rpc, num_workers, params)
            super().__init__(cfg, num_workers, merge_every=merge_every,
                             failover=failover,
                             make_worker=self._remote_worker)
        except BaseException:
            self._abort_startup()
            raise


_SERVICES: dict[str, Callable] = {
    "retrieval": RPCClusterRetrievalService,
    "kde": RPCClusterKDEService,
    "race": RPCClusterRACEService,
}


def rpc_cluster(service_kind: str, cfg, **kwargs):
    """Factory by sketch name: ``rpc_cluster("race", cfg, num_workers=4)``."""
    try:
        cls = _SERVICES[service_kind]
    except KeyError:
        raise ValueError(f"unknown service kind {service_kind!r}; expected "
                         f"one of {sorted(_SERVICES)}") from None
    return cls(cfg, **kwargs)
