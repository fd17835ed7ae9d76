"""Worker side of the network cluster: a `WorkerServer` wraps ONE of the
port's sketch services (`RetrievalService` / `KDEService` / `RACEService`
— unchanged) and speaks the `protocol` frames over a TCP socket, plus the
process entry points the coordinator spawns workers through.

The port of the reference's ``net/worker.py``, with the same dispatch and
the same reply layouts, so a reference coordinator drives a port worker:
query results and snapshot states travel as numpy leaves in the
reference's flattening order (`checkpoint.tree_leaves`: NamedTuple fields
in order, dict keys sorted) with the reference's dtypes.  ``K_STATS``
replies also carry the process's kernel launch counts under ``launches``
(a reference coordinator ignores the key).

Each worker process owns its service outright: its commit worker and
prepare threads (which bind the worker's card by index), its WAL and
snapshots (under the cluster dir's ``worker_<w>`` subdirectory, where the
in-process cluster keeps them, so the coordinator's WAL-tail salvage of a
dead worker reads the same files) and its own CUDA context.  Ingest RPCs
stream straight into the service's ``ingest_async``, which WAL-logs at
enqueue time *before* the OK reply.

The server is single-client and lockstep: the coordinator holds one
channel per worker and pipelines nothing; a disconnected coordinator just
drops the connection and the server accepts the next one.

Spawn path (`start_worker` + `wait_worker`, or `spawn_worker` for both):
workers start through the multiprocessing ``spawn`` context — never
``fork``, which is unsafe once CUDA is up in the parent — as *daemon*
children, so a dying coordinator never leaves orphan workers behind.  The
parent loads the kernel library first (`kernels._build.lib()`), so the
children find it built.  The child gets the service config as a plain
dict, the device (``"cuda:0"``, or ``"cpu"``) and, when the caller passed
them, the LSH params as numpy; it binds an ephemeral port and hands it
back over a pipe, or sends its traceback when it cannot start.  No child
falls back to the CPU: a worker asked for a card on a machine without one
fails its spawn.
"""
from __future__ import annotations

import socket
import traceback
import uuid
from typing import Optional, Tuple

import numpy as np
import torch

from .. import convert
from ..checkpoint.checkpoint import tree_leaves
from ..core.util import resolve_device
from ..kernels import _build
from ..persist import faults
from ..serve.engine import to_host
from . import protocol as P


def build_service(service_kind: str, cfg_dict: dict, device="cuda",
                  params: Optional[dict] = None):
    """Rebuild one of the port's sketch services from its shipped config
    dict on ``device`` (the card by default; raises without one).
    ``params`` — LSH params as numpy (`convert.to_numpy`), or None to draw
    them from the config's seed."""
    if cfg_dict.get("mesh") is not None:
        raise ValueError("RPC workers are single-process engines; shard "
                         "inside the worker with num_shards, not mesh=")
    device = resolve_device(device)
    p = None if params is None else convert.params_from_numpy(params, device)
    if service_kind == "retrieval":
        from ..serve.retrieval import RetrievalConfig, RetrievalService
        return RetrievalService(RetrievalConfig(**cfg_dict), device=device,
                                params=p)
    if service_kind == "kde":
        from ..serve.kde_service import KDEService, KDEServiceConfig
        return KDEService(KDEServiceConfig(**cfg_dict), device=device,
                          params=p)
    if service_kind == "race":
        from ..serve.race_service import RACEService, RACEServiceConfig
        return RACEService(RACEServiceConfig(**cfg_dict), device=device,
                           params=p)
    raise ValueError(f"unknown service kind {service_kind!r}")


def _leaves(tree) -> dict:
    """A tree of tensors → ``{"l<i>": numpy leaf}`` in flattening order
    (one copy to the host for the whole tree)."""
    return {f"l{i}": a for i, a in enumerate(tree_leaves(to_host(tree)))}


class WorkerServer:
    """One engine behind one listening socket (see module docstring)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        self.session = uuid.uuid4().hex[:12]
        self._stop = False
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(4)
        self.host, self.port = self._lsock.getsockname()[:2]

    def serve_forever(self) -> None:
        """Accept coordinator connections until a SHUTDOWN request (one at
        a time — the protocol is lockstep and the coordinator is the only
        intended client)."""
        try:
            while not self._stop:
                try:
                    conn, _ = self._lsock.accept()
                except OSError:
                    break
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    self._serve_conn(conn)
                finally:
                    try:
                        conn.close()
                    except OSError:
                        pass
        finally:
            self._lsock.close()

    def _serve_conn(self, conn: socket.socket) -> None:
        while not self._stop:
            try:
                mid, kind, body = P.recv_msg(conn)
            except (P.ProtocolError, OSError):
                return          # peer gone / garbage: drop the connection
            try:
                meta, arrays = P.decode_body(body)
                rmeta, rarrays = self._handle(kind, meta, arrays)
                P.send_msg(conn, mid, P.K_OK,
                           P.encode_body(rmeta, rarrays))
            except Exception as e:
                # The boundary that must keep serving: the failure goes
                # back to the coordinator with its failover markers.
                err = {"error": f"{e!r}", "type": type(e).__name__,
                       "transient": faults.is_transient(e),
                       "wal_accepted": bool(getattr(e, "wal_accepted",
                                                    False))}
                try:
                    P.send_msg(conn, mid, P.K_ERR, P.encode_body(err))
                except OSError:
                    return
                if self._stop:          # shutdown failed but still stops
                    return

    # --- request dispatch ---------------------------------------------------

    def _handle(self, kind: int, meta: dict,
                arrays: dict) -> Tuple[dict, dict]:
        eng = self.engine
        if kind == P.K_HELLO:
            P.check_hello(meta)
            return {"version": P.PROTOCOL_VERSION, "session": self.session,
                    "engine": type(eng).__name__}, {}
        if kind == P.K_INGEST:
            eng.ingest_async(np.asarray(arrays["xs"], np.float32))
            return {}, {}
        if kind == P.K_FLUSH:
            eng.flush()
            return {}, {}
        if kind == P.K_QUERY:
            qkind = meta.get("kind") or eng._default_query_kind
            fn = eng._kind_fn(qkind)
            res = fn(eng._query_snapshot_ctx(), eng._to_device(
                np.asarray(arrays["qs"], np.float32)))
            leaves = _leaves(res)
            return {"num_leaves": len(leaves)}, leaves
        if kind == P.K_DELETE:
            eng.delete(np.asarray(arrays["x"], np.float32))
            return {}, {}
        if kind == P.K_HEALTH:
            return self._health_meta(), {}
        if kind == P.K_STATS:
            return {**eng.stats(), "launches": dict(_build.LAUNCHES)}, {}
        if kind == P.K_SNAPSHOT:
            state, version = eng.snapshot()
            leaves = _leaves(state)
            return ({"version": int(version), "num_leaves": len(leaves)},
                    leaves)
        if kind == P.K_RECOVER:
            return {"replayed": int(eng.recover())}, {}
        if kind == P.K_ADVANCE_CLOCK:
            eng.advance_clock(int(meta["target"]))
            return {}, {}
        if kind == P.K_SHUTDOWN:
            # Close the engine *before* the OK goes out: the coordinator's
            # shutdown call returns only once the WAL handle and threads
            # are down, so `close()` on the cluster is a real barrier.
            self._stop = True
            eng.close()
            return {}, {}
        raise P.ProtocolError(f"unknown request kind {kind}")

    def _health_meta(self) -> dict:
        eng = self.engine
        out = dict(eng.health())
        out["version"] = int(eng.version)
        for extra in ("steps", "count", "stored"):
            try:
                v = getattr(eng, extra)
            except Exception:       # not this sketch's, or unreadable now
                continue
            if isinstance(v, (int, np.integer)):
                out[extra] = int(v)
        return out


# --- process entry points ----------------------------------------------------

def _serve(svc, srv: WorkerServer) -> None:
    try:
        srv.serve_forever()
    finally:
        svc.close()


def _bind_card(device) -> None:
    """Make the worker's card the process's current device (the engine's
    threads bind it themselves)."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        _build.lib()


def run_worker(service_kind: str, cfg_dict: dict, host: str = "127.0.0.1",
               port: int = 0, announce=print, device="cuda",
               params: Optional[dict] = None) -> None:
    """Foreground worker (a second terminal or host, dialled through
    ``RPCConfig.peers``): build the engine, bind, announce the port, serve
    until SHUTDOWN."""
    _bind_card(device)
    svc = build_service(service_kind, cfg_dict, device, params)
    srv = WorkerServer(svc, host=host, port=port)
    if announce is not None:
        announce(f"worker [{service_kind}] session {srv.session} "
                 f"listening on {srv.host}:{srv.port}")
    _serve(svc, srv)


def _worker_main(conn, service_kind: str, cfg_dict: dict, host: str,
                 device: str, params: Optional[dict]) -> None:
    """Spawned-child main: bind the card and load the kernel library,
    build the engine, bind an ephemeral port, hand it back over the pipe,
    serve.  Any startup failure travels back as a traceback instead of a
    silent dead child."""
    try:
        _bind_card(device)
        svc = build_service(service_kind, cfg_dict, device, params)
        srv = WorkerServer(svc, host=host, port=0)
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        finally:
            conn.close()
        raise
    conn.send(("ok", srv.port))
    conn.close()
    _serve(svc, srv)


def start_worker(service_kind: str, cfg_dict: dict, device="cuda",
                 params: Optional[dict] = None, host: str = "127.0.0.1"):
    """Start a worker process (spawn context, daemon) without waiting for
    it: returns ``(process, pipe)`` for `wait_worker`, so a coordinator
    starts all its workers at once.  On the card the kernel library is
    loaded here first (built if need be), so the children load it instead
    of racing to build it."""
    import multiprocessing as mp

    device = str(device)
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        _build.lib()            # built here once; the children load it
    ctx = mp.get_context("spawn")
    rx, tx = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_worker_main,
                       args=(tx, service_kind, cfg_dict, host, device,
                             params),
                       daemon=True, name=f"sketch-worker-{service_kind}")
    try:
        proc.start()
    finally:
        tx.close()
    return proc, rx


def wait_worker(proc, rx, spawn_timeout_s: float = 300.0) -> int:
    """Wait for a started worker's port; on failure the child is reaped
    before the error propagates (no orphan PIDs)."""
    try:
        if not rx.poll(spawn_timeout_s):
            raise TimeoutError(
                f"worker {proc.name} did not report a port within "
                f"{spawn_timeout_s}s")
        status, payload = rx.recv()
    except EOFError:
        reap_process(proc)
        raise RuntimeError(f"worker {proc.name} exited with code "
                           f"{proc.exitcode} before reporting a port") from None
    except BaseException:
        reap_process(proc)
        raise
    finally:
        rx.close()
    if status != "ok":
        reap_process(proc)
        raise RuntimeError(f"worker {proc.name} failed to start:\n{payload}")
    return int(payload)


def spawn_worker(service_kind: str, cfg_dict: dict, device="cuda",
                 params: Optional[dict] = None, host: str = "127.0.0.1",
                 spawn_timeout_s: float = 300.0):
    """Start a worker process and wait for its port: ``(process, port)``."""
    proc, rx = start_worker(service_kind, cfg_dict, device, params, host)
    return proc, wait_worker(proc, rx, spawn_timeout_s)


def reap_process(proc, timeout_s: float = 5.0) -> None:
    """Make sure a worker process is gone: join, then terminate, then
    kill.  Safe on already-dead processes; never raises."""
    if proc is None:
        return
    try:
        proc.join(timeout_s)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout_s)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout_s)
    except Exception:
        pass
