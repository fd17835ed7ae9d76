"""Length-prefixed binary RPC wire protocol for the network cluster
(DESIGN.md §16).

The port's copy of the reference's ``net/protocol.py``, byte for byte on
the wire: the same header, magic, message kinds, version and frame cap, so
a port coordinator drives reference workers and the other way round.  The
frames are numpy and stdlib only (beside the port's fault sites); tensors
never cross the wire: callers convert them to numpy first.

One frame per message, reusing the WAL's framing idiom (`persist/wal.py`)
so the whole stack has exactly one on-the-wire record shape:

    frame  := header | body
    header := magic u32 | msg_id u64 | kind u8 | body_len u32 | crc32(body) u32
    body   := json_len u32 | json meta (utf-8) | .npz archive of arrays

The body carries a small JSON metadata dict (scalars: versions, query
kinds, error descriptions) plus an optional numpy ``.npz`` archive for
bulk payloads (ingest chunks, query batches, snapshot state leaves) —
npz preserves dtypes and byte layout exactly, which is what the cluster's
bit-exactness contract needs.  Everything is stdlib + numpy: no new
dependency.

Failure model — every malformed input fails LOUDLY with `ProtocolError`
instead of hanging or desyncing (tests/test_net.py):

  * truncated header/body (peer died mid-frame)  → "truncated frame"
  * wrong magic (not our protocol / desynced)    → "bad magic"
  * CRC mismatch (corrupt body)                  → "crc mismatch"
  * body_len > ``max_body``                      → rejected before any
    allocation or read of the oversized payload
  * HELLO version mismatch                       → rejected by both sides

`Channel` is the client side: one socket, one outstanding request
(request/reply in lockstep, serialized by a lock — the coordinator's
concurrency comes from having one channel per worker, not pipelining).
Sockets always carry a timeout; after any send/recv failure — including a
timeout — the channel marks itself *broken* and refuses further calls: a
late reply landing after a timed-out request would be attributed to the
next call and silently corrupt the framing, so a broken channel must be
torn down and rebuilt (the failover layer does exactly that).

Fault injection (`repro_torch.persist.faults`): the coordinator side fires
``net.connect`` / ``net.send`` / ``net.recv`` (scoped ``worker_<w>/``)
around each operation.  ``net.send`` fires *before* any bytes go out, so
a ``drop`` there leaves the channel intact and cleanly retryable; any
fault after bytes went out breaks the channel like a real peer failure.
"""
from __future__ import annotations

import io
import json
import socket
import struct
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

from ..persist import faults

PROTOCOL_VERSION = 1

_MAGIC = 0x53524331  # "SRC1" — sketch RPC v1 framing
_HEADER = struct.Struct("<IQBII")
_JLEN = struct.Struct("<I")

# Hard frame cap: a body_len above this is rejected *before* reading or
# allocating the payload (a corrupt/hostile length field must not OOM the
# peer).  Generous for real traffic: the largest frames are worker state
# snapshots, and the dev-shape sketches are well under this.
MAX_BODY = 256 << 20

# Message kinds (client request / server reply share the space).
K_HELLO = 1          # version handshake -> OK {version, session, engine}
K_OK = 2             # generic success reply
K_ERR = 3            # failure reply {error, type, transient, wal_accepted}
K_INGEST = 4         # arrays {xs} -> OK (WAL-logged + queued on the worker)
K_FLUSH = 5          # wait for every queued chunk to commit
K_QUERY = 6          # {kind} arrays {qs} -> OK {num_leaves} arrays {l0..}
K_DELETE = 7         # arrays {x} -> OK (turnstile delete)
K_HEALTH = 8         # -> OK health() + {version, steps, count}
K_STATS = 9          # -> OK stats()
K_SNAPSHOT = 10      # -> OK {version, num_leaves} arrays {l0..lN}
K_RECOVER = 11       # -> OK {replayed}
K_SHUTDOWN = 12      # graceful stop: close engine, reply OK, exit
K_ADVANCE_CLOCK = 13  # {target} -> OK (SW-AKDE global stream clock)

KIND_NAMES = {
    K_HELLO: "hello", K_OK: "ok", K_ERR: "err", K_INGEST: "ingest",
    K_FLUSH: "flush", K_QUERY: "query", K_DELETE: "delete",
    K_HEALTH: "health", K_STATS: "stats", K_SNAPSHOT: "snapshot",
    K_RECOVER: "recover", K_SHUTDOWN: "shutdown",
    K_ADVANCE_CLOCK: "advance_clock",
}


class ProtocolError(RuntimeError):
    """A framing/handshake violation (torn frame, bad magic, CRC mismatch,
    oversized payload, version mismatch, desynced reply).  Never
    transient: the channel that raised it is no longer trustworthy."""


class RemoteError(RuntimeError):
    """A worker-side exception re-raised on the coordinator.  Carries the
    failover-relevant markers across the wire: ``transient`` (retry in
    place is allowed — `faults.is_transient`) and ``wal_accepted`` (the
    failed op's record hit the worker's WAL, so it must NOT be
    resubmitted — `ClusterService._mutate_live`)."""

    def __init__(self, msg: str, kind: str = "", transient: bool = False,
                 wal_accepted: bool = False):
        super().__init__(msg)
        self.remote_type = kind
        self.transient = transient
        self.wal_accepted = wal_accepted


def encode_body(meta: Optional[dict] = None,
                arrays: Optional[dict] = None) -> bytes:
    """meta (JSON-safe dict) + named numpy arrays -> body bytes."""
    mb = json.dumps(meta or {}).encode("utf-8")
    out = _JLEN.pack(len(mb)) + mb
    if arrays:
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        out += buf.getvalue()
    return out


def decode_body(body: bytes) -> Tuple[dict, dict]:
    """Inverse of `encode_body` -> ``(meta, arrays)``."""
    if len(body) < _JLEN.size:
        raise ProtocolError(f"truncated frame body ({len(body)} bytes)")
    (jlen,) = _JLEN.unpack(body[:_JLEN.size])
    if _JLEN.size + jlen > len(body):
        raise ProtocolError(
            f"truncated frame body (meta wants {jlen} bytes, "
            f"{len(body) - _JLEN.size} present)")
    try:
        meta = json.loads(body[_JLEN.size:_JLEN.size + jlen] or b"{}")
    except ValueError as e:
        raise ProtocolError(f"frame meta is not JSON: {e}") from None
    rest = body[_JLEN.size + jlen:]
    arrays: dict = {}
    if rest:
        try:
            with np.load(io.BytesIO(rest)) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception as e:
            raise ProtocolError(f"frame arrays are not npz: {e}") from None
    return meta, arrays


def send_msg(sock: socket.socket, msg_id: int, kind: int,
             body: bytes) -> None:
    """Frame and send one message (blocking, honours the socket timeout)."""
    if len(body) > MAX_BODY:
        raise ProtocolError(
            f"frame body {len(body)} bytes exceeds MAX_BODY={MAX_BODY}")
    hdr = _HEADER.pack(_MAGIC, msg_id, kind, len(body), zlib.crc32(body))
    sock.sendall(hdr + body)


def _recv_exact(sock: socket.socket, n: int, what: str) -> bytes:
    chunks = []
    got = 0
    while got < n:
        part = sock.recv(min(n - got, 1 << 20))
        if not part:
            raise ProtocolError(
                f"truncated frame: peer closed mid-{what} "
                f"({got}/{n} bytes)")
        chunks.append(part)
        got += len(part)
    return b"".join(chunks)


def recv_msg(sock: socket.socket,
             max_body: int = MAX_BODY) -> Tuple[int, int, bytes]:
    """Receive one framed message -> ``(msg_id, kind, body)``.

    Every malformed input raises `ProtocolError` (see module docstring);
    an oversized ``body_len`` is rejected before the body is read."""
    head = _recv_exact(sock, _HEADER.size, "header")
    magic, msg_id, kind, blen, crc = _HEADER.unpack(head)
    if magic != _MAGIC:
        raise ProtocolError(f"bad magic 0x{magic:08x} (framing desync or "
                            "not a sketch-RPC peer)")
    if blen > max_body:
        raise ProtocolError(
            f"oversized frame: body_len={blen} exceeds max_body={max_body}")
    body = _recv_exact(sock, blen, "body")
    if zlib.crc32(body) != crc:
        raise ProtocolError(
            f"crc mismatch on {KIND_NAMES.get(kind, kind)} frame "
            f"(msg_id={msg_id})")
    return msg_id, kind, body


def check_hello(meta: dict) -> None:
    """Server-side HELLO validation: loud on a version mismatch."""
    got = meta.get("version")
    if got != PROTOCOL_VERSION:
        raise ProtocolError(
            f"protocol version mismatch: peer speaks {got!r}, "
            f"this worker speaks {PROTOCOL_VERSION}")


class Channel:
    """Client side of one coordinator→worker connection.

    ``call(kind, meta, arrays)`` sends one request and blocks for its
    reply (lockstep; serialized under an internal lock).  Worker-side
    failures come back as `RemoteError` with their failover markers;
    wire-level failures (timeout, reset, framing) mark the channel
    *broken* — every later call fails fast with `ProtocolError` until the
    failover layer rebuilds the worker.  A timeout in particular must
    break the channel: the reply may still arrive and would otherwise be
    paired with the next request."""

    def __init__(self, host: str, port: int, timeout_s: float = 120.0,
                 fault_scope: str = "", session: str = ""):
        self._lock = threading.Lock()
        self._timeout = float(timeout_s)
        self._scope = fault_scope
        self._msg_id = 0
        self._broken: Optional[str] = None
        self.remote = f"{host}:{port}"
        faults.fire(fault_scope + "net.connect")
        self._sock = socket.create_connection((host, port),
                                              timeout=self._timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            meta, _ = self.call(K_HELLO, {"version": PROTOCOL_VERSION,
                                          "session": session})
        except BaseException:
            self.close()
            raise
        if meta.get("version") != PROTOCOL_VERSION:
            self.close()
            raise ProtocolError(
                f"protocol version mismatch: worker speaks "
                f"{meta.get('version')!r}, coordinator speaks "
                f"{PROTOCOL_VERSION}")
        self.session = meta.get("session", "")
        self.engine_kind = meta.get("engine", "")

    @property
    def broken(self) -> Optional[str]:
        return self._broken

    def call(self, kind: int, meta: Optional[dict] = None,
             arrays: Optional[dict] = None,
             timeout_s: Optional[float] = None) -> Tuple[dict, dict]:
        """One request/reply round trip -> the reply's ``(meta, arrays)``."""
        with self._lock:
            if self._broken is not None:
                raise ProtocolError(
                    f"channel to {self.remote} is broken "
                    f"({self._broken}); rebuild the worker")
            self._msg_id += 1
            mid = self._msg_id
            # Fires before any bytes go out: a "drop" fault here models a
            # lost request — nothing was sent, the channel stays intact
            # and the caller may retry on it.
            faults.fire(self._scope + "net.send")
            try:
                if timeout_s is not None:
                    self._sock.settimeout(float(timeout_s))
                send_msg(self._sock, mid, kind, encode_body(meta, arrays))
                faults.fire(self._scope + "net.recv")
                rid, rkind, body = recv_msg(self._sock)
            except BaseException as e:
                if not faults.is_transient(e):
                    self._break(e)
                raise
            finally:
                if timeout_s is not None:
                    self._sock.settimeout(self._timeout)
            if rid != mid:
                e = ProtocolError(
                    f"desynced reply from {self.remote}: expected "
                    f"msg_id {mid}, got {rid}")
                self._break(e)
                raise e
            rmeta, rarrays = decode_body(body)
            if rkind == K_ERR:
                raise RemoteError(
                    f"worker {self.remote} failed on "
                    f"{KIND_NAMES.get(kind, kind)}: "
                    f"{rmeta.get('error', '?')}",
                    kind=rmeta.get("type", ""),
                    transient=bool(rmeta.get("transient", False)),
                    wal_accepted=bool(rmeta.get("wal_accepted", False)))
            return rmeta, rarrays

    def _break(self, exc: BaseException) -> None:
        self._broken = f"{type(exc).__name__}: {exc}"
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            if self._broken is None:
                self._broken = "closed"
            try:
                self._sock.close()
            except OSError:
                pass
