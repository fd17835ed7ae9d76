"""The port's RPC cluster (repro_torch.net) against the reference's
(repro.net) and against the port's in-process cluster, on the CPU.

* Frames: the port's `protocol` writes the reference's bytes for the same
  meta and arrays, each package decodes the other's frames, and every
  malformed input of tests/test_net.py fails loudly in the port too.
* Across packages, workers in threads: the port's coordinator drives
  reference `WorkerServer`s (reference services holding the port's
  params, as `test_torch_cluster._ref` builds them), and the reference's
  coordinator drives port `WorkerServer`s; either way the merged state and
  the answers equal the port's in-process cluster's (integer state bit for
  bit, ids exact, distances within `batch_score_topk`'s tolerance).
* Port against port, workers in threads: the three RPC clusters equal the
  in-process ones through deletes and a global clock; a durable cluster
  recovers on fresh workers; a dropped ``net.send`` is retried in place.
* Spawned workers (two tests): a SIGKILLed worker is respawned and
  recovered bit-exactly; a worker asked for a card on a box without one
  fails its spawn with the child's traceback, and a connect fault on
  worker 1 at startup reaps worker 0.  No process outlives either test.
"""
import dataclasses
import multiprocessing
import socket
import struct
import threading
import time
import types
import zipfile
import zlib

import numpy as np
import pytest
import torch

from repro.net import RPCClusterKDEService as JRPCKDE
from repro.net import RPCClusterRACEService as JRPCRACE
from repro.net import RPCClusterRetrievalService as JRPCRetr
from repro.net import RPCConfig as JRPCConfig
from repro.net import protocol as JP
from repro.net import worker as jworker
from repro_torch import convert
from repro_torch.net import cluster as C
from repro_torch.net import protocol as P
from repro_torch.net import worker as W
from repro_torch.persist import faults
from repro_torch.serve import cluster

from test_torch_cluster import (CHUNK, D, KINDS, QB, _assert_answers,
                                _balanced, _port, _ref, _spec)
from torch_parity import (ATOL, RTOL, assert_state_equal, grid_data,
                          port_params)

# --- frames ------------------------------------------------------------------

_BODIES = {
    "meta_and_arrays": ({"kind": "topk", "n": 3},
                        {"xs": np.arange(12, dtype=np.float32).reshape(3, 4),
                         "ids": np.array([-1, 7], np.int64),
                         "valid": np.array([True, False]),
                         "mix": np.array([[3, 2**32 - 1]], np.uint32),
                         "n": np.int32(-5)}),
    "meta_only": ({"version": 1, "session": "abc", "engine": "RACEService"},
                  None),
    "empty": (None, None),
}


@pytest.fixture
def frozen_zip_clock(monkeypatch):
    """`np.savez` stamps each zip member with the wall clock; pin it, so
    two encodings of the same body are the same bytes."""
    clock = types.ModuleType("time")
    clock.__dict__.update(time.__dict__)
    clock.time = lambda: 1.7e9
    monkeypatch.setattr(zipfile, "time", clock)


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def _frame(pkg, mid, kind, body) -> bytes:
    a, b = _pair()
    pkg.send_msg(a, mid, kind, body)
    a.close()
    out = b""
    while True:
        part = b.recv(1 << 16)
        if not part:
            break
        out += part
    b.close()
    return out


def test_protocol_constants_equal_reference():
    for name in ("PROTOCOL_VERSION", "_MAGIC", "MAX_BODY", "KIND_NAMES"):
        assert getattr(P, name) == getattr(JP, name), name
    assert P._HEADER.format == JP._HEADER.format == "<IQBII"
    assert P.MAX_BODY == 256 << 20


@pytest.mark.parametrize("case", list(_BODIES))
def test_frames_equal_reference_bytes_and_decode_across(frozen_zip_clock,
                                                        case):
    meta, arrays = _BODIES[case]
    body = P.encode_body(meta, arrays)
    assert body == JP.encode_body(meta, arrays)
    frame = _frame(P, 7, P.K_SNAPSHOT, body)
    assert frame == _frame(JP, 7, JP.K_SNAPSHOT, body)
    for send, recv in ((P, JP), (JP, P)):
        a, b = _pair()
        send.send_msg(a, 9, send.K_QUERY, send.encode_body(meta, arrays))
        mid, kind, got = recv.recv_msg(b)
        a.close(), b.close()
        assert (mid, kind) == (9, P.K_QUERY)
        gmeta, garrays = recv.decode_body(got)
        assert gmeta == (meta or {})
        assert sorted(garrays) == sorted(arrays or {})
        for k, v in (arrays or {}).items():
            assert garrays[k].dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(garrays[k], v)


def _truncated_header(a, b):
    a.sendall(b"\x31\x43")
    a.close()
    P.recv_msg(b)


def _truncated_body(a, b):
    body = P.encode_body({"x": 1})
    a.sendall(P._HEADER.pack(P._MAGIC, 1, P.K_OK, len(body) + 50,
                             zlib.crc32(body)) + body)
    a.close()
    P.recv_msg(b)


def _bad_magic(a, b):
    body = P.encode_body({})
    a.sendall(P._HEADER.pack(0xDEADBEEF, 1, P.K_OK, len(body),
                             zlib.crc32(body)) + body)
    P.recv_msg(b)


def _crc(a, b):
    body = bytearray(P.encode_body({"v": 123}))
    hdr = P._HEADER.pack(P._MAGIC, 9, P.K_OK, len(body), zlib.crc32(body))
    body[-2] ^= 0x40
    a.sendall(hdr + bytes(body))
    P.recv_msg(b)


def _oversized_len(a, b):
    # refused from the header alone: no payload follows, and a decoder
    # that tried to read it would hit the socket timeout instead
    a.sendall(P._HEADER.pack(P._MAGIC, 1, P.K_OK, 1 << 30, 0))
    P.recv_msg(b, max_body=1 << 20)


def _oversized_send(a, b):
    P.send_msg(a, 1, P.K_OK, b"x" * (P.MAX_BODY + 1))


_MALFORMED = {
    "truncated_header": (_truncated_header, "mid-header"),
    "truncated_body": (_truncated_body, "mid-body"),
    "bad_magic": (_bad_magic, "bad magic"),
    "crc": (_crc, "crc mismatch"),
    "oversized_len": (_oversized_len, "oversized frame"),
    "oversized_send": (_oversized_send, "exceeds MAX_BODY"),
    "short_body": (lambda a, b: P.decode_body(b"\x01"), "truncated"),
    "long_meta": (lambda a, b: P.decode_body(struct.pack("<I", 99) + b"{}"),
                  "truncated"),
    "meta_not_json": (lambda a, b: P.decode_body(struct.pack("<I", 3)
                                                 + b"{{{"), "not JSON"),
    "arrays_not_npz": (lambda a, b: P.decode_body(
        struct.pack("<I", 2) + b"{}this is not a zip archive"), "not npz"),
    "hello_version": (lambda a, b: P.check_hello({"version": 0}),
                      "version mismatch"),
}


@pytest.mark.parametrize("case", list(_MALFORMED))
def test_malformed_frames_fail_loudly(case):
    fn, match = _MALFORMED[case]
    a, b = _pair()
    try:
        with pytest.raises(P.ProtocolError, match=match):
            fn(a, b)
    finally:
        a.close(), b.close()


def _scripted_server(script):
    """Listener running ``script(conn)`` on its first connection in a
    daemon thread; returns the port."""
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)

    def run():
        conn, _ = lsock.accept()
        conn.settimeout(10.0)
        try:
            script(conn)
        except (P.ProtocolError, OSError):
            pass
        finally:
            conn.close()
            lsock.close()

    threading.Thread(target=run, daemon=True).start()
    return lsock.getsockname()[1]


def _reply_hello(conn, version=P.PROTOCOL_VERSION):
    mid, kind, _ = P.recv_msg(conn)
    assert kind == P.K_HELLO
    P.send_msg(conn, mid, P.K_OK,
               P.encode_body({"version": version, "session": "test"}))


def _channel_version(stall):
    port = _scripted_server(lambda c: _reply_hello(c, version=999))
    with pytest.raises(P.ProtocolError, match="version mismatch"):
        P.Channel("127.0.0.1", port, timeout_s=5.0)


def _channel_timeout(stall):
    def script(conn):
        _reply_hello(conn)
        P.recv_msg(conn)             # swallow the next request ...
        stall.wait(10.0)             # ... and never reply

    ch = P.Channel("127.0.0.1", _scripted_server(script), timeout_s=5.0)
    t0 = time.monotonic()
    with pytest.raises(OSError):     # socket.timeout
        ch.call(P.K_FLUSH, timeout_s=0.3)
    assert time.monotonic() - t0 < 4.0
    assert ch.broken is not None
    with pytest.raises(P.ProtocolError, match="broken"):
        ch.call(P.K_FLUSH)           # a late reply must never pair up
    ch.close()


def _channel_desync(stall):
    def script(conn):
        _reply_hello(conn)
        mid, _, _ = P.recv_msg(conn)
        P.send_msg(conn, mid + 7, P.K_OK, P.encode_body({}))

    ch = P.Channel("127.0.0.1", _scripted_server(script), timeout_s=5.0)
    with pytest.raises(P.ProtocolError, match="desynced reply"):
        ch.call(P.K_FLUSH)
    assert ch.broken is not None
    ch.close()


def _channel_remote_error(stall):
    def script(conn):
        _reply_hello(conn)
        mid, _, _ = P.recv_msg(conn)
        P.send_msg(conn, mid, P.K_ERR, P.encode_body(
            {"error": "boom", "type": "ValueError", "transient": True,
             "wal_accepted": True}))
        P.recv_msg(conn)             # the channel must still be usable

    ch = P.Channel("127.0.0.1", _scripted_server(script), timeout_s=5.0)
    with pytest.raises(P.RemoteError, match="boom") as ei:
        ch.call(P.K_FLUSH)
    assert ei.value.remote_type == "ValueError"
    assert ei.value.transient and ei.value.wal_accepted
    assert faults.is_transient(ei.value)
    assert ch.broken is None         # an application failure, not a wire one
    ch.close()


@pytest.mark.parametrize("script", [_channel_version, _channel_timeout,
                                    _channel_desync, _channel_remote_error],
                         ids=["version", "timeout", "desync", "remote_error"])
def test_channel_failures_are_loud(script):
    stall = threading.Event()
    try:
        script(stall)
    finally:
        stall.set()


# --- workers in threads --------------------------------------------------------

def _serve_in_threads(services):
    """A `WorkerServer` of either package around each service, each in a
    daemon thread; returns the peers list."""
    peers = []
    for svc in services:
        mod = W if type(svc).__module__.startswith("repro_torch") else jworker
        srv = mod.WorkerServer(svc)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        peers.append((srv.host, srv.port))
    return peers


def _port_workers(kind, K, **extra):
    """Port services built through `worker.build_service` exactly as a
    spawned worker w builds them (the shipped config dict and numpy
    params), each behind a `WorkerServer` in a thread."""
    cfg_cls, _, _, _, _, _, kw, p = _spec(kind)
    cfg = cfg_cls(**{**kw, **extra})
    salt = (lambda w: {"ingest_salt": w}) if kind == "retrieval" else (
        lambda w: {})
    params = convert.to_numpy(port_params(p))
    return _serve_in_threads([W.build_service(kind, dataclasses.asdict(
        cluster._worker_cfg(cfg, w, batch_queries=False, **salt(w))), "cpu",
        params) for w in range(K)])


_RPC = {"race": C.RPCClusterRACEService, "kde": C.RPCClusterKDEService,
        "retrieval": C.RPCClusterRetrievalService}


def _port_rpc(kind, K, peers, failover=None, **extra):
    cfg_cls, _, _, _, _, _, kw, p = _spec(kind)
    more = {"global_clock": extra.pop("global_clock")} if (
        "global_clock" in extra) else {}
    return _RPC[kind](cfg_cls(**{**kw, **extra}), num_workers=K,
                      merge_every=4, failover=failover,
                      rpc=C.RPCConfig(peers=peers, rpc_timeout_s=30.0),
                      device="cpu", params=port_params(p), **more)


def _drive(kind, cl, data, qs, split=True):
    """A stream with a turnstile delete (RACE: rows 0-3; S-ANN: row 5)
    after its first half, or after all of it when not ``split``; returns
    the answers."""
    cut = len(data) // 2 if split else len(data)
    cl.ingest(data[:cut])
    if kind == "race":
        cl.delete(data[:4])
    elif kind == "retrieval":
        cl.delete(data[5])
    if split:
        cl.ingest(data[cut:])
    out = [cl.query(qs)]
    if kind == "retrieval":
        out.append(cl.query_topk(qs))
    else:
        out.append(cl.kde(qs) if kind == "race" else cl.density(qs))
    return out


def _assert_same(kind, got, want):
    _assert_answers(kind, got[0], want[0])
    if kind == "retrieval":
        np.testing.assert_array_equal(got[1][0], np.asarray(want[1][0]))
        np.testing.assert_allclose(got[1][1], np.asarray(want[1][1]),
                                   rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("kind", KINDS)
def test_port_coordinator_drives_reference_workers(kind):
    """Reference workers (reference services with the port's params, in
    threads) behind the port's RPC cluster: merged state and answers equal
    the port's in-process cluster's."""
    K = 2
    data = _balanced(K, 4 * CHUNK, seed=11)
    qs = grid_data(2 * QB - 3, D, seed=12) + np.float32(1 / 32)
    ref = _ref(kind, K)                     # its workers: params + jits set
    rpc = _port_rpc(kind, K, _serve_in_threads(ref.workers))
    oracle = _port(kind, K)
    assert rpc.workers[0]._ch.engine_kind == type(ref.workers[0]).__name__
    got = _drive(kind, rpc, data, qs, split=False)
    want = _drive(kind, oracle, data, qs, split=False)
    assert_state_equal(rpc.merged_state(), oracle.merged_state())
    _assert_same(kind, got, want)
    rpc.close()
    oracle.close()
    ref.close()


_JRPC = {"race": JRPCRACE, "kde": JRPCKDE, "retrieval": JRPCRetr}


@pytest.mark.parametrize("kind", KINDS)
def test_reference_coordinator_drives_port_workers(kind):
    """Port workers in threads behind the reference's RPC cluster, its
    template holding the same params: merged state and answers equal the
    port's in-process cluster's."""
    K = 2
    data = _balanced(K, 4 * CHUNK, seed=13)
    qs = grid_data(2 * QB - 3, D, seed=14) + np.float32(1 / 32)
    _, _, _, jcfg_cls, _, _, kw, p = _spec(kind)
    jrpc = _JRPC[kind](jcfg_cls(**kw), num_workers=K, merge_every=4,
                       rpc=JRPCConfig(peers=_port_workers(kind, K)))
    jrpc._template.params = p                # before any call traces a jit
    oracle = _port(kind, K)
    got = _drive(kind, jrpc, data, qs, split=False)
    want = _drive(kind, oracle, data, qs, split=False)
    assert_state_equal(oracle.merged_state(), jrpc.merged_state())
    _assert_same(kind, want, got)
    stats = jrpc.workers[0].stats()
    assert set(stats["launches"]) >= {"race_hist", "srp_hash"}
    jrpc.close()
    oracle.close()


@pytest.mark.parametrize("kind", KINDS)
def test_port_rpc_in_threads_matches_inprocess(kind):
    """The port's RPC cluster over port workers in threads equals the
    in-process cluster through a mid-stream delete (RACE, S-ANN) or with
    the coordinator's global clock (SW-AKDE)."""
    K = 2
    extra = {"global_clock": True} if kind == "kde" else {}
    data = grid_data(6 * CHUNK + 17, D, seed=15)
    qs = grid_data(QB + 5, D, seed=16)
    rpc = _port_rpc(kind, K, _port_workers(kind, K), **extra)
    cfg_cls, _, cl_cls, _, _, _, kw, p = _spec(kind)
    oracle = cl_cls(cfg_cls(**kw), num_workers=K, merge_every=4,
                    device="cpu", params=port_params(p), **extra)
    got, want = _drive(kind, rpc, data, qs), _drive(kind, oracle, data, qs)
    assert_state_equal(rpc.merged_state(), oracle.merged_state())
    _assert_same(kind, got, want)
    if kind == "kde":
        assert rpc.steps == oracle.steps == len(data)
    direct = rpc.workers[1].query(qs)        # one worker's own substream
    mine = oracle.workers[1]._serve_query(oracle.workers[1]
                                          ._default_query_kind, qs)
    for a, b in zip(direct, mine if isinstance(mine, tuple) else [mine]):
        np.testing.assert_array_equal(a, b)
    rpc.close()
    oracle.close()


def test_port_rpc_durable_recover_and_send_drop(tmp_path):
    """A durable RACE RPC cluster loses one request to a ``net.send`` drop
    (retried in place: no recovery), stops, and a fresh cluster over fresh
    workers on the same directory recovers the in-process state."""
    K = 2
    data = grid_data(5 * CHUNK, D, seed=17)
    dur = dict(snapshot_dir=str(tmp_path), snapshot_every=2)
    fo = cluster.FailoverConfig(max_retries=2, backoff_s=0.001)
    rpc = _port_rpc("race", K, _port_workers("race", K, **dur), failover=fo,
                    **dur)
    plan = faults.FaultPlan([faults.FaultSpec(site="worker_1/net.send",
                                              mode="drop", hit=2)])
    with faults.installed(plan):
        rpc.ingest(data)
    assert plan.fired
    h = rpc.health()
    assert h["counters"]["retries"] >= 1
    assert h["counters"]["recoveries"] == 0
    want = rpc.merged_state()
    rpc.close()
    rec = _port_rpc("race", K, _port_workers("race", K, **dur), **dur)
    assert rec.recover() > 0
    assert_state_equal(rec.merged_state(), want)
    oracle = _port("race", K)
    oracle.ingest(data)
    assert_state_equal(rec.merged_state(), oracle.merged_state())
    rec.close()
    oracle.close()


def test_remote_snapshot_refuses_a_leaf_of_another_dtype():
    """A peer whose snapshot leaf is int64 where the template holds int32
    is refused with `ProtocolError` instead of merged."""
    rpc = _port_rpc("race", 1, _port_workers("race", 1))
    eng = rpc.workers[0]
    real = eng._ch.call

    def widened(kind, *a, **k):
        meta, arrays = real(kind, *a, **k)
        if kind == P.K_SNAPSHOT:
            arrays = {**arrays, "l0": arrays["l0"].astype(np.int64)}
        return meta, arrays

    eng._ch.call = widened
    with pytest.raises(P.ProtocolError, match="leaf 0"):
        eng.snapshot()
    eng._ch.call = real
    rpc.close()


def test_snapshot_past_the_frame_cap_is_refused_by_name(monkeypatch):
    """A worker whose snapshot frame would pass ``MAX_BODY`` sends nothing
    of it and answers with an error naming the cap; the channel stays
    usable (the frame cap of a SIFT-shape S-ANN worker past n_max ~500 000,
    here at a cap the dev shape passes)."""
    rpc = _port_rpc("race", 1, _port_workers("race", 1))
    rpc.ingest(grid_data(CHUNK, D, seed=19))
    monkeypatch.setattr(P, "MAX_BODY", 1024)  # read by the worker's send
    with pytest.raises(P.RemoteError, match="exceeds MAX_BODY=1024"):
        rpc.merged_state()
    assert rpc.workers[0]._ch.broken is None
    monkeypatch.undo()
    assert int(rpc.merged_state().n) == CHUNK
    rpc.close()


# --- spawned workers -------------------------------------------------------------

def _no_live_workers(procs=()):
    alive = [p.pid for p in procs if p is not None and p.is_alive()]
    names = [p.name for p in multiprocessing.active_children()
             if p.name.startswith("sketch-worker")]
    return not alive and not names


def test_spawned_worker_killed_respawns_bit_exact(tmp_path):
    """Two spawned RACE workers (durable, failover on); worker 1's process
    is SIGKILLed between ingest calls.  The broken channel is a hard
    failure: failover respawns the process on the same directory and
    `recover()`s it from its WAL, so the merge equals the in-process
    cluster's; `close()` leaves no process."""
    K = 2
    cfg_cls, _, _, _, _, _, kw, p = _spec("race")
    data = grid_data(8 * CHUNK, D, seed=18)
    cl = C.RPCClusterRACEService(
        cfg_cls(**kw, snapshot_dir=str(tmp_path), snapshot_every=4),
        num_workers=K, merge_every=4, device="cpu", params=port_params(p),
        failover=cluster.FailoverConfig(max_retries=2, backoff_s=0.01),
        rpc=C.RPCConfig(rpc_timeout_s=60.0))
    procs = [cl._procs[w] for w in range(K)]
    try:
        assert cl.workers[0]._ch.engine_kind == "RACEService"
        for i in range(0, len(data), 2 * CHUNK):
            if i == 4 * CHUNK:
                cl._procs[1].kill()
                cl._procs[1].join(10.0)
            cl.ingest(data[i:i + 2 * CHUNK])
        procs.append(cl._procs[1])
        assert procs[-1].pid != procs[1].pid
        h = cl.health()
        assert h["counters"]["recoveries"] >= 1
        assert h["dead_workers"] == [] and h["coverage"] == 1.0
        oracle = _port("race", K)
        oracle.ingest(data)
        assert_state_equal(cl.merged_state(), oracle.merged_state())
        oracle.close()
    finally:
        cl.close()
    assert _no_live_workers(procs)


def test_spawn_failures_leave_no_live_process(monkeypatch):
    """A worker asked for the card on a box without one fails its spawn
    with the child's traceback (no quiet CPU service); a connect fault on
    worker 1 while the cluster starts reaps both started workers."""
    cfg_cls, _, _, _, _, _, kw, p = _spec("race")
    wcfg = dataclasses.asdict(cluster._worker_cfg(cfg_cls(**kw), 0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="(?s)failed to start.*CUDA"):
            W.spawn_worker("race", wcfg)     # device defaults to "cuda"
    plan = faults.FaultPlan([faults.FaultSpec(site="worker_1/net.connect",
                                              mode="crash", hit=1)])
    started = []
    real = W.start_worker

    def start(*a, **k):
        started.append(real(*a, **k))
        return started[-1]

    monkeypatch.setattr(W, "start_worker", start)
    with faults.installed(plan):
        with pytest.raises(faults.FaultError):
            C.RPCClusterRACEService(cfg_cls(**kw), num_workers=2,
                                    device="cpu", params=port_params(p))
    assert plan.fired and len(started) == 2
    assert _no_live_workers([proc for proc, _ in started])
