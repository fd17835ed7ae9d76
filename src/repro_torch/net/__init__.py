"""Network-native cluster (DESIGN.md §16): sketch workers as separate
processes behind a small length-prefixed binary RPC protocol over TCP —
stdlib sockets only, CRC-framed messages reusing the WAL framing idiom.
The port of the reference's ``net`` package, wire-compatible with it.

  * `protocol` — wire format, `Channel` (client side, versioned
    handshake, per-call timeouts, fail-loud framing);
  * `worker` — `WorkerServer` wrapping one of the port's services, plus
    the spawn/run/reap process entry points (each spawned worker its own
    CUDA process);
  * `cluster` — `RemoteEngine` proxy + the three RPC coordinators, which
    subclass the in-process cluster services and stay bit-exact against
    them (tests/test_torch_net.py).
"""
from __future__ import annotations

from . import cluster, protocol, worker  # noqa: F401
from .cluster import (RemoteEngine, RPCClusterKDEService,  # noqa: F401
                      RPCClusterRACEService, RPCClusterRetrievalService,
                      RPCConfig, rpc_cluster)
from .protocol import (PROTOCOL_VERSION, Channel, ProtocolError,  # noqa: F401
                       RemoteError)
from .worker import (WorkerServer, build_service, reap_process,  # noqa: F401
                     run_worker, spawn_worker)
