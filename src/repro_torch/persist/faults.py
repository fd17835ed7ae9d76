"""Deterministic, seeded fault injection for the durability + cluster
runtime (DESIGN.md §14); the port's own copy of the reference's
``persist/faults.py``, with the same site names, modes and hit counting, so
one `FaultPlan` targets either package.

The streaming stack names its failure points ("fault sites") and calls
`fire(site)` at each one; with no plan installed that is a no-op, so the
production path pays one global read per site.  Tests and the chaos soak
install a `FaultPlan` — a list of `FaultSpec`s saying *which* site fails,
*how* (crash / torn WAL tail / transient-or-permanent IO error / delay)
and on *which hit* — and the same plan object then drives unit tests, the
seeded chaos soak and the CI `chaos` job.

Determinism: hits are counted **per concrete site string** (e.g.
``worker_1/wal.append``), so each engine's counter advances only with its
own deterministic operation order — cross-worker thread interleaving
cannot change which operation a fault lands on.  A spec whose ``site`` is
a glob (``*/engine.commit``) fires independently at every matching site's
own Nth hit.

Named sites (scope prefix ``worker_<w>/`` inside a cluster, empty for a
single service / the coordinator):

  ``wal.append``      WAL record append (fires before bytes are written —
                      a crash here models process death just before the
                      record is durable; ``torn_tail`` additionally leaves
                      a half-written record, modelling death mid-write)
  ``wal.rotate``      segment seal at snapshot time
  ``wal.compact``     sealed-segment deletion after a durable snapshot
  ``snapshot.save``   background state-snapshot write
  ``engine.commit``   the sequential commit half of two-phase ingest
  ``engine.recover``  snapshot + WAL-tail recovery (fires at entry — a
                      repeated fault here models an unrecoverable worker)
  ``engine.query``    a service query tick / direct query snapshot
  ``cluster.merge``   the coordinator's worker-state merge
  ``cluster.query``   a coordinator query tick / direct query snapshot
  ``cluster.salvage`` a dead worker's WAL-tail re-partition, fired after
                      each durable hand-off checkpoint (a crash here
                      models coordinator death mid-salvage; recover()
                      resumes from the checkpointed prefix)

Network sites (the reference's ``net`` package; fired on the *coordinator* side of each RPC —
worker processes have no plan installed, so injection stays deterministic
in one process — scoped ``worker_<w>/`` per remote worker):

  ``net.connect``     TCP connect + protocol handshake to a worker
  ``net.send``        one framed request, fired before any bytes go out
                      (``drop`` here models a lost request: nothing was
                      sent, the call is cleanly retryable)
  ``net.recv``        one framed reply, fired after the request went out
                      (a fault here breaks the channel — the reply may
                      still arrive later and would desync the framing)

The two network modes: ``drop`` raises a *transient* `InjectedIOError`
(the retry-with-backoff model of a lost datagram); ``disconnect`` raises
`InjectedDisconnect` (a `ConnectionError`: the channel is torn down and
the failover layer rebuilds the worker).  ``delay`` at a net site models
latency; combined with the client's RPC timeout it models a hung peer.

Install with the context manager so plans never leak between tests::

    plan = FaultPlan([FaultSpec("worker_0/engine.commit", "crash", hit=3)])
    with installed(plan):
        ...  # run the workload; plan.fired / plan.report() afterwards
"""
from __future__ import annotations

import dataclasses
import fnmatch
import threading
import time
from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence

import numpy as np


class FaultError(RuntimeError):
    """An injected crash (process-death stand-in).  Never transient."""


class InjectedIOError(OSError):
    """An injected IO failure.  ``transient=True`` marks faults the
    failover layer may retry (the disk hiccup / dropped-RPC model);
    ``transient=False`` models a hard error (ENOSPC, dead disk)."""

    def __init__(self, msg: str, transient: bool = False):
        super().__init__(msg)
        self.transient = transient


class InjectedDisconnect(ConnectionError):
    """An injected network disconnect (`mode="disconnect"` at a ``net.*``
    site).  A `ConnectionError`, so the RPC channel layer treats it like a
    real peer reset: the channel breaks and the failover layer rebuilds
    the worker.  Never transient."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: at ``site`` (fnmatch glob over concrete site
    strings), fire ``mode`` on that site's ``hit``-th call (1-based),
    for ``count`` consecutive hits (so ``count=1`` is a one-shot fault
    that "heals", and a large ``count`` models a persistent failure).

    Modes: ``crash`` raises `FaultError`; ``torn_tail`` asks the site to
    leave partial bytes behind (WAL append only; elsewhere = crash) then
    raises; ``io_error`` raises `InjectedIOError` (``transient`` says
    whether retry is allowed to succeed later); ``delay`` sleeps
    ``delay_s`` and lets the operation proceed; ``drop`` raises a
    transient `InjectedIOError` (lost-message model, safe to retry);
    ``disconnect`` raises `InjectedDisconnect` (peer-reset model, the
    channel is torn down)."""
    site: str
    mode: str          # crash | torn_tail | io_error | delay | drop | disconnect
    hit: int = 1
    count: int = 1
    transient: bool = False
    delay_s: float = 0.0

    def __post_init__(self):
        if self.mode not in ("crash", "torn_tail", "io_error", "delay",
                             "drop", "disconnect"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        if self.hit < 1 or self.count < 1:
            raise ValueError(f"hit={self.hit}, count={self.count} (< 1)")


class FaultPlan:
    """A deterministic set of `FaultSpec`s plus per-site hit counters.

    Thread-safe: counters mutate under one lock, so concurrent engines
    can fire sites freely; determinism comes from counting per concrete
    site string (each site's hits are ordered by that site's own caller).

    ``hits`` (dict site -> calls seen) is the fault-*site coverage*
    record; ``fired`` is the log of faults actually injected."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: List[FaultSpec] = list(specs)
        self._lock = threading.Lock()
        self.hits: dict = {}
        self.fired: List[dict] = []

    def fire(self, site: str, tear: Optional[Callable[[], None]] = None):
        """Called by an instrumented site.  Counts the hit, then injects
        the first matching spec's fault (if this is its turn)."""
        with self._lock:
            n = self.hits.get(site, 0) + 1
            self.hits[site] = n
            spec = next(
                (s for s in self.specs
                 if fnmatch.fnmatchcase(site, s.site)
                 and s.hit <= n < s.hit + s.count), None)
            if spec is not None:
                self.fired.append({"site": site, "hit": n,
                                   "mode": spec.mode})
        if spec is None:
            return
        if spec.mode == "delay":
            time.sleep(spec.delay_s)
            return
        if spec.mode == "drop":
            raise InjectedIOError(
                f"injected drop at {site} (hit {n})", transient=True)
        if spec.mode == "disconnect":
            raise InjectedDisconnect(
                f"injected disconnect at {site} (hit {n})")
        if spec.mode == "io_error":
            raise InjectedIOError(
                f"injected io_error at {site} (hit {n})",
                transient=spec.transient)
        if spec.mode == "torn_tail" and tear is not None:
            tear()
        raise FaultError(f"injected {spec.mode} at {site} (hit {n})")

    def report(self) -> dict:
        """Coverage + injection record for the CI chaos artifact."""
        with self._lock:
            return {"sites_hit": dict(sorted(self.hits.items())),
                    "fired": list(self.fired),
                    "specs": [dataclasses.asdict(s) for s in self.specs]}


def seeded_plan(seed: int, scopes: Sequence[str],
                sites: Sequence[str] = ("engine.commit", "wal.append",
                                        "snapshot.save"),
                modes: Sequence[str] = ("crash", "torn_tail", "delay"),
                max_hit: int = 4) -> FaultPlan:
    """The chaos-soak plan generator: for every scope (worker), draw one
    fault — a random site, mode and hit number — from a seeded rng, so
    each worker fails at least once and the whole schedule is a pure
    function of ``seed``.  ``torn_tail`` is only meaningful at
    ``wal.append`` and is remapped to ``crash`` elsewhere."""
    rng = np.random.default_rng(seed)
    specs = []
    for scope in scopes:
        site = sites[int(rng.integers(len(sites)))]
        mode = modes[int(rng.integers(len(modes)))]
        if mode == "torn_tail" and not site.endswith("wal.append"):
            mode = "crash"
        specs.append(FaultSpec(site=f"{scope}{site}", mode=mode,
                               hit=int(rng.integers(1, max_hit + 1)),
                               delay_s=0.002))
    return FaultPlan(specs)


# --- the active plan ---------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
    """Make ``plan`` the process-wide active plan (None = uninstall).
    Prefer the `installed` context manager in tests."""
    global _ACTIVE
    _ACTIVE = plan


@contextmanager
def installed(plan: FaultPlan):
    """Install ``plan`` for the duration of the block (exception-safe)."""
    prev = _ACTIVE
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


def fire(site: str, tear: Optional[Callable[[], None]] = None) -> None:
    """Site entry point: no-op unless a plan is installed."""
    plan = _ACTIVE
    if plan is not None:
        plan.fire(site, tear=tear)


def is_transient(exc: BaseException) -> bool:
    """Whether the failover layer may retry this failure in place
    (exponential backoff) instead of declaring the worker failed."""
    return bool(getattr(exc, "transient", False))
