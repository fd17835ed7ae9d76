"""The port's streaming services (repro_torch.serve.{engine,retrieval,
kde_service,race_service}) against the reference's, on the CPU.

Parameters cross from the reference (`convert.params_from_numpy`) and both
services take the same operation stream (chunks, a delete or a clock
advance, more chunks).  The data and parameters are multiples of 1/16 and
1/8 and the p-stable widths powers of two, so every hash product is exact
in fp32 and both packages compute the same codes whatever their summation
order (where products round, `tests/test_torch_lsh.py` states which codes
may differ).  Then:

* integer state is bit-exact (S-ANN tables and keep decisions from the
  reference's key schedule, RACE counters, EH rings and clock), RACE and
  SW-AKDE estimates are equal, S-ANN ids are equal and distances within
  `batch_score_topk`'s tolerance;
* durability both ways: the port writes snapshots + WAL and the reference
  ``recover()``s to the same state, and the other way round; the port
  recovers from its own snapshot + WAL tail after a crash, bit-identical to
  the uninterrupted run;
* coalesced `QueryBatcher` answers are bit-identical to direct ones and to
  the core batch functions; `batch_plan` agrees with the reference's;
* concurrent queries see only committed prefixes, built from the port's
  own core functions;
* the services raise without a card unless given ``device="cpu"``, and on
  more than one shard.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.serve import engine as jengine
from repro.serve.kde_service import KDEService as JKDE
from repro.serve.kde_service import KDEServiceConfig as JKDECfg
from repro.serve.race_service import RACEService as JRACE
from repro.serve.race_service import RACEServiceConfig as JRACECfg
from repro.serve.retrieval import RetrievalConfig as JRetrCfg
from repro.serve.retrieval import RetrievalService as JRetr
from repro_torch import convert
from repro_torch.core import prng, race, sann, swakde
from repro_torch.persist import faults
from repro_torch.serve import engine as tengine
from repro_torch.serve.kde_service import KDEService, KDEServiceConfig
from repro_torch.serve.race_service import RACEService, RACEServiceConfig
from repro_torch.serve.retrieval import RetrievalConfig, RetrievalService

from torch_parity import ATOL, RTOL, _mix, assert_state_equal, fields

# Ring-wrap regime (~264 kept > 168 slots), as the reference's persistence
# tests; the window expires inside the stream; query blocks of 16 rows.
RETR = dict(dim=8, n_max=64, eta=0.1, r=0.4, c=2.0, w=1.0, L=6, k=3,
            bucket_cap=4, ingest_chunk=64, query_block=16, topk=8)
KDE = dict(dim=8, L=6, W=32, window=150, eh_eps=0.2, ingest_chunk=50,
           query_block=16, k=2, w=2.0)
RACE = dict(dim=8, L=6, W=32, ingest_chunk=64, query_block=16,
            hash_family="pstable", k=2, w=2.0)
KINDS = ("retrieval", "kde_srp", "kde_pstable", "race")
N = 400


def _data(n=N, seed=0):
    """Rows on a 1/16 grid: every product with the 1/8-grid parameters is
    exact in fp32."""
    rng = np.random.default_rng(seed)
    return (np.round(rng.normal(size=(n, 8)) * 16) / 16).astype(np.float32)


def _exact_params(family, seed, dim, L, k, n_buckets, w=None):
    rng = np.random.default_rng(seed)
    proj = (np.round(rng.normal(size=(dim, L * k)) * 8) / 8).astype(np.float32)
    mix = jax.numpy.asarray(_mix(rng, L, k))
    if family == "srp":
        return jlsh.SRPParams(proj=jax.numpy.asarray(proj), mix=mix, L=L, k=k,
                              n_buckets=n_buckets)
    bias = (np.floor(rng.uniform(0, w, L * k) * 8) / 8).astype(np.float32)
    return jlsh.PStableParams(proj=jax.numpy.asarray(proj),
                              bias=jax.numpy.asarray(bias), mix=mix, w=w, L=L,
                              k=k, n_buckets=n_buckets)


def _spec(kind):
    """(port cfg class, port service, ref cfg class, ref service, cfg kw,
    reference params)."""
    if kind == "retrieval":
        cfg = sann.SANNConfig(**{k: RETR[k] for k in
                                 ("dim", "n_max", "eta", "r", "c", "w", "L",
                                  "k", "bucket_cap")}).resolved()
        p = _exact_params("pstable", 1, 8, cfg.L, cfg.k, cfg.n_buckets, cfg.w)
        return RetrievalConfig, RetrievalService, JRetrCfg, JRetr, RETR, p
    if kind == "race":
        p = _exact_params("pstable", 2, 8, 6, 2, 32, 2.0)
        return RACEServiceConfig, RACEService, JRACECfg, JRACE, RACE, p
    family = kind.split("_")[1]
    kw = dict(KDE, hash_family=family)
    p = _exact_params(family, 3, 8, 6, 2, 32, 2.0)
    return KDEServiceConfig, KDEService, JKDECfg, JKDE, kw, p


def _port(kind, **extra):
    cfg_cls, svc_cls, _, _, kw, p = _spec(kind)
    return svc_cls(cfg_cls(**{**kw, **extra}), device="cpu",
                   params=convert.params_from_numpy(fields(p), "cpu"))


_JITTED = ("_prepare_fn", "_commit_fn", "_query_fn", "_topk_fn", "_delete_fn",
           "_delete_commit_fn", "_grid_fn", "_grid_query_fn")
_REF_FNS: dict = {}


def _ref(kind, **extra):
    """A reference service with the exact parameters.  Its jitted functions
    close over the service they were built for, so every later service of a
    kind reuses the first one's (same parameters and sketch config; the
    overrides here are durability settings they never read) instead of
    compiling its own."""
    _, _, cfg_cls, svc_cls, kw, p = _spec(kind)
    svc = svc_cls(cfg_cls(**{**kw, **extra}))
    svc.params = p                 # before any call traces the jitted fns
    fns = _REF_FNS.setdefault(kind, {f: getattr(svc, f) for f in _JITTED
                                     if hasattr(svc, f)})
    for name, fn in fns.items():
        setattr(svc, name, fn)
    return svc


def _drive(kind, svc, data):
    """The operation stream: chunks, a logged mutation, more chunks."""
    svc.ingest(data[:200])
    if kind == "retrieval":
        svc.delete(data[10])
    elif kind == "race":
        svc.delete(data[:3])
    else:
        svc.advance_clock(int(svc.state.t) + 30)
    svc.ingest(data[200:])


def _queries(seed=9, n=20):
    return _data(n, seed) + np.float32(1 / 32)


def _assert_answers(kind, got, want):
    if kind == "retrieval":
        for g, w, f in zip(got, want, ("index", "distance", "found",
                                       "n_candidates")):
            if f == "distance":
                np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL,
                                           atol=ATOL)
            else:
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=f)
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def streamed():
    """Each kind's reference and port service after the same stream."""
    data = _data()
    out = {}
    for kind in KINDS:
        ref, port = _ref(kind), _port(kind)
        _drive(kind, ref, data)
        _drive(kind, port, data)
        out[kind] = (ref, port)
    yield data, out
    for ref, port in out.values():
        ref.close()
        port.close()


@pytest.mark.parametrize("kind", KINDS)
def test_service_state_and_answers_match_reference(streamed, kind):
    data, svcs = streamed
    ref, port = svcs[kind]
    assert_state_equal(port.state, ref.state)
    qs = _queries()
    if kind == "retrieval":
        assert int(port.state.write_ptr) != int(port.state.n_stored)  # wrapped
        assert port.stored == ref.stored
        _assert_answers(kind, port.query(qs), ref.query(qs))
        ids, d = port.query_topk(qs)
        rids, rd = ref.query_topk(qs)
        np.testing.assert_array_equal(ids, np.asarray(rids))
        np.testing.assert_allclose(d, np.asarray(rd), rtol=RTOL, atol=ATOL)
    elif kind == "race":
        assert port.count == ref.count == N - 3
        _assert_answers(kind, port.query(qs), ref.query(qs))
        _assert_answers(kind, port.kde(qs), ref.kde(qs))
    else:
        assert port.steps == ref.steps == N + 30 > KDE["window"]
        _assert_answers(kind, port.query(qs), ref.query(qs))
        _assert_answers(kind, port.density(qs), ref.density(qs))


def _crash_mid_stream(svc, data, fail_after):
    """The commit path dies after ``fail_after`` commits (an injected crash
    at ``engine.commit``); every chunk was WAL-logged at enqueue time."""
    plan = faults.FaultPlan([faults.FaultSpec("engine.commit", "crash",
                                              hit=fail_after + 1)])
    with faults.installed(plan):
        svc.ingest_async(data)
        with pytest.raises(RuntimeError, match="injected crash"):
            svc.flush()
    svc.close()
    assert svc.health()["state"] == "closed" and plan.fired


@pytest.mark.parametrize("kind", KINDS)
def test_port_recovers_from_its_snapshot_and_wal_tail(tmp_path, streamed, kind):
    """A durable port service fed the stream's head, then a crash in the
    tail: a fresh one recovers (snapshot + WAL tail through the same
    prepare/commit path) to the uninterrupted run's state, and both keep
    ingesting on the same schedule."""
    data, svcs = streamed
    ref, port = svcs[kind]
    dur = dict(snapshot_dir=str(tmp_path), snapshot_every=2)
    crash = _port(kind, **dur, pipelined=False)
    crash.ingest(data[:200])
    if kind == "retrieval":
        crash.delete(data[10])
    elif kind == "race":
        crash.delete(data[:3])
    else:
        crash.advance_clock(int(crash.state.t) + 30)
    _crash_mid_stream(crash, data[200:], fail_after=1)
    rec = _port(kind, **dur)
    with pytest.raises(RuntimeError, match="recover"):
        rec.ingest(data[:1])
    replayed = rec.recover()
    assert 0 < replayed
    assert_state_equal(rec.state, port.state)
    more = _data(64, seed=5)
    live = _port(kind)
    _drive(kind, live, data)
    rec.ingest(more)
    live.ingest(more)
    assert_state_equal(rec.state, live.state)
    rec.close()
    live.close()


def _drive_head(kind, svc, data):
    """The stream up to one chunk past the mutation (the rest: `_tail`)."""
    svc.ingest(data[:200])
    if kind == "retrieval":
        svc.delete(data[10])
    elif kind == "race":
        svc.delete(data[:3])
    else:
        svc.advance_clock(int(svc.state.t) + 30)
    svc.ingest(data[200:_tail(kind)])


def _tail(kind):
    return 200 + (KDE if kind.startswith("kde") else RETR)["ingest_chunk"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_durability_crosses_packages(tmp_path, streamed, kind, writer):
    """One package writes a snapshot (after four chunks) and a WAL tail
    past it (the mutation and one chunk); the other ``recover()``s the
    directory, takes the rest of the stream on the same seq schedule, and
    ends in the uninterrupted state."""
    data, svcs = streamed
    ref, port = svcs[kind]
    dur = dict(snapshot_dir=str(tmp_path), snapshot_every=4)
    make = {"port": _port, "reference": _ref}
    w = make[writer](kind, **dur)
    _drive_head(kind, w, data)
    w.close()
    reader = "reference" if writer == "port" else "port"
    r = make[reader](kind, **dur)
    assert r.recover() == 2            # the mutation and one chunk
    r.ingest(data[_tail(kind):])
    assert_state_equal(port.state, r.state)
    assert_state_equal(r.state, ref.state)
    r.close()


@pytest.mark.parametrize("kind", KINDS)
def test_coalesced_queries_bit_identical_to_direct(streamed, kind):
    """Sixteen client threads of B = 1..3 rows through the batcher
    (``max_wait_us`` 0, and a 2 ms budget so ticks coalesce), every answer
    bit-identical to the direct one; the direct path equals the core batch
    function on the padded block."""
    data, svcs = streamed
    _, port = svcs[kind]
    qs = _queries(seed=11, n=48)
    kinds = {"retrieval": ("cr", "topk"), "race": ("kde", "density")}.get(
        kind, ("kde", "density"))
    direct = {k: port._serve_query(k, qs) for k in kinds}
    if kind == "race":
        want = race.race_query_batch(port.state, port.params,
                                     torch.from_numpy(qs[:16]))
        np.testing.assert_array_equal(direct["kde"][:16], want.numpy())
    for wait in (0.0, 2000.0):
        port._batch_queries, port._max_wait_us = True, wait
        port._batcher = None
        got = {}

        def client(c):
            for j in range(c, 48, 16):
                rows = qs[j:j + 1 + j % 3]
                kd = kinds[j % 2]
                got[(j, kd)] = (rows.shape[0], port._serve_query(kd, rows))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(got) == 48
        for (j, kd), (b, res) in got.items():
            want = jax.tree.map(lambda a: a[j:j + b], direct[kd])
            for x, y in zip(jax.tree.leaves(res), jax.tree.leaves(want)):
                np.testing.assert_array_equal(x, y)
        stats = port.stats()["batcher"]
        assert stats["queries"] == 48
        if wait:
            assert stats["ticks"] < 48          # requests coalesced
        port._batcher.close()
    port._batch_queries, port._batcher = False, None
    fut = port.submit_query(np.zeros((0, 8), np.float32))
    assert jax.tree.leaves(fut.result())[0].shape[0] == 0
    port._batcher.close()
    port._batcher = None


def test_batch_plan_agrees_with_the_reference():
    rng = np.random.default_rng(7)
    for _ in range(300):
        n = int(rng.integers(1, 12))
        pending = list(zip(np.cumsum(rng.exponential(100.0, n)).tolist(),
                           rng.integers(0, 9, n).tolist()))
        now = pending[0][0] + float(rng.exponential(200.0))
        mb, mw = int(rng.integers(1, 20)), float(rng.choice([0.0, 50.0, 500.0]))
        assert tengine.batch_plan(pending, now, mb, mw) == \
            jengine.batch_plan(pending, now, mb, mw)


def _prefix_answers(kind, port, data, qs):
    """Expected answers after every committed prefix, from the port's core
    functions on a padded query block with the service's keys."""
    block = torch.from_numpy(np.concatenate(
        [qs, np.zeros((16 - len(qs), 8), np.float32)]))
    chunk = port._chunk
    p = port.params
    if kind == "retrieval":
        st = sann.sann_empty_state(port.cfg, "cpu")
        key = prng.fold_in(prng.PRNGKey(1, "cpu"), 0)
        step = lambda st, x, seq: sann.sann_insert_batch(  # noqa: E731
            st, p, x, prng.fold_in(key, seq), port.cfg)
        ask = lambda st: sann.sann_query_topk_batch(  # noqa: E731
            st, p, block, port.cfg, RETR["topk"])[0][:len(qs)]
    elif kind == "race":
        st = race.race_init(6, 32, "cpu")
        step = lambda st, x, seq: race.race_update_batch(st, p, x)  # noqa: E731
        ask = lambda st: race.race_query_batch(st, p, block)[:len(qs)]  # noqa: E731
    else:
        st = swakde.swakde_init(port.sketch_cfg, "cpu")
        step = lambda st, x, seq: swakde.swakde_update_chunk(  # noqa: E731
            st, p, x, port.sketch_cfg)
        ask = lambda st: swakde.swakde_query_batch(  # noqa: E731
            st, p, block, port.sketch_cfg)[:len(qs)]
    out = [ask(st).numpy()]
    for seq, i in enumerate(range(0, len(data), chunk)):
        st = step(st, torch.from_numpy(data[i:i + chunk]), seq)
        out.append(ask(st).numpy())
    return out


@pytest.mark.parametrize("kind", ["retrieval", "kde_srp", "race"])
def test_concurrent_queries_see_committed_prefixes(kind):
    """Background ingest while two threads query: every answer is the
    answer after some committed prefix (never a torn state), and each
    thread's prefixes never go back."""
    data = _data(320, seed=3)
    qs = _queries(seed=4, n=6)
    port = _port(kind, ingest_chunk=32)
    prefixes = _prefix_answers(kind, port, data, qs)
    assert len({a.tobytes() for a in prefixes}) > 5
    kd = "topk" if kind == "retrieval" else "kde"
    seen = {0: [], 1: []}
    stop = threading.Event()

    def reader(r):
        while not stop.is_set():
            out = port._serve_query(kd, qs)
            out = out[0] if kind == "retrieval" else out
            ks = [k for k, a in enumerate(prefixes) if np.array_equal(out, a)]
            seen[r].append(ks)
            if port.version == len(prefixes) - 1:
                break

    threads = [threading.Thread(target=reader, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    port.ingest_async(data)
    port.flush()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    assert not any(t.is_alive() for t in threads)
    for r in (0, 1):
        assert seen[r] and all(seen[r]), "torn state: matches no prefix"
        firsts = [ks[0] for ks in seen[r]]
        assert firsts == sorted(firsts)
    port.close()


def test_grid_cache_once_per_commit_and_clock_replays(tmp_path):
    port = _port("kde_srp", snapshot_dir=str(tmp_path), snapshot_every=100)
    data = _data(120, seed=6)
    port.ingest(data)
    qs = _queries()
    a = port.query(qs)
    b = port.query(qs)
    assert port.grid_computes == 1
    np.testing.assert_array_equal(a, b)
    port.advance_clock(200)
    c = port.query(qs)
    assert port.grid_computes == 2 and port.steps == 200
    assert not np.array_equal(a, c)
    port.close()
    rec = _port("kde_srp", snapshot_dir=str(tmp_path), snapshot_every=100)
    assert rec.recover() == 4                  # three chunks and the clock
    assert rec.steps == 200
    np.testing.assert_array_equal(rec.query(qs), c)
    rec.close()


def test_services_need_a_card_or_cpu_and_one_shard():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only box")
    for kind in ("retrieval", "kde_srp", "race"):
        cfg_cls, svc_cls, *_, kw, _ = _spec(kind)
        with pytest.raises(RuntimeError, match="CUDA"):
            svc_cls(cfg_cls(**kw))
        for extra in ({"num_shards": 2}, {"mesh": object()}):
            with pytest.raises(NotImplementedError, match="queue 1, item 3"):
                svc_cls(cfg_cls(**kw, **extra), device="cpu")
        assert _port(kind).num_shards == 1
