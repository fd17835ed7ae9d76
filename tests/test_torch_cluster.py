"""The port's in-process merge cluster (repro_torch.serve.cluster) against
the reference's, on the CPU.

Every worker is one of the port's services; the reference's parameters
cross over (`convert.params_from_numpy`) and the data lie on a 1/16 grid,
so both packages hash alike.  Each worker's share of the stream is a whole
number of ingest chunks (the rows are picked by their hash owner), so the
reference's jitted functions compile once.  Then:

* `hash_partition` and its splitmix64 content hash are bit-identical;
* each `Cluster*Service`'s merged state equals the reference's bit for bit
  (RACE counters, SW-AKDE EH cells, S-ANN tables and stamps; the
  reference's also through `convert`), RACE and
  SW-AKDE answers are equal and S-ANN ids equal with distances within
  `batch_score_topk`'s tolerance (rtol 1e-5, atol 1e-6); RACE equals one
  service over the whole stream, SW-AKDE's estimates equal one service's
  while nothing has expired, and S-ANN equals the port's `sann_merge` of
  its workers' states;
* a cluster whose workers are each sharded over two CPU entries merges
  and answers as the reference's cluster over single-device workers;
* a durable cluster directory written by either package is recovered by
  the other to the same merged state;
* a worker killed through the ``faults`` sites (its commit and its
  recovery crash) is declared dead and its WAL tail re-partitioned to the
  survivors: the RACE merge stays equal to one service over the stream.
"""
import numpy as np
import pytest
import torch

from repro.serve import cluster as jcluster
from repro.serve.kde_service import KDEService as JKDE
from repro.serve.kde_service import KDEServiceConfig as JKDECfg
from repro.serve.race_service import RACEService as JRACE
from repro.serve.race_service import RACEServiceConfig as JRACECfg
from repro.serve.retrieval import RetrievalConfig as JRetrCfg
from repro.serve.retrieval import RetrievalService as JRetr
from repro_torch import convert
from repro_torch.core import sann
from repro_torch.parallel.sharding import Mesh
from repro_torch.persist import faults
from repro_torch.serve import cluster
from repro_torch.serve.kde_service import KDEService, KDEServiceConfig
from repro_torch.serve.race_service import RACEService, RACEServiceConfig
from repro_torch.serve.retrieval import RetrievalConfig, RetrievalService

from torch_parity import (ATOL, RTOL, assert_state_equal, exact_params,
                          fields, grid_data, port_params)

D, CHUNK, QB = 8, 32, 16
RETR = dict(dim=D, n_max=64, eta=0.1, r=0.4, c=2.0, w=1.0, L=6, k=3,
            bucket_cap=4, ingest_chunk=CHUNK, query_block=QB, topk=8)
KDE = dict(dim=D, L=6, W=32, window=4096, eh_eps=0.2, ingest_chunk=CHUNK,
           query_block=QB, k=2, w=2.0, hash_family="pstable")
RACE = dict(dim=D, L=6, W=32, ingest_chunk=CHUNK, query_block=QB,
            hash_family="pstable", k=2, w=2.0)
KINDS = ("race", "kde", "retrieval")


def test_hash_partition_matches_reference():
    xs = np.random.default_rng(0).normal(size=(500, 16)).astype(np.float32)
    np.testing.assert_array_equal(cluster._mix_u64(xs), jcluster._mix_u64(xs))
    for k in (1, 2, 3, 4, 7):
        np.testing.assert_array_equal(cluster.hash_partition(xs, k),
                                      jcluster.hash_partition(xs, k))
    assert cluster.hash_partition(xs, 4).dtype == np.int64


def _balanced(K, per_worker, seed):
    """A stream whose rows each worker owns ``per_worker`` of, in stream
    order (rows picked from a larger draw by their hash owner)."""
    pool = grid_data(4 * K * per_worker + 64, D, seed=seed)
    pid = cluster.hash_partition(pool, K)
    keep = np.zeros(len(pool), bool)
    for w in range(K):
        keep[np.nonzero(pid == w)[0][:per_worker]] = True
    out = pool[keep]
    assert len(out) == K * per_worker
    return out


def _spec(kind):
    if kind == "retrieval":
        cfg = sann.SANNConfig(**{k: RETR[k] for k in (
            "dim", "n_max", "eta", "r", "c", "w", "L", "k",
            "bucket_cap")}).resolved()
        p = exact_params("pstable", 1, D, cfg.L, cfg.k, cfg.n_buckets, cfg.w)
        return (RetrievalConfig, RetrievalService, cluster.ClusterRetrievalService,
                JRetrCfg, JRetr, jcluster.ClusterRetrievalService, RETR, p)
    if kind == "race":
        p = exact_params("pstable", 2, D, 6, 2, 32, 2.0)
        return (RACEServiceConfig, RACEService, cluster.ClusterRACEService,
                JRACECfg, JRACE, jcluster.ClusterRACEService, RACE, p)
    p = exact_params("pstable", 3, D, 6, 2, 32, 2.0)
    return (KDEServiceConfig, KDEService, cluster.ClusterKDEService,
            JKDECfg, JKDE, jcluster.ClusterKDEService, KDE, p)


def _port(kind, K, **extra):
    cfg_cls, _, cl_cls, _, _, _, kw, p = _spec(kind)
    return cl_cls(cfg_cls(**{**kw, **extra}), num_workers=K, merge_every=4,
                  device="cpu", params=port_params(p))


_JITTED = ("_prepare_fn", "_commit_fn", "_query_fn", "_topk_fn", "_delete_fn",
           "_delete_commit_fn", "_grid_fn", "_grid_query_fn")
_REF_FNS: dict = {}


def _ref(kind, K, **extra):
    """The reference's cluster with the exact parameters; every worker and
    cluster of a kind reuses the first one's jitted functions (identical
    parameters and sketch config)."""
    _, _, _, jcfg_cls, jsvc_cls, jcl_cls, kw, p = _spec(kind)
    cfg = jcfg_cls(**{**kw, **extra})
    fns = _REF_FNS.setdefault(kind, {})

    def make(w):
        svc = jsvc_cls(jcluster._worker_cfg(
            cfg, w, batch_queries=False,
            **({"ingest_salt": w} if kind == "retrieval" else {})))
        svc.params = p                 # before any call traces a jit
        for name in _JITTED:
            if hasattr(svc, name):
                setattr(svc, name, fns.setdefault(name, getattr(svc, name)))
        return svc

    cl = jcl_cls(cfg, num_workers=K, merge_every=4, make_worker=make)
    cl._merge_fn = fns.setdefault(("merge", K), cl._merge_fn)
    return cl


def _assert_answers(kind, got, want):
    if kind == "retrieval":
        for f in ("index", "found", "n_candidates"):
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)), err_msg=f)
        np.testing.assert_allclose(got.distance, np.asarray(want.distance),
                                   rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("kind", KINDS)
def test_cluster_matches_reference(kind):
    K = 2
    data = _balanced(K, 4 * CHUNK, seed=5)
    port, ref = _port(kind, K), _ref(kind, K)
    port.ingest_async(data)            # == ingest: the same chunk seqs
    port.flush()
    ref.ingest(data)
    merged = port.merged_state()
    assert_state_equal(merged, ref.merged_state())
    from_numpy = {"retrieval": convert.sann_state_from_numpy,
                  "race": convert.race_state_from_numpy,
                  "kde": convert.swakde_state_from_numpy}[kind]
    assert_state_equal(from_numpy(fields(ref.merged_state()), "cpu"), merged)
    qs = grid_data(2 * QB - 3, D, seed=9) + np.float32(1 / 32)
    _assert_answers(kind, port.query(qs), ref.query(qs))
    cfg_cls, svc_cls, _, _, _, _, kw, p = _spec(kind)
    if kind == "retrieval":
        ids, d = port.query_topk(qs)
        rids, rd = ref.query_topk(qs)
        np.testing.assert_array_equal(ids, np.asarray(rids))
        np.testing.assert_allclose(d, np.asarray(rd), rtol=RTOL, atol=ATOL)
        w = port.workers
        want = sann.sann_merge(w[0].state, w[1].state, w[0].params, w[0].cfg)
        assert_state_equal(merged, want)
        assert port.stored == ref.stored > 0
    else:
        single = svc_cls(cfg_cls(**kw), device="cpu", params=port_params(p))
        single.ingest(data)
        if kind == "race":
            assert_state_equal(merged, single.state)
        else:   # worker clocks tick per local point: the stamps differ, the
                # estimates (nothing has expired) do not
            np.testing.assert_array_equal(port.query(qs), single.query(qs))
        second = "kde" if kind == "race" else "density"
        _assert_answers(kind, getattr(port, second)(qs),
                        getattr(ref, second)(qs))
        single.close()
    port.close()
    ref.close()


@pytest.mark.parametrize("kind", KINDS)
def test_cluster_of_sharded_workers_matches_reference(kind):
    """K = 2 workers, each sharded over a two-entry CPU mesh: the merged
    state (folded through each worker's single-device form) equals the
    reference's cluster over single-device workers fed the same chunks, bit
    for bit, and so do the answers read through the sharded template."""
    K = 2
    data = _balanced(K, 4 * CHUNK, seed=5)
    port = _port(kind, K, mesh=Mesh(("cpu", "cpu")))
    assert all(w.num_shards == 2 for w in port.workers)
    ref = _ref(kind, K)
    port.ingest(data)
    ref.ingest(data)
    assert_state_equal(port.merged_state(), ref.merged_state())
    qs = grid_data(2 * QB - 3, D, seed=9) + np.float32(1 / 32)
    _assert_answers(kind, port.query(qs), ref.query(qs))
    if kind == "retrieval":
        ids, d = port.query_topk(qs)
        rids, rd = ref.query_topk(qs)
        np.testing.assert_array_equal(ids, np.asarray(rids))
        np.testing.assert_allclose(d, np.asarray(rd), rtol=RTOL, atol=ATOL)
    else:
        second = "kde" if kind == "race" else "density"
        _assert_answers(kind, getattr(port, second)(qs),
                        getattr(ref, second)(qs))
    port.close()
    ref.close()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cluster_recovery_crosses_packages(tmp_path, kind, writer):
    """One package's durable cluster (snapshots every 2 operations, a WAL
    tail past them) stops; a fresh cluster of the other package recovers
    the directory to the same merged state and answers."""
    K = 2
    data = _balanced(K, 5 * CHUNK, seed=6)
    dur = dict(snapshot_dir=str(tmp_path), snapshot_every=2)
    make = {"port": _port, "reference": _ref}
    w = make[writer](kind, K, **dur)
    w.ingest(data)
    want = w.merged_state()
    w.close()
    r = make["reference" if writer == "port" else "port"](kind, K, **dur)
    assert r.recover() > 0
    assert_state_equal(r.merged_state(), want)
    qs = grid_data(QB, D, seed=3)
    live = _port(kind, K)
    live.ingest(data)
    _assert_answers(kind, live.query(qs), r.query(qs))
    live.close()
    r.close()


def test_port_cluster_salvages_a_dead_worker(tmp_path):
    """RACE, 3 workers; worker 1's commit crashes and so does every attempt
    to recover it, so it is declared dead and its WAL tail re-ingested
    through the survivors: the merge equals one service over the stream,
    and ingest after the death stays exact."""
    K = 3
    data = _balanced(K, 4 * CHUNK, seed=7)
    cl = _port("race", K, snapshot_dir=str(tmp_path), snapshot_every=10_000)
    cl._failover = cluster.FailoverConfig(on_degraded="partial",
                                          max_retries=1, backoff_s=0.001)
    plan = faults.FaultPlan([
        faults.FaultSpec(site="worker_1/engine.commit", mode="crash", hit=2),
        faults.FaultSpec(site="worker_1/engine.recover", mode="crash", hit=1,
                         count=99)])
    with faults.installed(plan):
        for i in range(0, len(data), 96):
            cl.ingest(data[i:i + 96])
    h = cl.health()
    assert h["dead_workers"] == [1] and h["salvage_complete"] == [1]
    assert h["counters"]["salvaged_rows"] > 0
    _, _, _, _, _, _, kw, p = _spec("race")
    single = RACEService(RACEServiceConfig(**kw), device="cpu",
                         params=port_params(p))
    single.ingest(data)
    assert_state_equal(cl.merged_state(), single.state)
    assert cl.count == single.count == len(data)
    more = grid_data(64, D, seed=8)
    cl.ingest(more)
    single.ingest(more)
    assert_state_equal(cl.merged_state(), single.state)
    cl.close()
    single.close()


def test_clusters_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only box")
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.ClusterRACEService(RACEServiceConfig(dim=4), num_workers=2)
