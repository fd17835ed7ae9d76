#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch/``), then drives the main path through the entry points a
user calls, at full width:

* **S-ANN at SIFT1M scale** (ann-benchmarks ``sift-128-euclidean``: 1 000 000
  base vectors, 10 000 queries, d = 128; synthetic SIFT-like data drawn on
  the device): ``sann_insert_chunked`` in chunks of 4096, then
  ``sann_query_batch`` and ``sann_query_topk_batch(topk=50)`` in blocks of
  2048, with recall@50 against an exact top-50 computed here;
* **SW-AKDE + RACE** on a news-headlines-like stream (d = 384, 1 048 576
  points, chunks of 4096), ``L = W = 96``, window 65 536, EH eps 0.1, then
  10 000 queries through ``swakde_query_batch`` and ``race_query_batch``:
  once with p-stable params (k = 2, w = 4) and once with SRP params (k = 2,
  as ``benchmarks/bench_kde.py`` builds them), whose hashing is the
  ``srp_hash`` kernel;
* **the per-point oracles** (the paper's Alg. 1 and Alg. 2 one point and one
  query at a time) on those states: ``sann_query`` over 1024 queries and
  ``sann_query_topk`` over 256 (the ``cand_score`` kernel), held against the
  batch engine; ``sann_insert_stream`` over 16 384 points against
  ``sann_insert_batch``; ``swakde_stream`` and ``race_update`` over 8192
  points against the chunked paths; the per-query KDE functions against the
  batch ones; ``swakde_merge``; and the Corollary-4.2 ``BatchSWAKDE``.
  Only the oracle streams are cut (per-point Python loops);
* **sketch-gated LM decode**, gemma3-4b at its published width and depth in
  bf16 with random weights from the seed (``init_model`` →
  ``init_cache(sketch=True)`` → ``make_serve_step(sketch=True)``): 4
  requests of 512 prompt tokens fed one a step, then 512 greedy tokens,
  over a 4096-token cache; the five global layers' attention is the
  ``sketch_decode_attn`` kernel.  Then B = 1 over a 131 072-token cache
  whose block signatures are sparse (8 steps from length 131 000), and the
  first 6 layers in fp32 against the CPU plain path (depth cut: the CPU
  copy of the weights);
* **the streaming services** on the same streams, fed from the host through
  ``ingest_async`` (calls of 65 536 rows, ``max_pending`` 65 536) and
  ``flush``: ``RetrievalService`` (the S-ANN configuration above,
  ``ingest_chunk`` 4096, ``query_block`` 2048), ``KDEService`` (p-stable and
  SRP, then a clock advance) and ``RACEService`` (p-stable, then a turnstile
  delete of 5 rows), each durable (snapshots every 64 operations, the WAL
  compacted behind them) and volatile, each recovered by a fresh service
  from its directory; every state bit-identical to a direct core
  prepare/commit loop on the card with the same keys, 2048-query batches
  equal to the core batch queries, two KDE query batches between commits
  building the grid once, and 16 closed-loop B = 1 clients through the
  coalescing scheduler, every answer bit-identical.  Each of ``srp_hash``,
  ``race_hist``, ``batch_score_topk``, ``swakde_segment_pass`` and
  ``sann_table_scatter`` must launch there;
* **multi-tenant fleets** (``TenantFleet``), fed mixed chunks of 4096 rows
  whose tenants are Zipf (s = 1.1), one chunk all one tenant's: RACE (SRP,
  news width, 1 048 576 points) in 256 hot slots over 1024 tenants,
  spilling and reactivating, also durable and recovered; SW-AKDE
  (p-stable, eps 0.1, window 8192 a tenant, 1 048 576 points) over 256
  tenants; S-ANN (SIFT shape, n_max 65 536 a tenant, 65 536 points) in 64
  hot slots over 72 tenants, then a 2048-query block of top-50 and (c, r)
  queries.  Every tenant's row must equal its sub-stream through the
  single-sketch core loop on the card with the fleet's codes and keys, and
  every answer its own sketch's; each kind at T = 8 (re-run on the CPU)
  and T = 256 launches each commit kernel once an operation;
* **the in-process merge cluster** at K = 1, 2 and 4 workers on the card:
  ``ClusterRetrievalService`` (SIFT1M shape; the merge against
  ``sann_merge`` of the workers and the canonical interleaving rule
  replayed on the CPU), ``ClusterKDEService`` (news shape, eps 0.01,
  worker windows 65 536 / K, nothing expiring: answers equal one service's)
  and ``ClusterRACEService`` (equal to one service over the stream), a
  durable cluster recovered, and a worker killed at a ``faults`` site and
  salvaged;
* **the RPC cluster** (``repro_torch.net``): the same clusters with each
  worker a spawned process and CUDA context of its own on the card, one
  RPC a chunk over the reference's wire format: RACE at K = 1, 2, 4,
  SW-AKDE at K = 4 and S-ANN at K = 4 (n_max 250 000 a worker: a worker's
  snapshot must fit the protocol's 256 MiB frame), each equal bit for bit
  to the in-process cluster on the same stream; a K = 2, n_max 1 000 000
  S-ANN snapshot refused by the frame cap; a durable K = 2 RACE cluster
  with a dropped ``net.send`` retried in place, stopped and recovered; a
  SIGKILLed worker respawned and recovered, and with respawn off salvaged.
  Each worker process must launch its commit kernels (its ``K_STATS``
  reply), and no worker process may outlive ``close()``.

Keep decisions come from a threefry key on each device.  Kernel launch
counts are zeroed just before each path and read just after; the SW-AKDE
commit must be one ``swakde_segment_pass`` launch a chunk that never waits
on the device (the profile's SW-AKDE ingest windows show only their closing
synchronize).  Each path's
first 8 chunks are re-run on the CPU (the kernels' plain versions) with the
same codes, and with keep masks the CPU draws itself from the same key, and
must give bit-identical state.  Then every kernel is held against its plain
PyTorch version on the card at the main path's shapes and timed beside it
(and beside the one PyTorch call that computes the same function, where
there is one; for the S-ANN table commit, beside the plain PyTorch
sequence it replaced; for the S-ANN scorer's gather entry, beside the
``points[cand]`` gather + ``(B, M, d)`` entry it replaced).  The drained
SW-AKDE commit also runs past 32 EH slots at full width over chunks that
expire: eps 0.01 (52 slots, the cell in shared memory), bit-identical to
the CPU plain path on every row, and eps 1e-4 (5002 slots, a 422 160-byte
cell in global memory), bit-identical to it on rows 0-1; ``race_hist``
must run as one device op a call.

Prints one JSON line per phase, the ``{"kernels": [...]}`` summary, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# Main-path sizes (widths are the configurations' own; never narrowed).
SANN_N, SANN_QUERIES, SANN_DIM = 1_000_000, 10_000, 128
KDE_N, KDE_QUERIES, KDE_DIM = 1_048_576, 10_000, 384
CHUNK, QUERY_BLOCK, TOPK = 4096, 2048, 50
CROSS_CHUNKS = 8
KDE_ERR_QUERIES = 48
# Oracle (per-point) cuts: the stream length only, never a width.
ORACLE_QUERIES, ORACLE_TOPK_QUERIES = 1024, 256
ORACLE_SANN_POINTS, ORACLE_KDE_POINTS, ORACLE_KDE_QUERIES = 16_384, 8192, 256
MERGE_PREFIX = 131_072
BATCH_KDE_BATCHES, BATCH_KDE_WINDOW = 64, 16
# the SW-AKDE commit past 32 EH slots: eps 0.01 (52 slots), chunks on the
# card before the CPU cross-check (16 fill the 65 536 window) and in it;
# eps 1e-4 (5002 slots, the cell in global memory), its CPU cross-check on
# rows 0-1 only
SLOTS_EPS, SLOTS_WARM, SLOTS_CROSS = 0.01, 16, 4
BIG_CELL_EPS, BIG_CELL_CROSS, BIG_CELL_ROWS = 1e-4, 2, 2
RTOL, ATOL = 1e-5, 1e-6          # fp32 summation order (scorers)
SRP_FLIP_TOL = 1e-5              # |y| <= tol * |x| * |proj column| may flip
# LM decode (gemma3-4b at its published width): lm_serve, lm_long, and the
# depth-cut fp32 cross-check against the CPU
LM_BLOCK = 512                   # SKETCH_BLOCK
LM_B, LM_S, LM_PROMPT, LM_GEN = 4, 4096, 512, 512
LM_LONG_S, LM_LONG_LEN, LM_LONG_STEPS = 131_072, 131_000, 8
LM_CROSS_LAYERS = 6              # one 5:1 local:global period
SDA_RTOL, SDA_ATOL = 2e-5, 2e-5  # fp32 sums in another order (the reference
                                 # kernel's own bound, tests/test_kernels.py)

# the services phase: rows a producer hands `ingest_async` per call (16
# chunks), the snapshot cadence, closed-loop clients, rows the RACE delete
# takes back, and the kernels the services must launch
SERVICE_CALL_ROWS, SERVICE_SNAPSHOT_EVERY = 65_536, 64
SERVICE_CLIENTS, SERVICE_DELETE_ROWS, SERVICE_CLOCK_STEPS = 16, 5, 4096
SERVICE_KERNELS = ("srp_hash", "race_hist", "batch_score_topk",
                   "swakde_segment_pass", "sann_table_scatter")

# the fleet phase: tenants Zipf (s = 1.1) in mixed chunks of CHUNK rows, one
# chunk all one tenant's; RACE 256 hot slots over 1024 tenants, SW-AKDE 256
# tenants in 256 slots (window 8192 a tenant), S-ANN 64 hot slots over 72
# tenants (n_max 65 536 a tenant: 58 MB of tables each); each kind also at
# T = 8 (8 chunks, re-run on the CPU) and T = 256 (2 chunks)
FLEET_ZIPF_S, FLEET_TENANTS, FLEET_HOT, FLEET_HOT_CHUNK = 1.1, 1024, 256, 10
FLEET_RACE_N = FLEET_SW_N = KDE_N
FLEET_SW_TENANTS, FLEET_SW_WINDOW = 256, 8192
FLEET_SANN_TENANTS, FLEET_SANN_HOT = 72, 64
FLEET_SANN_NMAX = FLEET_SANN_N = 65_536
FLEET_GATE_T, FLEET_GATE_CHUNKS = (8, 256), {8: 8, 256: 2}
FLEET_DURABLE_CHUNKS, FLEET_SNAPSHOT_EVERY, FLEET_QUERIES = 4, 4, 2048
# the cluster phase: K workers on the one card; the KDE stream stays under
# every worker's window (65 536 / K) so nothing expires
CLUSTER_WORKERS = (1, 2, 4)
CLUSTER_KDE_WINDOW, CLUSTER_KDE_N, CLUSTER_DURABLE_N = 65_536, 61_440, 262_144
# the rpc_cluster phase: the cluster phase's workloads, each worker a spawned
# process; S-ANN at n_max 250 000 a worker, so that a worker's snapshot
# (164.5 MB) fits the wire protocol's 256 MiB frame (at 1 000 000 it is 434
# MB: that run must be refused); SW-AKDE and S-ANN merge at query time only
# (each merge pulls every worker's snapshot over TCP), RACE every 8 commits
RPC_SANN_NMAX, RPC_CAP_NMAX = 250_000, 1_000_000
RPC_MERGE_EVERY, RPC_TIMEOUT_S = 10**9, 120.0

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
PEAK_TF32_PER_S = 495e12        # H100 SXM TF32 tensor cores, dense

# file:line of the TPU kernel each CUDA kernel replaces
REPLACES = {
    "srp_hash": "src/repro/kernels/srp_hash.py:38",
    "race_hist": "src/repro/kernels/race_update.py:41",
    "cand_score": "src/repro/kernels/cand_score.py:27",
    "batch_score_topk": "src/repro/kernels/batch_score.py:73",
    "swakde_segment_pass": "src/repro/kernels/ingest_commit.py:57",
    "sann_table_scatter": "src/repro/kernels/ingest_commit.py:135",
    "sketch_decode_attn": "src/repro/kernels/sketch_decode_attn.py:81",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


# --------------------------------------------------------------------------
# data (drawn on the device from the seed; copies of the repository's
# benchmark generators `sift_like` and `text_like`)
# --------------------------------------------------------------------------

def sift_like(n, gen, device):
    """128-d clustered vectors (SIFT-like local-descriptor statistics)."""
    import torch
    centers = torch.randn((64, 128), generator=gen, device=device)
    which = torch.randint(0, 64, (n,), generator=gen, device=device)
    return centers[which] + 0.35 * torch.randn((n, 128), generator=gen,
                                               device=device)


def text_like(n, gen, device):
    """384-d normalised mixture embeddings (news-headline-like)."""
    import torch
    centers = torch.randn((20, 384), generator=gen, device=device)
    which = torch.randint(0, 20, (n,), generator=gen, device=device)
    x = centers[which] + 0.5 * torch.randn((n, 384), generator=gen,
                                           device=device)
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, iters: int, device, warmup: int = 2) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back calls, by CUDA
    events: the device time, or the host's time to issue the calls where
    that is longer (the wrapper's checks and the ctypes call)."""
    import torch
    for _ in range(warmup):
        fn()
    sync(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


KERNEL_SYMBOLS = {"race_hist": "race_hist_kernel",
                  # the commit's both launches: the tombstone copy and the
                  # append (`sann_table_scatter_kernel`)
                  "sann_table_scatter": "sann_table_scatter_",
                  "batch_score_topk": "batch_score_topk_kernel",
                  "swakde_segment_pass": "swakde_segment_pass_kernel",
                  "cand_score": "cand_score_kernel",
                  "srp_hash": "srp_hash_kernel",
                  # both launches of a call: the split pass and the combine
                  "sketch_decode_attn": "sketch_decode_attn_"}


def _device_us(evt) -> float:
    """Device time of a profiler event, or 0 for a host-side event."""
    if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_ms(fn, name: str, device, iters: int = 20):
    """Mean device time of kernel ``name`` per call of ``fn()``, from
    torch.profiler (the launch's own time, without the host's issue time);
    None if the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync(device)
    us = sum(_device_us(e) for e in prof.key_averages()
             if KERNEL_SYMBOLS[name] in e.key)
    return us / iters / 1e3 if us else None


def device_ms_all(fn, device, iters: int = 20):
    """Mean device time per call of ``fn()``, summed over every kernel and
    copy it runs (a yardstick's own device time), from torch.profiler;
    None if the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync(device)
    us = sum(_device_us(e) for e in prof.key_averages())
    return us / iters / 1e3 if us else None


def graph_ms(fn, device, iters: int = 20):
    """Mean device time per call of ``fn()``: ``iters`` calls captured in
    one CUDA graph and replayed, timed by CUDA events, so neither the
    host's issue time nor the profiler's record enters it (the graph's
    launch gaps do); None if the calls cannot be captured."""
    import torch
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()                     # first use (workspaces) outside the graph
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        sync(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        del graph
        return ms
    except Exception:                # a call that cannot be captured
        sync(device)
        return None


SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def host_waits(fn, device) -> int:
    """The host's waits on the device in one profiled call of ``fn()``
    followed by the closing synchronize, less those of an empty window
    (the closing synchronize's own)."""
    from torch.profiler import ProfilerActivity, profile

    def count(f):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            f()
            sync(device)
        return sum(e.count for e in prof.key_averages() if e.key in SYNC_EVENTS)

    fn()
    sync(device)
    return count(fn) - count(lambda: None)


def bound(nbytes: float, nops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    fp32 operations over the peak fp32 rate."""
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    o_ms = nops / PEAK_FP32_PER_S * 1e3
    return (o_ms, "operations") if o_ms > b_ms else (b_ms, "bytes")


def differing_leaves(a, b) -> list:
    """Names of the leaves of two states that differ (compared on the CPU)."""
    import torch
    return [f for f in a._fields
            if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())]


# --------------------------------------------------------------------------
# phase 1: device and build
# --------------------------------------------------------------------------

def phase_device():
    import torch
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_build.log").write_text(
        _build.BUILD_INFO.get("log", "(cached build)"))
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
          "build_s": build_s, "build_cached": _build.BUILD_INFO.get("cached")})


# --------------------------------------------------------------------------
# phase 2: S-ANN (main path) + CPU cross-check
# --------------------------------------------------------------------------

def r_for_eta(data, queries, eta):
    """bench_ann's radius rule: r sized so an r-ball holds ~3·n^eta points
    (linear-interpolated quantile of 32 queries' distances, + 1e-3)."""
    import torch
    n = data.shape[0]
    frac = min(0.5, 3.0 * n**eta / n)
    d = torch.sort(torch.cdist(queries[:32], data).reshape(-1)).values
    pos = frac * (d.numel() - 1)
    lo = math.floor(pos)
    v_lo, v_hi = float(d[lo]), float(d[min(lo + 1, d.numel() - 1)])
    return v_lo + (v_hi - v_lo) * (pos - lo) + 1e-3


def exact_topk_ids(data, queries, k, block=256):
    import torch
    out = []
    for i in range(0, queries.shape[0], block):
        d = torch.cdist(queries[i:i + block], data)
        out.append(torch.topk(d, k, dim=1, largest=False))
    return (torch.cat([o.indices for o in out]),
            torch.cat([o.values for o in out]))


def phase_sann(seed, device, n=SANN_N, n_queries=SANN_QUERIES):
    import torch
    from repro_torch import convert
    from repro_torch.core import lsh, prng, sann
    from repro_torch.kernels import ops

    gen = torch.Generator(device=device).manual_seed(seed)
    key = prng.PRNGKey(seed, device)
    data = sift_like(n, gen, device)
    idx = torch.randperm(n, generator=gen, device=device)[:n_queries]
    queries = data[idx] + 0.01 * torch.randn((n_queries, SANN_DIM),
                                             generator=gen, device=device)
    eta, c = 0.3, 1.5
    r = r_for_eta(data, queries, eta)
    cfg = sann.SANNConfig(dim=SANN_DIM, n_max=n, eta=eta, r=r, c=c,
                          w=2.0 * r, L=12, k=6, bucket_cap=32)

    sync(device)
    ops.reset_launches()
    t0 = time.perf_counter()
    cfg, params, state = sann.sann_init(cfg, gen, device=device)
    state = sann.sann_insert_chunked(state, params, data, key, cfg,
                                     chunk=CHUNK)
    sync(device)
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = [sann.sann_query_batch(state, params,
                                     queries[i:i + QUERY_BLOCK], cfg)
               for i in range(0, n_queries, QUERY_BLOCK)]
    sync(device)
    t_query = time.perf_counter() - t0
    t0 = time.perf_counter()
    topk = [sann.sann_query_topk_batch(state, params,
                                       queries[i:i + QUERY_BLOCK], cfg, TOPK)
            for i in range(0, n_queries, QUERY_BLOCK)]
    sync(device)
    t_topk = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    found = torch.cat([res.found for res in results])
    dist = torch.cat([res.distance for res in results])
    index = torch.cat([res.index for res in results])
    ids = torch.cat([t[0] for t in topk])
    dists = torch.cat([t[1] for t in topk])
    if index.shape != (n_queries,) or ids.shape != (n_queries, TOPK):
        fail("S-ANN query shapes")
    if not torch.isfinite(dist[found]).all() or (index[found] < 0).any():
        fail("S-ANN found answers must have finite distances and ids")
    if (dist[found] > c * r + 1e-4).any():
        fail("S-ANN found answer beyond c*r")
    # Slot ids map to stream positions through the arrival stamps.
    gt_ids, gt_d = exact_topk_ids(data, queries, TOPK)
    got = torch.where(ids >= 0, state.stamps[ids.clamp(min=0).long()].long(), -1)
    hit = (got[:, :, None] == gt_ids[:, None, :]).any(-1) & (got >= 0)
    recall_exact = float(hit.sum()) / (n_queries * TOPK)
    # ann-benchmarks' approximate recall@50 (bench_ann): hits within c times
    # the true 50th-neighbour distance
    approx = (ids >= 0) & (dists <= c * gt_d[:, -1:] + 1e-9)
    recall_approx = float(approx.float().mean())
    # the returned distances are the true distances to the stored points
    stored = state.points[ids.clamp(min=0).long()]
    true_d = torch.linalg.norm(stored - queries[:, None, :], dim=-1)
    ok_ids = ids >= 0
    if not torch.allclose(true_d[ok_ids], dists[ok_ids], rtol=1e-4, atol=1e-4):
        fail("S-ANN top-k distances disagree with the stored points")

    emit({"phase": "sann", "points": n, "queries": n_queries, "dim": SANN_DIM,
          "r": r, "c": c, "L": cfg.L, "k": cfg.k, "bucket_cap": cfg.bucket_cap,
          "capacity": cfg.capacity, "n_buckets": cfg.n_buckets,
          "table_mb": state.tables.numel() * 4 / 1e6,
          "n_stored": int(state.n_stored), "n_seen": int(state.n_seen),
          "ingest_s": t_ingest, "points_per_s": n / t_ingest,
          "query_s": t_query, "queries_per_s": n_queries / t_query,
          "topk_s": t_topk, "topk_queries_per_s": n_queries / t_topk,
          "found_rate": float(found.float().mean()),
          "recall50_exact_ids": recall_exact,
          "recall50_approx_c": recall_approx,
          "launches": {k: launches[k] for k in
                       ("sann_table_scatter", "batch_score_topk")},
          "stream_cut": None})

    # --- cross-check: the first chunks re-run on the CPU with the same codes;
    # each side draws its keep mask from the same key on its own device ---
    params_cpu = convert.params_from_numpy(convert.to_numpy(params), "cpu")
    ckeys = prng.split(prng.PRNGKey(seed + 1, device), CROSS_CHUNKS)
    st_dev = sann.sann_empty_state(cfg, device)
    st_cpu = sann.sann_empty_state(cfg, "cpu")
    keep_equal = True
    for i in range(CROSS_CHUNKS):
        x = data[i * CHUNK:(i + 1) * CHUNK]
        prep = sann.sann_prepare_chunk(params, x, ckeys[i], cfg)
        st_dev = sann.sann_commit_chunk(st_dev, prep, cfg)
        keep_cpu = prng.bernoulli(
            sann.sann_row_keys(ckeys[i].cpu(), x.shape[0]), cfg.keep_prob)
        keep_equal &= torch.equal(keep_cpu, prep.keep.cpu())
        codes = lsh.hash_points(params, x)
        prep_cpu = sann.sann_prepare_given_keep(
            params_cpu, x.cpu(), keep_cpu, cfg, codes=codes.cpu())
        st_cpu = sann.sann_commit_chunk(st_cpu, prep_cpu, cfg)
    bad = differing_leaves(st_dev, st_cpu)
    emit({"phase": "sann_cross_check", "chunks": CROSS_CHUNKS,
          "n_stored": int(st_cpu.n_stored), "keep_masks_equal": keep_equal,
          "bit_identical": not bad, "differing": bad})
    if not keep_equal:
        fail("S-ANN keep masks drawn on the card and on the CPU differ")
    if bad:
        fail(f"S-ANN device/CPU state differs in {bad}")
    del st_dev, st_cpu
    return dict(cfg=cfg, params=params, state=state, queries=queries,
                data=data, gen=gen, key=key, launches=launches,
                results=results, topk=topk, r=r, c=c)


# --------------------------------------------------------------------------
# phase 3: SW-AKDE + RACE (main path) + CPU cross-check
# --------------------------------------------------------------------------

def exact_kde(points, queries, w, p, block=65_536):
    """sum_x k^p(x, q) over ``points`` with the p-stable collision kernel."""
    import torch
    from repro_torch.core import lsh
    total = torch.zeros(queries.shape[0], dtype=torch.float64,
                        device=queries.device)
    for i in range(0, points.shape[0], block):
        d = torch.cdist(queries, points[i:i + block]).clamp(min=1e-6)
        total += lsh.pstable_collision_prob(d, w, p).sum(-1).double()
    return total


def phase_kde(seed, device, n=KDE_N, n_queries=KDE_QUERIES, window=65_536):
    import torch
    from repro_torch.core import lsh, race, swakde
    from repro_torch.kernels import ops

    L = W = 96
    kp, w = 2, 4.0
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    data = text_like(n, gen, device)
    queries = data[torch.randint(0, n, (n_queries,), generator=gen,
                                 device=device)]
    params = lsh.init_pstable(gen, KDE_DIM, L, kp, w, W, device=device)
    cfg = swakde.SWAKDEConfig(L=L, W=W, window=window, eh_eps=0.1)
    eh = cfg.eh_config()

    sync(device)
    ops.reset_launches()
    t0 = time.perf_counter()
    sw = swakde.swakde_stream_batched(swakde.swakde_init(cfg, device), params,
                                      data, cfg, chunk=CHUNK)
    sync(device)
    t_sw = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = race.race_init(L, W, device)
    for i in range(0, n, CHUNK):
        rc = race.race_update_batch(rc, params, data[i:i + CHUNK])
    sync(device)
    t_rc = time.perf_counter() - t0
    t0 = time.perf_counter()
    est_sw = torch.cat([swakde.swakde_query_batch(
        sw, params, queries[i:i + QUERY_BLOCK], cfg)
        for i in range(0, n_queries, QUERY_BLOCK)])
    sync(device)
    t_swq = time.perf_counter() - t0
    t0 = time.perf_counter()
    est_rc = torch.cat([race.race_query_batch(
        rc, params, queries[i:i + QUERY_BLOCK])
        for i in range(0, n_queries, QUERY_BLOCK)])
    sync(device)
    t_rcq = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    n_chunks = math.ceil(n / CHUNK)
    if est_sw.shape != (n_queries,) or not torch.isfinite(est_sw).all():
        fail("SW-AKDE estimates must be finite, one per query")
    if est_rc.shape != (n_queries,) or not torch.isfinite(est_rc).all():
        fail("RACE estimates must be finite, one per query")
    if int(rc.n) != n or int(rc.counts.sum()) != n * L or int(sw.t) != n:
        fail("stream counters")
    # accuracy on 48 queries against the exact (window) KDE, bench_kde's rule
    q48 = queries[:KDE_ERR_QUERIES]
    sw48 = swakde.swakde_query_batch(sw, params, q48, cfg).double()
    rc48 = race.race_query_batch(rc, params, q48).double()
    ex_win = exact_kde(data[-window:], q48, w, kp)
    ex_all = exact_kde(data, q48, w, kp)
    err_sw = float((torch.abs(sw48 - ex_win) / ex_win.clamp(min=1e-6)).mean())
    err_rc = float((torch.abs(rc48 - ex_all) / ex_all.clamp(min=1e-6)).mean())
    if launches["swakde_segment_pass"] != n_chunks:
        fail(f"swakde_segment_pass launches {launches['swakde_segment_pass']}: "
             f"expected one per committed chunk ({n_chunks})")
    prep = swakde.swakde_prepare_chunk(params, data[:CHUNK], cfg)
    commit_waits = host_waits(lambda: swakde.swakde_commit_chunk(sw, prep, cfg),
                              device)
    if commit_waits:
        fail(f"swakde_commit_chunk waited on the device {commit_waits} times")
    emit({"phase": "swakde_race", "points": n, "queries": n_queries,
          "dim": KDE_DIM, "L": L, "W": W, "window": window,
          "eh_levels": eh.levels, "eh_slots": eh.slots, "hash_k": kp, "w": w,
          "swakde_ingest_s": t_sw, "swakde_points_per_s": n / t_sw,
          "race_ingest_s": t_rc, "race_points_per_s": n / t_rc,
          "swakde_query_s": t_swq, "swakde_queries_per_s": n_queries / t_swq,
          "race_query_s": t_rcq, "race_queries_per_s": n_queries / t_rcq,
          "commit_launches": launches["swakde_segment_pass"],
          "host_syncs_in_commit": commit_waits,
          "mean_rel_err_swakde_window": err_sw, "mean_rel_err_race": err_rc,
          "launches": {k: launches[k] for k in
                       ("race_hist", "swakde_segment_pass")},
          "stream_cut": None})

    # --- cross-check: the first chunks re-run on the CPU from the same codes --
    sw_dev, sw_cpu = swakde.swakde_init(cfg, device), swakde.swakde_init(cfg, "cpu")
    rc_dev, rc_cpu = race.race_init(L, W, device), race.race_init(L, W, "cpu")
    for i in range(CROSS_CHUNKS):
        codes = lsh.hash_points(params, data[i * CHUNK:(i + 1) * CHUNK])
        sw_dev = swakde.swakde_commit_chunk(
            sw_dev, swakde.swakde_prepare_from_codes(codes, cfg), cfg)
        sw_cpu = swakde.swakde_commit_chunk(
            sw_cpu, swakde.swakde_prepare_from_codes(codes.cpu(), cfg), cfg)
        rc_dev = race.race_commit_chunk(
            rc_dev, race.RACEPrep(ops.race_hist(codes, W), CHUNK))
        rc_cpu = race.race_commit_chunk(
            rc_cpu, race.RACEPrep(ops.race_hist(codes.cpu(), W), CHUNK))
    bad = differing_leaves(sw_dev, sw_cpu) + [
        f"race.{f}" for f in differing_leaves(rc_dev, rc_cpu)]
    emit({"phase": "swakde_race_cross_check", "chunks": CROSS_CHUNKS,
          "bit_identical": not bad, "differing": bad})
    if bad:
        fail(f"SW-AKDE/RACE device/CPU state differs in {bad}")
    return dict(cfg=cfg, params=params, state=sw, data=data, gen=gen,
                queries=queries, launches=launches)



# --------------------------------------------------------------------------
# phase 3b: SW-AKDE + RACE with SRP params (the srp_hash kernel) + cross-check
# --------------------------------------------------------------------------

def exact_srp_kde(points, queries, p, block=131_072):
    """sum_x k^p(x, q) over ``points`` with the SRP collision kernel
    (1 - theta/pi)^p, from cosines of normalised vectors (float64)."""
    import torch
    qn = queries.double() / queries.double().norm(dim=1, keepdim=True)
    total = torch.zeros(queries.shape[0], dtype=torch.float64,
                        device=queries.device)
    for i in range(0, points.shape[0], block):
        x = points[i:i + block].double()
        cos = (qn @ (x / x.norm(dim=1, keepdim=True)).T).clamp(-1.0, 1.0)
        total += ((1.0 - torch.arccos(cos) / math.pi) ** p).sum(-1)
    return total


def srp_flips(x, params, got, want):
    """Count the codes where the kernel and the plain version differ, and
    fail unless every one has a projection with |y| (float64 product) <=
    SRP_FLIP_TOL * |x| * |proj column| (a sign within rounding of 0)."""
    from repro_torch.kernels import ref
    flips, unexplained = ref.srp_code_flips(x, params.proj, params.mix, got,
                                            want, SRP_FLIP_TOL)
    if unexplained:
        fail(f"srp_hash: {unexplained} codes differ from the plain version "
             f"away from a sign boundary")
    return flips


def phase_srp_kde(seed, kde_run, device, n=KDE_N, n_queries=KDE_QUERIES,
                  window=65_536):
    import torch
    from repro_torch import convert
    from repro_torch.core import lsh, race, swakde
    from repro_torch.kernels import ops

    L = W = 96
    kp = 2
    data, queries = kde_run["data"][:n], kde_run["queries"][:n_queries]
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    params = lsh.init_srp(gen, KDE_DIM, L, kp, W, device=device)
    cfg = swakde.SWAKDEConfig(L=L, W=W, window=window, eh_eps=0.1)

    sync(device)
    ops.reset_launches()
    t0 = time.perf_counter()
    sw = swakde.swakde_stream_batched(swakde.swakde_init(cfg, device), params,
                                      data, cfg, chunk=CHUNK)
    sync(device)
    t_sw = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = race.race_init(L, W, device)
    for i in range(0, n, CHUNK):
        rc = race.race_update_batch(rc, params, data[i:i + CHUNK])
    sync(device)
    t_rc = time.perf_counter() - t0
    t0 = time.perf_counter()
    est_sw = torch.cat([swakde.swakde_query_batch(
        sw, params, queries[i:i + QUERY_BLOCK], cfg)
        for i in range(0, n_queries, QUERY_BLOCK)])
    sync(device)
    t_swq = time.perf_counter() - t0
    t0 = time.perf_counter()
    est_rc = torch.cat([race.race_query_batch(
        rc, params, queries[i:i + QUERY_BLOCK])
        for i in range(0, n_queries, QUERY_BLOCK)])
    sync(device)
    t_rcq = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    n_chunks = math.ceil(n / CHUNK)
    n_blocks = math.ceil(n_queries / QUERY_BLOCK)
    if launches["srp_hash"] != 2 * n_chunks + 2 * n_blocks:
        fail(f"srp_hash launches {launches['srp_hash']}: expected one per "
             f"chunk and query block of each sketch")
    if launches["swakde_segment_pass"] != n_chunks:
        fail(f"swakde_segment_pass launches {launches['swakde_segment_pass']}: "
             f"expected one per committed chunk ({n_chunks})")
    for est in (est_sw, est_rc):
        if est.shape != (n_queries,) or not torch.isfinite(est).all():
            fail("SRP KDE estimates must be finite, one per query")
    if int(rc.n) != n or int(rc.counts.sum()) != n * L or int(sw.t) != n:
        fail("SRP stream counters")
    q48 = queries[:KDE_ERR_QUERIES]
    sw48 = swakde.swakde_query_batch(sw, params, q48, cfg).double()
    rc48 = race.race_query_batch(rc, params, q48).double()
    ex_win = exact_srp_kde(data[-window:], q48, kp)
    ex_all = exact_srp_kde(data, q48, kp)
    err_sw = float((torch.abs(sw48 - ex_win) / ex_win.clamp(min=1e-6)).mean())
    err_rc = float((torch.abs(rc48 - ex_all) / ex_all.clamp(min=1e-6)).mean())
    emit({"phase": "srp_kde", "points": n, "queries": n_queries,
          "dim": KDE_DIM, "L": L, "W": W, "window": window, "hash_k": kp,
          "swakde_ingest_s": t_sw, "swakde_points_per_s": n / t_sw,
          "race_ingest_s": t_rc, "race_points_per_s": n / t_rc,
          "swakde_query_s": t_swq, "swakde_queries_per_s": n_queries / t_swq,
          "race_query_s": t_rcq, "race_queries_per_s": n_queries / t_rcq,
          "mean_rel_err_swakde_window": err_sw, "mean_rel_err_race": err_rc,
          "launches": {k: launches[k] for k in
                       ("srp_hash", "race_hist", "swakde_segment_pass")},
          "stream_cut": None})

    # --- cross-check: 8 chunks on the CPU from the kernel's codes; the plain
    # version's own codes may differ only at sign boundaries ---
    params_cpu = convert.params_from_numpy(convert.to_numpy(params), "cpu")
    sw_dev, sw_cpu = swakde.swakde_init(cfg, device), swakde.swakde_init(cfg, "cpu")
    rc_dev, rc_cpu = race.race_init(L, W, device), race.race_init(L, W, "cpu")
    flips = 0
    for i in range(CROSS_CHUNKS):
        x = data[i * CHUNK:(i + 1) * CHUNK]
        codes = lsh.hash_points(params, x)
        flips += srp_flips(x.cpu(), params_cpu, codes,
                           lsh.hash_points(params_cpu, x.cpu()))
        sw_dev = swakde.swakde_commit_chunk(
            sw_dev, swakde.swakde_prepare_from_codes(codes, cfg), cfg)
        sw_cpu = swakde.swakde_commit_chunk(
            sw_cpu, swakde.swakde_prepare_from_codes(codes.cpu(), cfg), cfg)
        rc_dev = race.race_commit_chunk(
            rc_dev, race.RACEPrep(ops.race_hist(codes, W), CHUNK))
        rc_cpu = race.race_commit_chunk(
            rc_cpu, race.RACEPrep(ops.race_hist(codes.cpu(), W), CHUNK))
    bad = differing_leaves(sw_dev, sw_cpu) + [
        f"race.{f}" for f in differing_leaves(rc_dev, rc_cpu)]
    emit({"phase": "srp_kde_cross_check", "chunks": CROSS_CHUNKS,
          "srp_codes": CROSS_CHUNKS * CHUNK * L,
          "srp_flips_at_sign_boundaries": flips,
          "bit_identical": not bad, "differing": bad})
    if bad:
        fail(f"SRP SW-AKDE/RACE device/CPU state differs in {bad}")
    return dict(cfg=cfg, params=params, params_cpu=params_cpu, state=sw,
                race=rc, data=data, queries=queries, launches=launches)


# --------------------------------------------------------------------------
# phase 3c: the per-point oracles (Alg. 1 and Alg. 2 one at a time)
# --------------------------------------------------------------------------

def exact_d2(points, q, ids):
    """float64 squared distances of ``q`` to ``points[ids]`` (inf at -1)."""
    import torch
    d = ((points[ids.clamp(min=0).long()].double() - q.double()) ** 2).sum(-1)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def near_tie(a, b):
    import torch
    return (a == b) | ((a - b).abs() <= ATOL + RTOL * b.abs())


def phase_sann_oracles(sann_run, device):
    """`sann_query` / `sann_query_topk` against the batch engine's answers
    from phase `sann`; `sann_insert_stream` against `sann_insert_batch`."""
    import torch
    from repro_torch.core import prng, sann
    from repro_torch.kernels import ops
    cfg, params, state = sann_run["cfg"], sann_run["params"], sann_run["state"]
    qs = sann_run["queries"]
    cr = sann_run["c"] * sann_run["r"]

    sync(device)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = [sann.sann_query(state, params, q, cfg) for q in qs[:ORACLE_QUERIES]]
    sync(device)
    t_q = time.perf_counter() - t0
    t0 = time.perf_counter()
    tk = [sann.sann_query_topk(state, params, q, cfg, TOPK)
          for q in qs[:ORACLE_TOPK_QUERIES]]
    sync(device)
    t_tk = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if launches["cand_score"] != ORACLE_QUERIES + ORACLE_TOPK_QUERIES:
        fail(f"cand_score launches {launches['cand_score']}: expected one "
             f"per oracle query")

    batch = sann_run["results"][0]
    n = ORACLE_QUERIES
    index = torch.stack([r.index for r in res])
    dist = torch.stack([r.distance for r in res])
    found = torch.stack([r.found for r in res])
    ncand = torch.stack([r.n_candidates for r in res])
    b_found, b_dist, b_index = batch.found[:n], batch.distance[:n], batch.index[:n]
    edge = (b_dist - cr).abs() <= 1e-5 * cr
    if bool(((found != b_found) & ~edge).any()):
        fail("sann_query found differs from the batch engine away from c*r")
    both = found & b_found
    if not torch.allclose(dist[both], b_dist[both], rtol=RTOL, atol=0):
        fail("sann_query distances differ from the batch engine")
    mism = both & (index != b_index)
    for i in torch.nonzero(mism).flatten().tolist():
        a = exact_d2(state.points, qs[i], index[i:i + 1])
        b = exact_d2(state.points, qs[i], b_index[i:i + 1])
        if not bool(near_tie(a, b).all()):
            fail(f"sann_query id differs from the batch engine at query {i} "
                 f"without a near-tie")
    if not torch.equal(ncand, batch.n_candidates[:n]):
        fail("sann_query candidate counts differ from the batch engine")

    ids = torch.stack([t[0] for t in tk])
    dists = torch.stack([t[1] for t in tk])
    b_ids = sann_run["topk"][0][0][:ORACLE_TOPK_QUERIES]
    b_dists = sann_run["topk"][0][1][:ORACLE_TOPK_QUERIES]
    if not torch.equal(torch.isinf(dists), torch.isinf(b_dists)):
        fail("sann_query_topk padding differs from the batch engine")
    fin = torch.isfinite(b_dists)
    if not torch.allclose(dists[fin], b_dists[fin], rtol=RTOL, atol=ATOL):
        fail("sann_query_topk distances differ from the batch engine")
    tk_mism = ids != b_ids
    for i, j in torch.nonzero(tk_mism).tolist():
        a = exact_d2(state.points, qs[i], ids[i, j:j + 1])
        b = exact_d2(state.points, qs[i], b_ids[i, j:j + 1])
        if not bool(near_tie(a, b).all()):
            fail(f"sann_query_topk id differs at ({i}, {j}) without a near-tie")

    # sann_insert_stream over a stream prefix from a fresh sketch
    xs = sann_run["data"][:ORACLE_SANN_POINTS]
    key = prng.PRNGKey(7, device)
    t0 = time.perf_counter()
    st_stream = sann.sann_insert_stream(sann.sann_empty_state(cfg, device),
                                        params, xs, key, cfg)
    sync(device)
    t_stream = time.perf_counter() - t0
    st_batch = sann.sann_insert_batch(sann.sann_empty_state(cfg, device),
                                      params, xs, key, cfg)
    bad = differing_leaves(st_stream, st_batch)
    emit({"phase": "sann_oracles", "queries": ORACLE_QUERIES,
          "topk_queries": ORACLE_TOPK_QUERIES,
          "query_s": t_q, "queries_per_s": ORACLE_QUERIES / t_q,
          "topk_s": t_tk, "topk_queries_per_s": ORACLE_TOPK_QUERIES / t_tk,
          "found_rate": float(found.float().mean()),
          "found_differs_at_c_r_edge": int((found != b_found).sum()),
          "id_mismatches_at_near_ties": int(mism.sum()),
          "topk_id_mismatches_at_near_ties": int(tk_mism.sum()),
          "stream_points": ORACLE_SANN_POINTS, "stream_s": t_stream,
          "stream_points_per_s": ORACLE_SANN_POINTS / t_stream,
          "stream_n_stored": int(st_stream.n_stored),
          "stream_equals_batch": not bad, "differing": bad,
          "launches": {"cand_score": launches["cand_score"]},
          "stream_cut": {"queries": [ORACLE_QUERIES, SANN_QUERIES],
                         "topk_queries": [ORACLE_TOPK_QUERIES, SANN_QUERIES],
                         "stream_points": [ORACLE_SANN_POINTS, SANN_N]}})
    if bad:
        fail(f"sann_insert_stream differs from sann_insert_batch in {bad}")
    return launches


def phase_kde_oracles(srp_run, device):
    """Per-point SW-AKDE / RACE against the chunked paths, per-query KDE
    against the batch paths, swakde_merge and BatchSWAKDE against the CPU."""
    import torch
    from repro_torch.core import eh, lsh, race, swakde
    from repro_torch.kernels import ops
    cfg, params, data = srp_run["cfg"], srp_run["params"], srp_run["data"]
    L, W = cfg.L, cfg.W

    xs = data[:ORACLE_KDE_POINTS]
    sync(device)
    t0 = time.perf_counter()
    sw_pt = swakde.swakde_stream(swakde.swakde_init(cfg, device), params, xs, cfg)
    sync(device)
    t_sw = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc_pt = race.race_init(L, W, device)
    for x in xs:
        rc_pt = race.race_update(rc_pt, params, x)
    sync(device)
    t_rc = time.perf_counter() - t0
    sw_ch = swakde.swakde_init(cfg, device)
    rc_ch = race.race_init(L, W, device)
    for i in range(0, ORACLE_KDE_POINTS, CHUNK):
        sw_ch = swakde.swakde_update_chunk(sw_ch, params, xs[i:i + CHUNK], cfg)
        rc_ch = race.race_update_batch(rc_ch, params, xs[i:i + CHUNK])
    bad = differing_leaves(sw_pt, sw_ch) + [
        f"race.{f}" for f in differing_leaves(rc_pt, rc_ch)]
    if bad:
        fail(f"per-point SW-AKDE/RACE differ from the chunked paths in {bad}")

    # per-query estimates on the full SRP states against the batch paths
    sw, rc = srp_run["state"], srp_run["race"]
    qs = srp_run["queries"][:ORACLE_KDE_QUERIES]
    t0 = time.perf_counter()
    q_sw = torch.stack([swakde.swakde_query(sw, params, q, cfg) for q in qs])
    q_swk = torch.stack([swakde.swakde_kde(sw, params, q, cfg) for q in qs])
    q_rc = torch.stack([race.race_query(rc, params, q) for q in qs])
    q_rck = torch.stack([race.race_kde(rc, params, q) for q in qs])
    sync(device)
    t_q = time.perf_counter() - t0
    b_sw = swakde.swakde_query_batch(sw, params, qs, cfg)
    b_rc = race.race_query_batch(rc, params, qs)
    denom = torch.clamp(torch.clamp(sw.t, max=cfg.window).float(), min=1.0)
    checks = {"swakde_query": torch.equal(q_sw, b_sw),
              "swakde_kde": torch.equal(q_swk, b_sw / denom),
              "race_query": torch.equal(q_rc, b_rc),
              "race_kde": torch.equal(q_rck, b_rc / torch.clamp(rc.n.float(), min=1.0))}
    if not all(checks.values()):
        fail(f"per-query KDE differs from the batch path: {checks}")

    # swakde_merge over interleaved halves of a stream prefix
    pre = data[:MERGE_PREFIX]
    a = swakde.swakde_stream_batched(swakde.swakde_init(cfg, device), params,
                                     pre[0::2].contiguous(), cfg, chunk=CHUNK)
    b = swakde.swakde_stream_batched(swakde.swakde_init(cfg, device), params,
                                     pre[1::2].contiguous(), cfg, chunk=CHUNK)
    sync(device)
    t0 = time.perf_counter()
    m_ab = swakde.swakde_merge(a, b, cfg)
    sync(device)
    t_merge = time.perf_counter() - t0
    m_ba = swakde.swakde_merge(b, a, cfg)
    to_cpu = lambda st: type(st)(*(v.cpu() for v in st))
    m_cpu = swakde.swakde_merge(to_cpu(a), to_cpu(b), cfg)
    bad = [f"ab/ba.{f}" for f in differing_leaves(m_ab, m_ba)] + \
        [f"dev/cpu.{f}" for f in differing_leaves(m_ab, m_cpu)]
    if bad:
        fail(f"swakde_merge: {bad}")
    q48 = qs[:KDE_ERR_QUERIES]
    merged_vs_parts = float((swakde.swakde_query_batch(m_ab, params, q48, cfg)
                             - swakde.swakde_query_batch(a, params, q48, cfg)
                             - swakde.swakde_query_batch(b, params, q48, cfg)
                             ).abs().mean())

    # BatchSWAKDE (Corollary 4.2): device vs the CPU plain path, same codes
    bcfg = swakde.BatchSWAKDEConfig(L=L, W=W, window=BATCH_KDE_WINDOW,
                                    eh_eps=0.1, batch_size=CHUNK)
    seh = bcfg.eh_config()
    bst = swakde.batch_swakde_init(bcfg, device)
    cst = swakde.batch_swakde_init(bcfg, "cpu")
    t_batch = 0.0
    for i in range(BATCH_KDE_BATCHES):
        batch = data[i * CHUNK:(i + 1) * CHUNK]
        sync(device)
        t0 = time.perf_counter()
        bst = swakde.batch_swakde_update(bst, params, batch, bcfg)
        sync(device)
        t_batch += time.perf_counter() - t0
        codes = lsh.hash_points(params, batch).cpu()
        s = eh.sum_eh_add(eh.SumEHState(cst.ts, cst.num), cst.t,
                          ops.race_hist(codes, W), seh)
        cst = swakde.BatchSWAKDEState(s.ts, s.num, cst.t + 1)
    bad = differing_leaves(bst, cst)
    if bad:
        fail(f"BatchSWAKDE device/CPU state differs in {bad}")
    bq = torch.stack([swakde.batch_swakde_query(bst, params, q, bcfg)
                      for q in q48])
    if not torch.isfinite(bq).all() or not bool((bq > 0).all()):
        fail("BatchSWAKDE estimates must be finite and positive")

    emit({"phase": "kde_oracles", "dim": KDE_DIM, "L": L, "W": W,
          "stream_points": ORACLE_KDE_POINTS,
          "swakde_stream_s": t_sw,
          "swakde_stream_points_per_s": ORACLE_KDE_POINTS / t_sw,
          "race_update_s": t_rc,
          "race_update_points_per_s": ORACLE_KDE_POINTS / t_rc,
          "per_point_equals_chunked": True,
          "per_query_queries": ORACLE_KDE_QUERIES,
          "per_query_s_all_four": t_q, "per_query_equal_batch": checks,
          "merge_prefix": MERGE_PREFIX, "merge_s": t_merge,
          "merge_commutative_and_equals_cpu": True,
          "merge_mean_abs_gap_vs_sum_of_parts": merged_vs_parts,
          "batch_swakde_batches": BATCH_KDE_BATCHES,
          "batch_swakde_window": BATCH_KDE_WINDOW,
          "batch_swakde_eh_levels": seh.base.levels,
          "batch_swakde_update_ms": t_batch / BATCH_KDE_BATCHES * 1e3,
          "batch_swakde_equals_cpu": True,
          "batch_swakde_mean_estimate_48": float(bq.mean()),
          "stream_cut": {"stream_points": [ORACLE_KDE_POINTS, KDE_N],
                         "queries": [ORACLE_KDE_QUERIES, KDE_QUERIES],
                         "merge_prefix": [MERGE_PREFIX, KDE_N],
                         "batch_swakde_points": [BATCH_KDE_BATCHES * CHUNK, KDE_N]}})

# --------------------------------------------------------------------------
# phase 3d: sketch-gated LM decode (gemma3-4b), the sketch_decode_attn kernel
# --------------------------------------------------------------------------

def lm_config(n_layers=None, dtype="bfloat16"):
    """gemma3-4b at its published width (`configs/gemma3_4b.py`), in
    ``dtype``; ``n_layers`` cuts the depth (the cross-check only)."""
    import dataclasses
    from repro_torch.configs import registry
    cfg = dataclasses.replace(registry.get_config("gemma3-4b"), param_dtype=dtype)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def global_layers(cfg):
    from repro_torch.models import model
    return [i for i, w in enumerate(model.window_pattern(cfg)) if w <= 0]


def injected_lm_state(cfg, B, s_max, length, seed):
    """A decode cache at ``length`` as numpy arrays (the parity tests' state):
    random K/V below ``length``; block signatures random except block 0,
    which is sparse (8 bits) for request 0 and dense for the others, so
    request 0's global layers prune it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    L, Hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    kv = []
    for _ in range(2):
        x = np.zeros((L, B, s_max, Hkv, dh), np.float32)
        x[:, :, :length] = rng.normal(size=(L, B, length, Hkv, dh))
        kv.append(x)
    sigs = rng.random((L, B, s_max // LM_BLOCK, 64)) < 0.5
    sigs[:, 0, 0] = False
    for layer in range(L):
        sigs[layer, 0, 0, rng.choice(64, size=8, replace=False)] = True
    sigs[:, 1:, 0] = rng.random((L, B - 1, 64)) < 0.9
    return {"length": length, "k": kv[0], "v": kv[1], "block_sigs": sigs}


def live_sets(last_live):
    """[(block_ids, n_live), ...] of one step → per layer, per request, the
    set of live block ids."""
    out = []
    for ids, n in last_live:
        ids, n = ids.cpu(), n.cpu()
        out.append([set(ids[b, :int(n[b])].tolist()) for b in range(ids.shape[0])])
    return out


def phase_lm_cross_check(seed, device, n_layers=LM_CROSS_LAYERS, B=2,
                         s_max=1024, length=600, steps=8):
    """The first ``n_layers`` of gemma3-4b at full width in fp32 (TF32 off),
    on the card and on the CPU (plain versions) from one injected state:
    logits within 1e-4 of the largest, caches within 1e-5 of the largest,
    signature flips only at sign boundaries, live sets equal."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.models import model
    from repro_torch.serve import serve_step
    cfg = lm_config(n_layers, "float32")
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    params = model.init_model(cfg, gen, device)
    params_cpu = model.ParamTree(_tree_to(params.to_dict(), "cpu"))
    state = injected_lm_state(cfg, B, s_max, length, seed + 12)
    caches = {d: convert.lm_cache_from_numpy(state, d) for d in (device, "cpu")}
    steps_fn = {d: serve_step.make_serve_step(cfg, sketch=True)
                for d in (device, "cpu")}
    tokens = np.random.default_rng(seed + 13).integers(0, cfg.vocab, (B, steps))
    logit_err = 0.0
    live_equal, pruned = True, 0
    for t in range(steps):
        out = {}
        for d, p in ((device, params), ("cpu", params_cpu)):
            tok = torch.from_numpy(tokens[:, t:t + 1]).to(d)
            out[d], caches[d] = steps_fn[d](p, caches[d], tok)
        sync(device)
        ref_logits = out["cpu"]
        if not torch.isfinite(out[device]).all():
            fail("lm_cross_check: logits not finite on the card")
        logit_err = max(logit_err, float((out[device].cpu() - ref_logits).abs().max()
                                         / ref_logits.abs().max()))
        a, b = (live_sets(steps_fn[d].last_live) for d in (device, "cpu"))
        live_equal &= a == b
        in_range = -(-(length + t + 1) // LM_BLOCK)
        pruned += sum(len(s) < in_range for layer in b for s in layer)
    cache_err = {}
    for name in ("k", "v"):
        got, want = caches[device][name].cpu(), caches["cpu"][name]
        cache_err[name] = float((got - want).abs().max() / want.abs().max())
    # signature bits may differ only where a new key's projection is at the
    # sign boundary
    new_k = caches["cpu"]["k"][:, :, length:length + steps]
    L, _, T, Hkv, dh = new_k.shape
    mean = serve_step._head_mean(new_k.reshape(L * B, T, Hkv, dh)).reshape(L, B, T, dh)
    near = serve_step.sig_near_boundary(mean, serve_step._sig_proj(dh))
    near_blk = torch.zeros_like(caches["cpu"]["block_sigs"])
    for t in range(steps):
        near_blk[:, :, (length + t) // LM_BLOCK] |= near[:, :, t]
    diff = caches[device]["block_sigs"].cpu() != caches["cpu"]["block_sigs"]
    flips, unexplained = int(diff.sum()), int((diff & ~near_blk).sum())
    emit({"phase": "lm_cross_check", "arch": cfg.arch_id, "dtype": "float32",
          "layers": [n_layers, lm_config().n_layers], "d_model": cfg.d_model,
          "vocab": cfg.vocab, "B": B, "s_max": s_max, "start_length": length,
          "steps": steps, "global_layers": global_layers(cfg),
          "max_logit_err_rel": logit_err, "cache_err_rel": cache_err,
          "sig_flips": flips, "sig_flips_unexplained": unexplained,
          "live_sets_equal": live_equal, "pruned_layer_requests": pruned,
          "depth_cut": "the CPU copy of the fp32 weights: 7.6 GB at 6 layers "
                       "(one 5:1 local:global period), 18.2 GB at 34"})
    if logit_err > 1e-4 or max(cache_err.values()) > 1e-5:
        fail(f"lm_cross_check: card and CPU disagree ({logit_err}, {cache_err})")
    if unexplained or not live_equal:
        fail("lm_cross_check: signatures or live sets differ")
    if not pruned:
        fail("lm_cross_check: the injected state pruned nothing")
    del params, params_cpu, caches


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def phase_lm_serve(seed, device, cfg=None, B=LM_B, s_max=LM_S, prompt=LM_PROMPT,
                   gen_tokens=LM_GEN):
    """gemma3-4b at full width and depth in bf16 (random weights from the
    seed), sketch on: ``B`` requests, each a ``prompt``-token prompt fed one
    token a step, then ``gen_tokens`` greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.serve import kv_cache, serve_step
    cfg = cfg or lm_config()
    gen = torch.Generator(device=device).manual_seed(seed + 10)
    t0 = time.perf_counter()
    params = model.init_model(cfg, gen, device)
    sync(device)
    init_s = time.perf_counter() - t0
    cache = kv_cache.init_cache(cfg, B, s_max, sketch=True, device=device)
    step = serve_step.make_serve_step(cfg, sketch=True)
    prompts = torch.from_numpy(np.random.default_rng(seed + 14).integers(
        0, cfg.vocab, (B, prompt))).to(device)
    n_steps = prompt + gen_tokens
    times = []
    sync(device)
    ops.reset_launches()
    t_all = time.perf_counter()
    tok = prompts[:, :1]
    for t in range(n_steps):
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tok)
        tok = prompts[:, t + 1:t + 2] if t + 1 < prompt else logits.argmax(-1)
        sync(device)
        times.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    launches = dict(ops.LAUNCHES)
    glob = global_layers(cfg)
    if launches["sketch_decode_attn"] != len(glob) * n_steps:
        fail(f"sketch_decode_attn launches {launches['sketch_decode_attn']}: "
             f"expected {len(glob)} global layers x {n_steps} steps")
    if logits.shape != (B, 1, cfg.vocab) or not torch.isfinite(logits).all():
        fail("lm_serve: logits must be finite, one row per request")
    if cache["length"] != n_steps:
        fail("lm_serve: cache length")
    ms = sorted(x * 1e3 for x in times)
    live = {layer: [int(n) for n in nl.cpu()]
            for layer, (_, nl) in zip(glob, step.last_live)}
    emit({"phase": "lm_serve", "arch": cfg.arch_id, "dtype": cfg.param_dtype,
          "layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
          "global_layers": glob, "B": B, "s_max": s_max, "prompt_tokens": prompt,
          "generated_tokens": gen_tokens, "steps": n_steps,
          "init_s": init_s, "wall_s": wall, "tokens_per_s": B * n_steps / wall,
          "step_ms_median": ms[len(ms) // 2], "step_ms_p90": ms[int(0.9 * len(ms))],
          "weight_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
          "cache_bytes": kv_cache.cache_bytes(cache),
          "in_range_blocks_last_step": -(-n_steps // LM_BLOCK),
          "live_blocks_last_step": live,
          "launches": {"sketch_decode_attn": launches["sketch_decode_attn"]}})
    return dict(cfg=cfg, params=params, cache=cache, step=step, tok=tok,
                launches=launches)


def long_cache(cfg, device, length, s_max, seed):
    """A B = 1 cache at ``length`` whose keys cluster by block: each block's
    keys are a block-specific direction per KV head plus noise, so the block
    signatures are sparse; values are random.  The signatures are built with
    the port's own rule (the OR of `_sig_bits` of each key's head mean over
    its block), and for the last block of every global layer checked
    against replaying `_update_sigs` token by token."""
    import torch
    from repro_torch.serve import kv_cache, serve_step
    dt = torch.bfloat16
    cache = kv_cache.init_cache(cfg, 1, s_max, sketch=True, device=device)
    cache["length"] = length
    gen = torch.Generator(device=device).manual_seed(seed)
    Hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    nb = s_max // LM_BLOCK
    proj = serve_step._sig_proj(dh, device)
    pos_ok = (torch.arange(s_max, device=device) < length).reshape(nb, LM_BLOCK, 1)
    replay_ok = True
    last = (length - 1) // LM_BLOCK
    glob = set(global_layers(cfg))
    for layer in range(cfg.n_layers):
        dirs = torch.randn((nb, 1, Hkv, dh), generator=gen, device=device)
        noise = torch.randn((nb, LM_BLOCK, Hkv, dh), generator=gen, device=device)
        k = (dirs + 0.1 * noise).reshape(1, s_max, Hkv, dh)
        k[:, length:] = 0
        cache["k"][layer] = k.to(dt)
        v = torch.randn((1, s_max, Hkv, dh), generator=gen, device=device)
        v[:, length:] = 0
        cache["v"][layer] = v.to(dt)
        kl = cache["k"][layer]                                 # (1, S, Hkv, dh)
        bits = serve_step._sig_bits(serve_step._head_mean(kl)[0], proj)  # (S, 64)
        sigs = (bits.reshape(nb, LM_BLOCK, 64) & pos_ok).any(1)
        cache["block_sigs"][layer, 0] = sigs
        if layer in glob:
            replay = torch.zeros((1, nb, 64), dtype=torch.bool, device=device)
            for p in range(last * LM_BLOCK, length):
                serve_step._update_sigs(replay, kl[:, p:p + 1], p)
            replay_ok &= torch.equal(replay[0, last], sigs[last])
    if not replay_ok:
        fail("lm_long: block signatures differ from replaying _update_sigs")
    return cache


def phase_lm_long(seed, serve_run, device, s_max=LM_LONG_S,
                  length=LM_LONG_LEN, steps=LM_LONG_STEPS):
    """The same model at B = 1 over a 131 072-token cache whose block
    signatures are sparse: 8 decode steps from length 131 000."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import kv_cache, serve_step
    cfg, params = serve_run["cfg"], serve_run["params"]
    t0 = time.perf_counter()
    cache = long_cache(cfg, device, length, s_max, seed + 15)
    sync(device)
    build_s = time.perf_counter() - t0
    step = serve_step.make_serve_step(cfg, sketch=True)
    tokens = torch.from_numpy(np.random.default_rng(seed + 16).integers(
        0, cfg.vocab, (1, steps))).to(device)
    glob = global_layers(cfg)
    frac = {layer: [] for layer in glob}
    times = []
    ops.reset_launches()
    for t in range(steps):
        sync(device)
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tokens[:, t:t + 1])
        sync(device)
        times.append(time.perf_counter() - t0)
        in_range = -(-(length + t + 1) // LM_BLOCK)
        for layer, (_, n) in zip(glob, step.last_live):
            frac[layer].append(int(n[0]) / in_range)
    launches = ops.LAUNCHES["sketch_decode_attn"]
    if launches != len(glob) * steps:
        fail(f"lm_long: sketch_decode_attn launched {launches} times")
    if not torch.isfinite(logits).all():
        fail("lm_long: logits not finite")
    mean_frac = float(np.mean([f for fs in frac.values() for f in fs]))
    if not mean_frac < 1.0:
        fail("lm_long: the sparse-signature state pruned no block")
    ms = sorted(x * 1e3 for x in times)
    emit({"phase": "lm_long", "arch": cfg.arch_id, "dtype": cfg.param_dtype,
          "B": 1, "s_max": s_max, "start_length": length, "steps": steps,
          "cache_build_s": build_s, "cache_bytes": kv_cache.cache_bytes(cache),
          "step_ms_median": ms[len(ms) // 2], "step_ms_max": ms[-1],
          "live_fraction_per_global_layer": {k: float(np.mean(v))
                                             for k, v in frac.items()},
          "live_fraction_mean": mean_frac,
          "launches": {"sketch_decode_attn": launches}})


# --------------------------------------------------------------------------
# phase 4: every kernel against its plain version, timed
# --------------------------------------------------------------------------

def kernels_per_call(fn, device) -> int:
    """Device operations (kernel, memset and copy nodes) that one call of
    ``fn()`` puts on the stream: one call captured into a CUDA graph that
    is kept, and its nodes counted with ``cuGraphGetNodes`` (libcuda).
    The profiler cannot serve here: late in a long run it drops the device
    events of short windows."""
    import ctypes
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                         # first use (workspaces) outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    sync(device)
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    del graph
    if err:
        fail(f"cuGraphGetNodes failed: CUresult {err}")
    return n.value


def check_race_hist(kde, device):
    """`race_hist` on one ingest chunk's codes: bit-equal to its plain
    version, one launch a call and no other device op (no fill: the kernel
    stores every bin)."""
    import torch
    from repro_torch.core import lsh
    from repro_torch.kernels import ops, race_update, ref
    W = kde["cfg"].W
    codes = lsh.hash_points(kde["params"], kde["data"][:CHUNK]).contiguous()
    B, L = codes.shape
    torch.full((L, W), -7, dtype=torch.int32, device=device)   # stale memory
    ops.reset_launches()
    got = race_update.race_hist(codes, W)
    entry_launches = ops.LAUNCHES["race_hist"]
    want = ref.race_hist_ref(codes, W)
    err = int((got - want).abs().max())
    if err != 0:
        fail("race_hist differs from its plain version")
    per_call = kernels_per_call(lambda: race_update.race_hist(codes, W), device)
    if entry_launches != 1 or per_call != 1:
        fail(f"race_hist: {entry_launches} launches and {per_call} device ops "
             f"a call, expected 1 and 1")
    flat = (codes.long() + torch.arange(L, device=device) * W).reshape(-1)
    b_ms, b_by = bound(B * L * 4 + L * W * 4)
    return {"name": "race_hist", "shape": [B, L, W], "max_abs_err": err,
            "launches_per_call": entry_launches,
            "device_ops_per_call": per_call,
            "ms": time_ms(lambda: race_update.race_hist(codes, W), 50, device),
            "device_ms": device_ms(lambda: race_update.race_hist(codes, W),
                                   "race_hist", device),
            "graph_ms": graph_ms(lambda: race_update.race_hist(codes, W), device),
            "plain_ms": time_ms(lambda: ref.race_hist_ref(codes, W), 20, device),
            "library_ms": time_ms(lambda: torch.bincount(
                flat, minlength=L * W).view(L, W), 50, device),
            "bound_ms": b_ms, "bound_by": b_by,
            "library": "torch.bincount"}


def check_sann_table_scatter(sann_run, device):
    """The in-place ring append (`ingest_commit.sann_table_scatter`) and the
    commit's table update (`ingest_commit.sann_table_commit`: the tombstone
    copy, then the append), each bit-equal to its plain version on a chunk
    of queries prepared against the ingested SIFT1M-shaped state; the commit
    also with its ring interval wrapping past capacity and with n_kept past
    capacity.  Returns the append's row and the commit's (the main path's
    entry), timed beside the plain PyTorch sequence the commit replaced."""
    import torch
    from repro_torch.core import sann
    from repro_torch.kernels import ingest_commit, ref
    cfg, params, state = sann_run["cfg"], sann_run["params"], sann_run["state"]
    prep = sann.sann_prepare_chunk(params, sann_run["queries"][:CHUNK],
                                   sann_run["key"], cfg)
    slot = (state.write_ptr + prep.kept_rank) % cfg.capacity
    s_b = prep.s_b.long()
    val = torch.where(prep.winner[s_b], slot[s_b], -1).to(torch.int32)
    args = (state.table_ptr, prep.s_l, prep.s_c, prep.rank, val, prep.entry_win)
    got = ingest_commit.sann_table_scatter(state.tables.clone(), *args)
    want = ref.sann_table_scatter_ref(state.tables.clone(), *args)
    err = int((got - want).abs().max())
    if err != 0:
        fail("sann_table_scatter differs from its plain version")
    L, NB, cap = state.tables.shape
    m = prep.entry_win
    s_l, s_c = prep.s_l[m].long(), prep.s_c[m].long()
    ring = (state.table_ptr[s_l, s_c].long() + prep.rank[m].long()) % cap
    flat = (s_l * NB + s_c) * cap + ring
    vals = val[m]
    E, n_masked = prep.s_l.shape[0], int(m.sum())
    tab_k, tab_r, tab_l = (state.tables.clone() for _ in range(3))
    b_ms, b_by = bound(E * 17 + n_masked * 8)
    scatter = {
        "name": "sann_table_scatter", "entry": "sann_table_scatter",
        "shape": [L, NB, cap, E], "masked": n_masked, "max_abs_err": err,
        "ms": time_ms(lambda: ingest_commit.sann_table_scatter(tab_k, *args),
                      50, device),
        "device_ms": device_ms(lambda: ingest_commit.sann_table_scatter(
            tab_k, *args), "sann_table_scatter", device),
        "graph_ms": graph_ms(lambda: ingest_commit.sann_table_scatter(
            tab_k, *args), device),
        "plain_ms": time_ms(lambda: ref.sann_table_scatter_ref(tab_r, *args),
                            20, device),
        "library_ms": time_ms(lambda: tab_l.view(-1).index_put_(
            (flat,), vals), 50, device),
        "bound_ms": b_ms, "bound_by": b_by, "library": "Tensor.index_put_"}
    del tab_k, tab_r, tab_l

    C = cfg.capacity
    tables = state.tables
    before = tables.clone()
    wp, nk = state.write_ptr, prep.n_kept
    n_kept = int(nk)
    i32 = dict(dtype=torch.int32, device=device)
    cases = {"main": (wp, nk),
             "wrap": (torch.tensor(C - max(n_kept // 2, 1), **i32), nk),
             "n_kept_past_capacity": (wp, torch.tensor(C + 5, **i32))}
    for name, (w, n) in cases.items():
        got = ingest_commit.sann_table_commit(tables, *args, w, n, C)
        want = ref.sann_table_commit_ref(tables, *args, w, n, C)
        if not torch.equal(got, want):
            fail(f"sann_table_commit differs from its plain version ({name})")
    if not torch.equal(tables, before):
        fail("sann_table_commit modified its input tables")
    del got, want, before

    def pytorch_sequence():
        # the table update before the fused entry: a masked tombstone pass
        # over the whole table, then the append
        ring_off = (torch.arange(C, **i32) - wp) % C
        overwritten = ring_off < nk
        stale = (tables >= 0) & overwritten[tables.clamp(min=0).long()]
        out = torch.where(stale, -1, tables)
        out.view(-1).index_put_((flat,), vals)
        return out

    if not torch.equal(pytorch_sequence(), ingest_commit.sann_table_commit(
            tables, *args, wp, nk, C)):
        fail("sann_table_commit differs from the PyTorch sequence")
    commit = lambda: ingest_commit.sann_table_commit(tables, *args, wp, nk, C)
    b_ms, b_by = bound(2 * tables.numel() * 4 + E * 17 + n_masked * 4 + 8)
    return [scatter, {
        "name": "sann_table_scatter", "entry": "sann_table_commit",
        "shape": [L, NB, cap, E], "masked": n_masked, "n_kept": n_kept,
        "capacity": C, "cases": list(cases), "max_abs_err": 0,
        "table_bytes": tables.numel() * 4,
        "ms": time_ms(commit, 20, device),
        "device_ms": device_ms(commit, "sann_table_scatter", device),
        "graph_ms": graph_ms(commit, device, 5),
        "plain_ms": time_ms(lambda: ref.sann_table_commit_ref(
            tables, *args, wp, nk, C), 5, device),
        "library_ms": time_ms(pytorch_sequence, 20, device),
        "library_device_ms": device_ms_all(pytorch_sequence, device),
        "library": "PyTorch sequence: (tables >= 0) & overwritten[tables."
                   "clamp(min=0).long()], torch.where, Tensor.index_put_",
        "bound_ms": b_ms, "bound_by": b_by}]


def topk_err(d_k, i_k, d_r, i_r, full_d2):
    """Max |d2 difference| (rtol 1e-5, atol 1e-6 enforced, masked entries
    inf in both) and the count of id mismatches, each of which must be a
    near-tie: the two candidates' plain-version d2 within that tolerance."""
    import torch
    if not torch.equal(torch.isinf(d_k), torch.isinf(d_r)):
        fail("batch_score_topk masked entries differ")
    fin = torch.isfinite(d_r)
    diff = (d_k[fin] - d_r[fin]).abs()
    if (diff > 1e-6 + 1e-5 * d_r[fin].abs()).any():
        fail("batch_score_topk d2 outside tolerance")
    mism = i_k != i_r
    a = torch.gather(full_d2, 1, i_k.long())[mism]
    b = torch.gather(full_d2, 1, i_r.long())[mism]
    near = (torch.isinf(a) & torch.isinf(b)) | ((a - b).abs() <= 1e-6 + 1e-5 * b.abs())
    if not near.all():
        fail("batch_score_topk ids differ away from a near-tie")
    return (float(diff.max()) if diff.numel() else 0.0), int(mism.sum())


def check_batch_score_topk(sann_run, device):
    """Both entries at the S-ANN query path's two shapes, on a block of
    2048 real queries against the ingested SIFT1M-shaped state: the (c, r)
    path's first 3L valid candidates (k = 1) and the top-50 path's
    deduplicated bucket union.  The gather entry (the main path's) is timed
    beside the path it replaced (the ``points[cand]`` gather + the
    ``(B, M, d)`` entry, by graph); its bound counts qs, the slot ids, the
    mask, each distinct point row a live entry names, and the outputs."""
    import torch
    from repro_torch.core import sann
    from repro_torch.kernels import batch_score, ref
    cfg, params, state = sann_run["cfg"], sann_run["params"], sann_run["state"]
    points = state.points
    qs = sann_run["queries"][:QUERY_BLOCK].contiguous()
    cand, ok = sann.sann_bucket_candidates_batch(state, params, qs, cfg)
    rows = []
    # (c, r) path: the first 3L valid candidates, k = 1
    budget = 3 * cfg.L
    csum = torch.cumsum(ok, dim=1).to(torch.int32)
    targets = torch.arange(1, budget + 1, dtype=torch.int32, device=device)
    sel = torch.searchsorted(csum, targets.expand(qs.shape[0], budget).contiguous())
    sel_ok = sel < cand.shape[1]
    sel_cand = torch.where(sel_ok, torch.gather(cand, 1, sel.clamp(
        max=cand.shape[1] - 1)), -1)
    # top-k path: the deduplicated bucket union, k = 50
    mask = ok & sann._first_occurrence_mask(cand, cfg.capacity)
    for ids, okm, k in ((sel_cand, sel_ok, 1), (cand, mask, TOPK)):
        B, M = ids.shape
        d = points.shape[1]
        vecs = points[ids.clamp(min=0).long()]
        full = torch.where(okm, ref.batch_score_ref(qs, vecs), float("inf"))
        d_r, i_r = ref.batch_score_topk_ref(qs, vecs, okm, k)
        d_g, i_g = batch_score.batch_score_topk_gather(qs, points, ids, okm, k)
        err_g, mism_g = topk_err(d_g, i_g, d_r, i_r, full)
        d_k, i_k = batch_score.batch_score_topk(qs, vecs, okm, k)
        err, mism = topk_err(d_k, i_k, d_r, i_r, full)
        if not (torch.equal(d_k, d_g) and torch.equal(i_k, i_g)):
            fail("batch_score_topk: the gather entry and the (B, M, d) entry "
                 "differ on the same rows")
        live = int(okm.sum())
        distinct = int(torch.unique(ids[okm]).numel())
        ops_n = 3.0 * live * d
        b_ms, b_by = bound(B * d * 4 + B * M * 4 + B * M + distinct * d * 4
                           + B * k * 8, ops_n)
        gather = lambda: batch_score.batch_score_topk_gather(qs, points, ids,
                                                             okm, k)
        old = lambda: batch_score.batch_score_topk(
            qs, points[ids.clamp(min=0).long()], okm, k)
        rows.append({
            "name": "batch_score_topk", "entry": "batch_score_topk_gather",
            "shape": [B, M, d, k], "live_entries": live,
            "distinct_rows": distinct, "max_abs_err": err_g,
            "id_mismatches_at_near_ties": mism_g,
            "ms": time_ms(gather, 50, device),
            "device_ms": device_ms(gather, "batch_score_topk", device),
            "graph_ms": graph_ms(gather, device),
            "plain_ms": time_ms(lambda: ref.batch_score_topk_gather_ref(
                qs, points, ids, okm, k), 10, device),
            "old_path_ms": time_ms(old, 20, device),
            "old_path_graph_ms": graph_ms(old, device),
            "library_ms": None, "library": "none (no single call)",
            "bound_ms": b_ms, "bound_by": b_by})
        # the reference kernel's own (B, M, d) signature on the same body;
        # its bound reads the whole (B, M, d) tensor's live rows
        b_ms, b_by = bound(B * d * 4 + live * d * 4 + B * M + B * k * 8, ops_n)
        rows.append({
            "name": "batch_score_topk", "entry": "batch_score_topk",
            "shape": [B, M, d, k], "max_abs_err": err,
            "id_mismatches_at_near_ties": mism,
            "ms": time_ms(lambda: batch_score.batch_score_topk(qs, vecs, okm, k),
                          50, device),
            "device_ms": device_ms(lambda: batch_score.batch_score_topk(
                qs, vecs, okm, k), "batch_score_topk", device),
            "graph_ms": graph_ms(lambda: batch_score.batch_score_topk(
                qs, vecs, okm, k), device),
            "plain_ms": time_ms(lambda: ref.batch_score_topk_ref(qs, vecs, okm, k),
                                10, device),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
        del vecs, full
    return rows


def check_swakde_segment_pass(kde, device):
    """One chunk on the state at the end of the stream (stamps cross the
    window, so passes split at expiry): the one-pass entry bit-exact at
    every pass of the plain loop, and the drained commit (the main path's
    entry, one launch) bit-exact against the plain pass loop with its
    write-back.  Times are per committed chunk; the per-pass entry's are
    kept beside them."""
    import torch
    from repro_torch.core import lsh, swakde
    from repro_torch.core.util import saturating_add
    from repro_torch.kernels import ingest_commit, ref
    cfg, state = kde["cfg"], kde["state"]
    eh = cfg.eh_config()
    codes = lsh.hash_points(kde["params"], kde["data"][:CHUNK])
    prep = swakde.swakde_prepare_from_codes(codes, cfg)
    sorted_ts = saturating_add(state.t, prep.order)
    gcode = prep.seg_code.clamp(max=cfg.W - 1).long()
    rows = torch.arange(cfg.L, device=device)[:, None]
    carry = (state.ts[rows, gcode].contiguous(), state.num[rows, gcode].contiguous(),
             torch.zeros_like(prep.seg_len))
    fixed = (sorted_ts, prep.seg_first, prep.seg_len)
    kw = dict(window=cfg.window, maxb=eh.max_buckets_per_level,
              n_levels=eh.levels, cap=cfg.heavy_cell_cap)
    first = carry
    passes = err = 0
    while bool((carry[2] < prep.seg_len).any()):
        got = ingest_commit.swakde_segment_pass(*carry, *fixed, **kw)
        want = ref.swakde_segment_pass_ref(*carry, *fixed, **kw)
        err = max([err] + [int((a.long() - b.long()).abs().max())
                           for a, b in zip(got, want)])
        if err:
            fail(f"swakde_segment_pass differs from its plain version "
                 f"at pass {passes}")
        carry = got
        passes += 1
    # the drained commit against the plain loop (and its write-back)
    args = (state.ts, state.num, sorted_ts, prep.seg_code, prep.seg_first,
            prep.seg_len)
    got = ingest_commit.swakde_segment_commit(*args, **kw)
    want = ref.swakde_segment_commit_ref(*args, **kw)
    drain_err = max(int((a.long() - b.long()).abs().max())
                    for a, b in zip(got, want))
    real = prep.seg_code < cfg.W
    if drain_err or not torch.equal(
            want[0][rows.expand_as(real)[real], prep.seg_code[real].long()],
            carry[0][real]):
        fail("the drained swakde_segment_commit differs from the plain pass loop")
    L, W, LV, S = state.ts.shape
    C = sorted_ts.shape[1]
    G = prep.seg_code.shape[1]
    # the commit reads the grid, the stamps and the segments once and
    # writes a new grid once
    grid = L * W * (LV * S + LV) * 4
    b_ms, b_by = bound(2 * grid + L * C * 4 + 3 * L * G * 4)
    R, G_, LV_, S_ = first[0].shape
    consumed = int((ingest_commit.swakde_segment_pass(*first, *fixed, **kw)[2]
                    - first[2]).sum())
    active = int((first[2] < prep.seg_len).sum())
    ring = R * G_ * LV_ * S_ * 4 + R * G_ * LV_ * 4
    pass_b_ms, _ = bound(2 * ring + 4 * R * G_ * 4 + (consumed + active) * 4)

    def commit():
        return ingest_commit.swakde_segment_commit(*args, **kw)

    return {"name": "swakde_segment_pass", "entry": "swakde_segment_commit",
            "shape": [L, W, LV, S, C], "segments": int(real.sum()),
            "passes_to_drain": passes, "max_abs_err": max(err, drain_err),
            "ms": time_ms(commit, 50, device),
            "device_ms": device_ms_all(commit, device),
            "kernel_device_ms": device_ms(commit, "swakde_segment_pass", device),
            "graph_ms": graph_ms(commit, device),
            "plain_ms": time_ms(lambda: ref.swakde_segment_commit_ref(*args, **kw),
                                5, device, warmup=1),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "pass_ms": time_ms(lambda: ingest_commit.swakde_segment_pass(
                *first, *fixed, **kw), 50, device),
            "pass_device_ms": device_ms(lambda: ingest_commit.swakde_segment_pass(
                *first, *fixed, **kw), "swakde_segment_pass", device),
            "pass_graph_ms": graph_ms(lambda: ingest_commit.swakde_segment_pass(
                *first, *fixed, **kw), device),
            "pass_bound_ms": pass_b_ms}


def _real_segments(prep, W):
    """``prep`` cut to the segments that hit a cell: segments are in code
    order, so the sentinel ones (code W) form the tail of every row."""
    g = max(int((prep.seg_code < W).sum(1).max()), 1)
    return prep._replace(**{f: getattr(prep, f)[:, :g].contiguous()
                            for f in ("seg_code", "seg_first", "seg_len")})


def check_swakde_many_slots(kde, device, eps, warm, cross, cpu_rows=None):
    """The drained SW-AKDE commit past 32 EH slots at full width (L = W =
    96, window 65 536, the news-like stream's p-stable codes): eps 0.01
    (52 slots, the cell in shared memory) and eps 1e-4 (5002 slots, a
    422 160-byte cell, past the 227 KB a block may use: the cell in global
    memory).  ``warm`` chunks on the card fill the window; ``cross`` more,
    whose stamps expire inside them, run on the card and on the CPU plain
    path from the same state and codes and must give bit-identical state
    after each: every row, or with ``cpu_rows`` the first ``cpu_rows`` rows
    (the CPU's plain pass loop at 5002 slots takes seconds a row and a
    chunk).  The last commit is timed."""
    import dataclasses
    import torch
    from repro_torch.core import lsh, swakde
    from repro_torch.core.util import saturating_add
    from repro_torch.kernels import ingest_commit, ops, ref
    base = kde["cfg"]
    cfg = swakde.SWAKDEConfig(L=base.L, W=base.W, window=base.window,
                              eh_eps=eps)
    eh = cfg.eh_config()
    params, data = kde["params"], kde["data"]
    rows = cfg.L if cpu_rows is None else cpu_rows
    cfg_rows = dataclasses.replace(cfg, L=rows)

    def codes(i):
        return lsh.hash_points(params, data[i * CHUNK:(i + 1) * CHUNK])

    st = swakde.swakde_init(cfg, device)
    ops.reset_launches()
    for i in range(warm):
        st = swakde.swakde_commit_chunk(
            st, swakde.swakde_prepare_from_codes(codes(i), cfg), cfg)
    launches = ops.LAUNCHES["swakde_segment_pass"]
    if launches != warm:
        fail(f"the {eh.slots}-slot commit launched {launches} times in "
             f"{warm} chunks")
    st_cpu = swakde.SWAKDEState(st.ts[:rows].cpu(), st.num[:rows].cpu(),
                                st.t.cpu())
    t0 = time.perf_counter()
    for i in range(warm, warm + cross):
        c = codes(i)
        prep = swakde.swakde_prepare_from_codes(c, cfg)
        last = (st, prep)
        st = swakde.swakde_commit_chunk(st, prep, cfg)
        st_cpu = swakde.swakde_commit_chunk(st_cpu, _real_segments(
            swakde.swakde_prepare_from_codes(c[:, :rows].cpu(), cfg_rows),
            cfg.W), cfg_rows)
        bad = differing_leaves(
            swakde.SWAKDEState(st.ts[:rows], st.num[:rows], st.t), st_cpu)
        if bad:
            fail(f"the {eh.slots}-slot SW-AKDE commit differs from the CPU "
                 f"plain path in {bad} at chunk {i}")
    cross_s = time.perf_counter() - t0
    state, prep = last
    args = (state.ts, state.num, saturating_add(state.t, prep.order),
            prep.seg_code, prep.seg_first, prep.seg_len)
    real = _real_segments(prep, cfg.W)
    plain_args = args[:3] + (real.seg_code, real.seg_first, real.seg_len)
    kw = dict(window=cfg.window, maxb=eh.max_buckets_per_level,
              n_levels=eh.levels, cap=cfg.heavy_cell_cap)
    L, W, LV, S = state.ts.shape
    C, G = args[2].shape[1], prep.seg_code.shape[1]
    grid = L * W * (LV * S + LV) * 4
    b_ms, b_by = bound(2 * grid + L * C * 4 + 3 * L * G * 4)
    form = ingest_commit.swakde_cell_form(LV, S)

    def commit():
        return ingest_commit.swakde_segment_commit(*args, **kw)

    # the global form allocates a scratch slice per (row, segment) a call:
    # 20 graph-captured calls would hold 20 of them, so time it by events
    big = form == "global"
    row = {"name": "swakde_segment_pass", "entry": "swakde_segment_commit",
           "eh_eps": eps, "eh_slots": S, "cell_form": form,
           "shape": [L, W, LV, S, C],
           "segments": int((prep.seg_code < W).sum()),
           "chunks_on_card": warm + cross,
           "chunks_bit_identical_to_cpu": cross,
           "cpu_rows": f"0-{rows - 1}", "cpu_cross_check_s": cross_s,
           "max_buckets_in_a_level": int(st.num.max()),
           "cell_bytes_a_warp": ingest_commit.swakde_cell_bytes(LV, S),
           "max_abs_err": 0,
           "ms": time_ms(commit, 3 if big else 20, device,
                         warmup=1 if big else 2),
           "device_ms": None if big else device_ms_all(commit, device),
           "kernel_device_ms": device_ms(commit, "swakde_segment_pass", device,
                                         iters=3 if big else 20),
           "graph_ms": None if big else graph_ms(commit, device),
           # the plain pass loop over the segments that hit a cell (the
           # sentinels are dropped either way), on the card
           "plain_ms": time_ms(lambda: ref.swakde_segment_commit_ref(
               *plain_args, **kw), 1 if big else 2, device, warmup=1),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del st, state, last, args, plain_args
    torch.cuda.empty_cache()
    return row


def check_cand_score(sann_run, device):
    """`cand_score` at the oracles' two shapes, on a real query's
    candidates: the first 3L valid ones (M = 36) and the bucket union
    (M = L * bucket_cap = 384)."""
    import torch
    from repro_torch.core import sann
    from repro_torch.kernels import cand_score, ref
    cfg, params, state = sann_run["cfg"], sann_run["params"], sann_run["state"]
    q = sann_run["queries"][0].contiguous()
    cand, ok = sann.sann_bucket_candidates(state, params, q, cfg)
    sel = torch.sort((~ok).to(torch.int32), stable=True).indices[:3 * cfg.L]
    rows = []
    for c in (cand[sel], cand):
        vecs = state.points[c.clamp(min=0).long()].contiguous()
        M, d = vecs.shape
        got = cand_score.cand_score(q, vecs)
        want = ref.cand_score_ref(q, vecs)
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail("cand_score differs from its plain version")
        b_ms, b_by = bound(M * d * 4 + d * 4 + M * 4, 3.0 * M * d)
        rows.append({
            "name": "cand_score", "shape": [M, d], "max_abs_err": err,
            "ms": time_ms(lambda: cand_score.cand_score(q, vecs), 200, device),
            "device_ms": device_ms(lambda: cand_score.cand_score(q, vecs),
                                   "cand_score", device),
            "graph_ms": graph_ms(lambda: cand_score.cand_score(q, vecs), device),
            "plain_ms": time_ms(lambda: ref.cand_score_ref(q, vecs), 200, device),
            "library_ms": None, "library": "none (no single call)",
            "bound_ms": b_ms, "bound_by": b_by})
    return rows


def check_srp_hash(srp_run, device):
    """`srp_hash` on one ingest chunk of the SRP stream, (4096, 384) x
    (384, 192): codes against the plain version under the flip rule."""
    import torch
    from repro_torch.kernels import ref, srp_hash
    params = srp_run["params"]
    x = srp_run["data"][:CHUNK].contiguous()
    proj, mix, nb = params.proj, params.mix, params.n_buckets
    got = srp_hash.srp_hash(x, proj, mix, nb)
    want = ref.srp_hash_ref(x, proj, mix, nb)
    flips = srp_flips(x, params, got, want)
    # a flipped sign bit moves the code anywhere in [0, n_buckets)
    err = int((got.long() - want.long()).abs().max())
    B, d = x.shape
    LK = proj.shape[1]
    nbytes = B * d * 4 + d * LK * 4 + mix.numel() * 8 + B * params.L * 4
    b_ms, b_by = bound(nbytes, 2.0 * B * d * LK)
    # the kernel's own work: three TF32 products (3xTF32) on the tensor cores
    tc_ms = max(3 * 2.0 * B * d * LK / PEAK_TF32_PER_S,
                nbytes / PEAK_BYTES_PER_S) * 1e3
    return {"name": "srp_hash", "shape": [B, d, LK], "max_abs_err": err,
            "flips_at_sign_boundaries": flips, "codes": B * params.L,
            "ms": time_ms(lambda: srp_hash.srp_hash(x, proj, mix, nb), 100, device),
            "device_ms": device_ms(lambda: srp_hash.srp_hash(x, proj, mix, nb),
                                   "srp_hash", device),
            "graph_ms": graph_ms(lambda: srp_hash.srp_hash(x, proj, mix, nb), device),
            "plain_ms": time_ms(lambda: ref.srp_hash_ref(x, proj, mix, nb), 50,
                                device),
            "library_ms": None, "library": "none (no single call)",
            "matmul_only_ms": time_ms(lambda: x @ proj, 100, device),
            "matmul_only_device_ms": device_ms_all(lambda: x @ proj, device),
            "matmul_only_graph_ms": graph_ms(lambda: x @ proj, device),
            "bound_ms": b_ms, "bound_by": b_by, "tensor_core_bound_ms": tc_ms}


def check_sketch_decode_attn(serve_run, device):
    """The kernel against its plain version on the card, within
    SDA_ATOL + SDA_RTOL * |plain| (fp32 sums in another order: the tile
    and split order against one softmax over the whole row): at the main
    path's shape (lm_serve's last step: B = 4, S = 4096, its live lists and
    kv_len, a random q) and at B = 1, S = 131 072 (gemma3-4b's 128k context)
    with 100 %, 50 % and 10 % of the blocks live, softcap 0 and 50, and
    with no live block (zeros)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, sketch_decode_attn as sda
    cfg = serve_run["cfg"]
    Hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_heads // Hkv
    gen = torch.Generator(device=device).manual_seed(17)
    layer = global_layers(cfg)[-1]
    cache = serve_run["cache"]
    ids, n_live = serve_run["step"].last_live[-1]
    cases = [("lm_serve", cache["k"][layer], cache["v"][layer], ids, n_live,
              cache["length"], 0.0)]
    S, kv_len = LM_LONG_S, LM_LONG_LEN
    k = torch.randn((1, S, Hkv, dh), generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn((1, S, Hkv, dh), generator=gen, device=device).to(torch.bfloat16)
    nb = S // LM_BLOCK
    for frac in (1.0, 0.5, 0.1, 0.0):
        live = torch.rand((1, nb), generator=gen, device=device) < frac
        ids, n_live = sda.compact_live(live)
        for softcap in ((0.0, 50.0) if frac else (0.0,)):
            cases.append((f"long_{frac}", k, v, ids, n_live, kv_len, softcap))
    rows = []
    for name, k, v, ids, n_live, kv_len, softcap in cases:
        B, S = k.shape[:2]
        q = torch.randn((B, Hkv, G, dh), generator=gen, device=device).to(k.dtype)
        live = sda.block_mask(ids, n_live, S // LM_BLOCK)
        got = sda.sketch_decode_attn(q, k, v, ids, n_live, kv_len, LM_BLOCK, softcap)
        want = ref.sketch_decode_attn_ref(q, k, v, live, kv_len, LM_BLOCK, softcap)
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=SDA_RTOL, atol=SDA_ATOL):
            fail(f"sketch_decode_attn differs from its plain version ({name})")
        if not bool(live.any()) and bool(got.any()):
            fail("sketch_decode_attn: an empty live list must give zeros")
        pos = torch.arange(S, device=device)
        pos_live = live[:, pos // LM_BLOCK] & (pos < kv_len)[None]     # (B, S)
        n_pos = int(pos_live.sum())
        nbytes = (n_pos * Hkv * dh * 2 * k.element_size() + q.numel() * q.element_size()
                  + got.numel() * 4 + ids.numel() * 4 + n_live.numel() * 4)
        b_ms, b_by = bound(nbytes, 4.0 * n_pos * Hkv * G * dh)
        call = lambda: sda.sketch_decode_attn(q, k, v, ids, n_live, kv_len,
                                              LM_BLOCK, softcap)
        library_ms = library_device_ms = library_graph_ms = None
        if softcap == 0.0 and n_pos:
            ql = q.reshape(B, Hkv * G, 1, dh)
            kl, vl = k.transpose(1, 2), v.transpose(1, 2)
            mask = pos_live[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, enable_gqa=True)
            library_ms = time_ms(sdpa, 10, device)
            library_device_ms = device_ms_all(sdpa, device, 10)
            library_graph_ms = graph_ms(sdpa, device, 10)
        rows.append({
            "name": "sketch_decode_attn", "case": name,
            "shape": [B, S, Hkv, G, dh], "kv_len": kv_len, "softcap": softcap,
            "live_blocks": int(live.sum()), "live_positions": n_pos,
            "max_abs_err": err, "tolerance": [SDA_RTOL, SDA_ATOL],
            "ms": time_ms(call, 20, device),
            "device_ms": device_ms(call, "sketch_decode_attn", device),
            "graph_ms": graph_ms(call, device),
            "plain_ms": time_ms(lambda: ref.sketch_decode_attn_ref(
                q, k, v, live, kv_len, LM_BLOCK, softcap), 3, device),
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "library_graph_ms": library_graph_ms,
            "library": "F.scaled_dot_product_attention(attn_mask, enable_gqa) "
                       "over the whole cache",
            "bound_ms": b_ms, "bound_by": b_by})
    return rows


# --------------------------------------------------------------------------
# phase 4b: the streaming services (SketchEngine with WAL and snapshots)
# --------------------------------------------------------------------------

def _dir_bytes(path) -> int:
    """Bytes of the files under ``path``.  The commit thread compacts the
    WAL meanwhile, so a file (or directory) gone before it is read counts
    as absent."""
    import os
    total = 0
    for root, _, files in os.walk(path):      # os.walk skips vanished dirs
        for f in files:
            try:
                total += os.stat(os.path.join(root, f)).st_size
            except FileNotFoundError:
                pass
    return total


def _feed(svc, host, device, wal_dir=None):
    """``host`` rows into ``svc`` through ``ingest_async`` calls of
    SERVICE_CALL_ROWS rows, then ``flush``; returns (seconds, the largest
    WAL on disk seen between calls, in bytes)."""
    wal_max = 0
    t0 = time.perf_counter()
    for i in range(0, host.shape[0], SERVICE_CALL_ROWS):
        svc.ingest_async(host[i:i + SERVICE_CALL_ROWS])
        if wal_dir is not None:
            wal_max = max(wal_max, _dir_bytes(wal_dir))
    svc.flush()
    sync(device)
    return time.perf_counter() - t0, wal_max


def _durable_run(make, host, device, tmp, name, mutate=None):
    """One service's durable life: a durable service fed ``host`` (then
    ``mutate``), a volatile one fed the same, and a fresh durable one that
    recovers the directory.  Returns the three services, the line's
    numbers and the kernels launched by the two live services."""
    from repro_torch.kernels import ops
    from repro_torch.persist import snapshot
    d = Path(tmp) / name
    ops.reset_launches()
    live = make(snapshot_dir=str(d))
    t_dur, wal_max = _feed(live, host, device, d / "wal")
    wal_max = max(wal_max, _dir_bytes(d / "wal"))
    if mutate is not None:
        mutate(live)
    live.close()
    plain = make()
    t_vol, _ = _feed(plain, host, device)
    if mutate is not None:
        mutate(plain)
    launches = dict(ops.LAUNCHES)
    rec = make(snapshot_dir=str(d), batch_queries=True, max_wait_us=0.0)
    t0 = time.perf_counter()
    replayed = rec.recover()
    sync(device)
    t_rec = time.perf_counter() - t0
    seq = snapshot.latest_seq(d)
    t0 = time.perf_counter()
    snapshot.save(Path(tmp) / f"{name}_timed_snapshot", seq, rec.state)
    t_snap = time.perf_counter() - t0
    n_chunks = -(-host.shape[0] // CHUNK)
    record = host[:CHUNK].nbytes
    wal_end = _dir_bytes(d / "wal")
    # compaction deletes a segment two snapshots after it was sealed, and
    # with the queue bounded (max_pending) the log runs at most that far
    # ahead of the commits: 3 * snapshot_every + max_pending records
    bound_records = 3 * SERVICE_SNAPSHOT_EVERY + SERVICE_CALL_ROWS // CHUNK + 1
    if wal_max > bound_records * (record + 4096):
        fail(f"{name}: {wal_max} bytes of WAL on disk, more than compaction "
             f"allows ({bound_records} records)")
    line = {"points": int(host.shape[0]), "chunks": n_chunks,
            "ingest_s_durable": t_dur,
            "points_per_s_durable": host.shape[0] / t_dur,
            "ingest_s_volatile": t_vol,
            "points_per_s_volatile": host.shape[0] / t_vol,
            "snapshot_every": SERVICE_SNAPSHOT_EVERY,
            "max_pending_rows": SERVICE_CALL_ROWS,
            "newest_snapshot_seq": seq,
            "snapshot_bytes": _dir_bytes(snapshot.snapshot_path(d, seq)),
            "snapshot_s": t_snap,
            "wal_bytes_logged": n_chunks * record,
            "wal_bound_records": bound_records,
            "wal_bytes_on_disk_max": wal_max, "wal_bytes_on_disk_end": wal_end,
            "recovered_records": replayed, "recovery_s": t_rec,
            "stream_cut": None}
    shutil.rmtree(Path(tmp) / f"{name}_timed_snapshot", ignore_errors=True)
    return live, plain, rec, line, launches


def _same_state(name, **states):
    """Fail unless every state equals the first (compared on the CPU)."""
    (first, a), *rest = states.items()
    for other, b in rest:
        bad = differing_leaves(a, b)
        if bad:
            fail(f"{name}: {other} state differs from {first} in {bad}")


def _same_answers(name, got, want):
    import numpy as np
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g.shape != w.shape or not np.array_equal(g, w):
            fail(f"{name}: service answers differ from the core batch answers")


def _closed_loop(svc, qs, want, clients=SERVICE_CLIENTS):
    """``clients`` threads, each issuing sync B = 1 ``query`` calls for its
    share of ``qs`` back to back; every answer must be the direct one."""
    import threading
    import numpy as np
    lat = [[] for _ in range(clients)]
    bad = []

    def client(c):
        for j in range(c, qs.shape[0], clients):
            t0 = time.perf_counter()
            res = svc.query(qs[j:j + 1])
            lat[c].append(time.perf_counter() - t0)
            if not all(np.array_equal(g, w[j:j + 1]) for g, w in zip(res, want)):
                bad.append(j)

    before = svc.stats().get("batcher", {"ticks": 0, "queries": 0})
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail("closed-loop clients did not finish")
    if bad:
        fail(f"coalesced B = 1 answers differ from the direct ones at rows "
             f"{bad[:8]}")
    st = svc.stats()["batcher"]
    ticks = st["ticks"] - before["ticks"]
    lat_ms = np.sort(np.concatenate([np.asarray(x) for x in lat])) * 1e3
    return {"clients": clients, "queries": int(qs.shape[0]),
            "queries_per_s": qs.shape[0] / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "ticks": ticks,
            "mean_batch": (st["queries"] - before["queries"]) / max(ticks, 1),
            "bit_identical": True}


def phase_services(seed, sann_run, kde_run, device):
    """The services at full width through their public entry points:
    `RetrievalService` on the S-ANN stream, `KDEService` (p-stable and SRP)
    and `RACEService` (with a turnstile delete) on the news-like stream,
    each durable (snapshots every 64 operations, the WAL compacted behind
    them) and volatile, each recovered from its directory, every state
    bit-identical to a direct core prepare/commit loop on the card with the
    same keys, and the answers equal to the core batch queries; then 16
    closed-loop B = 1 clients through the coalescing scheduler."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.core import prng, race, sann, swakde
    from repro_torch.serve import engine, kde_service, race_service, retrieval

    free = shutil.disk_usage(tempfile.gettempdir()).free
    launches = {k: 0 for k in SERVICE_KERNELS}
    out = {"phase": "services", "tmp_free_bytes": free}
    with tempfile.TemporaryDirectory() as tmp:
        # --- S-ANN retrieval at the SIFT1M shape -----------------------------
        host = sann_run["data"].cpu().numpy()
        rcfg = retrieval.RetrievalConfig(
            dim=SANN_DIM, n_max=host.shape[0], eta=0.3, r=sann_run["r"],
            c=sann_run["c"], w=2.0 * sann_run["r"], L=12, k=6, bucket_cap=32,
            seed=seed, ingest_chunk=CHUNK, query_block=QUERY_BLOCK, topk=TOPK,
            snapshot_every=SERVICE_SNAPSHOT_EVERY,
            max_pending=SERVICE_CALL_ROWS)

        def make_retr(**kw):
            return retrieval.RetrievalService(dataclasses.replace(rcfg, **kw),
                                              device=device)

        live, plain, rec, line, got = _durable_run(make_retr, host, device,
                                                   tmp, "retrieval")
        params, cfg = live.params, live.cfg
        key = prng.fold_in(prng.PRNGKey(seed + 1, device), 0)
        st = sann.sann_empty_state(cfg, device)
        data = sann_run["data"]
        for seq, i in enumerate(range(0, host.shape[0], CHUNK)):
            st = sann.sann_commit_chunk(st, sann.sann_prepare_chunk(
                params, data[i:i + CHUNK], prng.fold_in(key, seq), cfg), cfg)
        _same_state("retrieval", direct=st, durable=live.state,
                    volatile=plain.state, recovered=rec.state)
        qs_dev = sann_run["queries"][:QUERY_BLOCK]
        qs = qs_dev.cpu().numpy()
        want_cr = engine.to_host(sann.sann_query_batch(rec.state, params,
                                                       qs_dev, cfg))
        want_topk = engine.to_host(sann.sann_query_topk_batch(
            rec.state, params, qs_dev, cfg, TOPK))
        from repro_torch.kernels import ops
        ops.reset_launches()
        _same_answers("retrieval (c, r)", rec.query(qs), want_cr)
        _same_answers("retrieval top-50", rec.query_topk(qs), want_topk)
        loop = _closed_loop(rec, qs, want_cr)
        got = {k: got[k] + ops.LAUNCHES[k] for k in got}
        out["retrieval"] = {**line, "L": cfg.L, "k": cfg.k,
                            "bucket_cap": cfg.bucket_cap,
                            "table_mb": st.tables.numel() * 4 / 1e6,
                            "n_stored": rec.stored,
                            "queries_bit_identical": 2 * QUERY_BLOCK,
                            "closed_loop_b1": loop}
        for k in launches:
            launches[k] += got[k]
        for svc in (live, plain, rec):
            svc.close()
        out["profile_service"] = make_retr()
        del st, live, rec

        # --- SW-AKDE at the news-headlines shape, both hash families ---------
        host = kde_run["data"].cpu().numpy()
        data = kde_run["data"]
        kqs_dev = kde_run["queries"][:QUERY_BLOCK]
        kqs = kqs_dev.cpu().numpy()
        kparams = {}
        for family in ("pstable", "srp"):
            kcfg = kde_service.KDEServiceConfig(
                dim=KDE_DIM, L=96, W=96, window=65_536, eh_eps=0.1,
                hash_family=family, k=2, w=4.0, seed=seed, ingest_chunk=CHUNK,
                query_block=QUERY_BLOCK, snapshot_every=SERVICE_SNAPSHOT_EVERY,
            max_pending=SERVICE_CALL_ROWS)

            def make_kde(**kw):
                return kde_service.KDEService(dataclasses.replace(kcfg, **kw),
                                              device=device)

            # the stream, then a clock advance (a WAL record past the last
            # snapshot, which falls on the stream's last chunk)
            target = host.shape[0] + SERVICE_CLOCK_STEPS
            live, plain, rec, line, got = _durable_run(
                make_kde, host, device, tmp, f"kde_{family}",
                mutate=lambda svc: svc.advance_clock(target))
            params, scfg = live.params, live.sketch_cfg
            kparams[family] = params
            st = swakde.swakde_init(scfg, device)
            for i in range(0, host.shape[0], CHUNK):
                st = swakde.swakde_update_chunk(st, params, data[i:i + CHUNK],
                                                scfg)
            st = st._replace(t=torch.clamp(st.t, min=target))
            _same_state(f"kde_{family}", direct=st, durable=live.state,
                        volatile=plain.state, recovered=rec.state)
            want = engine.to_host(swakde.swakde_query_batch(st, params,
                                                            kqs_dev, scfg))
            g0 = rec.grid_computes
            a, b = rec.query(kqs), rec.query(kqs)
            if rec.grid_computes != g0 + 1:
                fail(f"kde_{family}: two query batches between commits "
                     f"built the grid {rec.grid_computes - g0} times")
            _same_answers(f"kde_{family}", a, want)
            _same_answers(f"kde_{family} (cached grid)", b, want)
            if rec.steps != target or line["recovered_records"] < 1:
                fail(f"kde_{family}: the clock advance was not replayed")
            out[f"kde_{family}"] = {**line, "L": 96, "W": 96,
                                    "window": 65_536, "eh_eps": 0.1,
                                    "clock_advanced_to": target,
                                    "grid_builds_for_two_batches": 1,
                                    "queries_bit_identical": 2 * QUERY_BLOCK}
            for k in launches:
                launches[k] += got[k]
            for svc in (live, plain, rec):
                svc.close()
            del st, live, plain, rec

        # --- RACE on the same (p-stable) codes, with a turnstile delete -----
        ccfg = race_service.RACEServiceConfig(
            dim=KDE_DIM, L=96, W=96, hash_family="pstable", k=2, w=4.0,
            seed=seed, ingest_chunk=CHUNK, query_block=QUERY_BLOCK,
            snapshot_every=SERVICE_SNAPSHOT_EVERY,
            max_pending=SERVICE_CALL_ROWS)
        doomed = host[:SERVICE_DELETE_ROWS]

        def make_race(**kw):
            return race_service.RACEService(dataclasses.replace(ccfg, **kw),
                                            device=device,
                                            params=kparams["pstable"])

        live, plain, rec, line, got = _durable_run(
            make_race, host, device, tmp, "race",
            mutate=lambda svc: svc.delete(doomed))
        params = kparams["pstable"]
        rc = race.race_init(96, 96, device)
        for i in range(0, host.shape[0], CHUNK):
            rc = race.race_update_batch(rc, params, data[i:i + CHUNK])
        rc = race.race_update_batch(rc, params, data[:SERVICE_DELETE_ROWS],
                                    sign=-1)
        _same_state("race", direct=rc, durable=live.state, volatile=plain.state,
                    recovered=rec.state)
        if rec.count != host.shape[0] - SERVICE_DELETE_ROWS:
            fail(f"race: signed count {rec.count} after the delete")
        _same_answers("race", rec.query(kqs), engine.to_host(
            race.race_query_batch(rc, params, kqs_dev)))
        out["race"] = {**line, "L": 96, "W": 96,
                       "deleted_rows": SERVICE_DELETE_ROWS,
                       "delete_replayed": line["recovered_records"] > 0,
                       "queries_bit_identical": QUERY_BLOCK}
        for k in launches:
            launches[k] += got[k]
        for svc in (live, plain, rec):
            svc.close()
        del rc, live, plain, rec

    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        fail(f"the services launched no {missing}")
    svc = out.pop("profile_service")
    emit({**out, "launches": launches})
    return {"launches": launches, "retrieval": svc,
            "host": sann_run["data"][:8 * CHUNK].cpu().numpy()}


# --------------------------------------------------------------------------
# phase 4b: multi-tenant fleets (TenantFleet) at full width
# --------------------------------------------------------------------------

def zipf_tids(n, tenants, seed, hot_chunk=None):
    """Tenant ids of a mixed stream: Zipf (s = FLEET_ZIPF_S) over
    ``tenants``, and chunk ``hot_chunk`` (if the stream reaches it) all one
    mid-ranked tenant's (``tenants // 6``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    p = np.arange(1, tenants + 1, dtype=np.float64) ** -FLEET_ZIPF_S
    tids = rng.choice(tenants, size=n, p=p / p.sum()).astype(np.int64)
    if hot_chunk is not None and n >= (hot_chunk + 1) * CHUNK:
        tids[hot_chunk * CHUNK:(hot_chunk + 1) * CHUNK] = tenants // 6
    return tids


def _add_launches(acc):
    """Add the launch counts since the last `ops.reset_launches` to ``acc``."""
    from repro_torch.kernels import ops
    for k in acc:
        acc[k] += ops.LAUNCHES[k]


@contextlib.contextmanager
def capturing(at, clone=False):
    """Inside the block, call number ``at[name]`` (from 0) of each
    `kernels.ops` entry named in ``at`` leaves its arguments in the dict
    yielded; every call still runs the entry itself.  The entries are
    functional and a fleet ingest replaces its state every operation, so
    an ingest's kept tensors stay as the call saw them; a query's later
    blocks write activated rows into the state it read, so a query's are
    kept as copies (``clone``)."""
    import torch
    from repro_torch.kernels import ops
    saved = {name: getattr(ops, name) for name in at}
    calls = dict.fromkeys(at, 0)
    kept = {}

    def wrap(name, fn):
        def entry(*args, **kw):
            if calls[name] == at[name]:
                kept[name] = (tuple(a.clone() if clone and isinstance(
                    a, torch.Tensor) else a for a in args), kw)
            calls[name] += 1
            return fn(*args, **kw)
        return entry

    for name, fn in saved.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield kept
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def _pick_op(op_rows, tids):
    """The operation to capture: the most tenants, then the most rows, then
    the latest."""
    import numpy as np
    return max(range(len(op_rows)), key=lambda i: (
        np.unique(tids[op_rows[i][0]:op_rows[i][1]]).size,
        op_rows[i][1] - op_rows[i][0], i))


def _check_captured(where, kept, device):
    """Each captured call of a fleet (its own shapes: tenant-offset bins,
    ``T*L`` rows, ``(T,)`` pointers, the ``(T*capacity, d)`` store) run
    again through the kernel and through its plain version on the card:
    integer outputs bit for bit, SRP codes under the flip rule, top-k
    distances within (RTOL, ATOL) and ids equal but at near-ties.  Every
    captured call must be there; returns a row each."""
    import torch
    from repro_torch.kernels import (batch_score, ingest_commit, race_update,
                                     ref, srp_hash)
    runs = {
        "srp_hash": (srp_hash.srp_hash, ref.srp_hash_ref),
        "race_hist": (race_update.race_hist, ref.race_hist_ref),
        "swakde_segment_commit": (ingest_commit.swakde_segment_commit,
                                  ref.swakde_segment_commit_ref),
        "sann_table_commit": (ingest_commit.sann_table_commit,
                              ref.sann_table_commit_ref),
        "batch_score_topk_gather": (batch_score.batch_score_topk_gather,
                                    ref.batch_score_topk_gather_ref)}
    rows = []
    for name, (args, kw) in kept.items():
        kernel, plain = runs[name]
        got, want = kernel(*args, **kw), plain(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        row = {"entry": name, "fleet": where,
               "shapes": [list(a.shape) for a in args
                          if isinstance(a, torch.Tensor)]}
        if name == "srp_hash":
            x, proj, mix = args[:3]
            flips, unexplained = ref.srp_code_flips(x, proj, mix, got[0],
                                                    want[0], SRP_FLIP_TOL)
            if unexplained:
                fail(f"fleet {where}: srp_hash differs from its plain version "
                     f"away from a sign boundary ({unexplained} codes)")
            row.update(flips_at_sign_boundaries=flips, max_abs_err=int(
                (got[0].long() - want[0].long()).abs().max()))
        elif name == "batch_score_topk_gather":
            qs, points, cand, ok = args[:4]
            full = torch.where(ok, ref.batch_score_ref(
                qs, points[cand.clamp(min=0).long()]), float("inf"))
            err, mism = topk_err(got[0], got[1], want[0], want[1], full)
            row.update(max_abs_err=err, id_near_ties=mism)
        else:
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    fail(f"fleet {where}: {name} differs from its plain "
                         f"version on the fleet's inputs")
            row.update(max_abs_err=0)
        rows.append(row)
    sync(device)
    return rows


def _fleet_feed(fl, host, tids, device):
    """Mixed chunks of CHUNK rows into ``fl``; returns the seconds."""
    t0 = time.perf_counter()
    for i in range(0, host.shape[0], CHUNK):
        fl.ingest(host[i:i + CHUNK], tids[i:i + CHUNK])
    sync(device)
    return time.perf_counter() - t0


def _fleet_ops(tids, hot):
    """The fleet's operations: ``(start, stop)`` row ranges of the blocks
    `tenant_fleet.plan_ops` cuts each chunk into (contiguous, in order)."""
    from repro_torch.serve import tenant_fleet
    out = []
    for i in range(0, len(tids), CHUNK):
        for idx in tenant_fleet.plan_ops(tids[i:i + CHUNK], hot):
            out.append((i + int(idx[0]), i + int(idx[-1]) + 1))
    return out


def _fleet_codes(params, data, ops):
    """Every row's codes as the fleet computed them: each operation's block
    hashed as one call, the fleet's shape."""
    import torch
    from repro_torch.core import lsh
    return torch.cat([lsh.hash_points(params, data[a:b]) for a, b in ops])


def _by_tenant(tids, tenants, device):
    """Rows of each tenant in stream order: ``(order, starts, counts)``."""
    import numpy as np
    import torch
    order = np.argsort(tids, kind="stable")
    counts = np.bincount(tids, minlength=tenants)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return torch.from_numpy(order).to(device), starts, counts


def _state_bytes(state) -> int:
    return sum(x.numel() * x.element_size() for x in state)


def _fleet_oracle(kind, fl, data, codes, tids, op_rows, device):
    """Tenant t -> its sketch fed its own sub-stream through the
    single-sketch core loop on the card, with the fleet's codes (and, for
    S-ANN, each operation's keep draws under that operation's key for t),
    built when asked for, so the oracles of a fleet never all sit on the
    card at once."""
    import numpy as np
    import torch
    from repro_torch.core import prng, race, sann, swakde
    from repro_torch.kernels import ops
    cfg = fl.sketch_cfg
    if kind == "sann":
        per_t = {}
        for seq, (a, b) in enumerate(op_rows):
            tt = tids[a:b]
            for t in np.unique(tt):
                per_t.setdefault(int(t), []).append(
                    (seq, a + np.nonzero(tt == t)[0]))

        def oracle(t):
            st = sann.sann_empty_state(cfg, device)
            for seq, idx in per_t.get(t, []):
                rows = torch.from_numpy(idx).to(device)
                keep = prng.bernoulli(sann.sann_row_keys(prng.fold_in(
                    prng.fold_in(fl.base_key, seq), t), rows.shape[0]),
                    cfg.keep_prob)
                st = sann.sann_commit_chunk(st, sann.sann_prepare_given_keep(
                    fl.params, data[rows], keep, cfg, codes=codes[rows]), cfg)
            return st
        return oracle

    order, starts, counts = _by_tenant(tids, int(tids.max()) + 1, device)

    def chunks(t):
        if t >= len(counts):
            return []
        rows = order[starts[t]:starts[t] + counts[t]]
        return [codes[rows[j:j + CHUNK]] for j in range(0, rows.shape[0], CHUNK)]

    if kind == "race":
        L, W = fl.empty_state.counts.shape

        def oracle(t):
            st = race.race_init(L, W, device)
            for c in chunks(t):
                st = race.race_commit_chunk(st, race.RACEPrep(
                    hist=ops.race_hist(c, W), count=c.shape[0]))
            return st
        return oracle

    def oracle(t):
        st = swakde.swakde_init(cfg, device)
        for c in chunks(t):
            st = swakde.swakde_commit_chunk(
                st, swakde.swakde_prepare_from_codes(c, cfg), cfg)
        return st
    return oracle


def _oracle_check(name, fl, tenants, oracle_of):
    """Every tenant's row (hot, spilled or never seen) equals its oracle."""
    bad = []
    for t in range(tenants):
        diff = differing_leaves(fl.peek_state(t), oracle_of(t))
        if diff:
            bad.append((t, diff))
    if bad:
        fail(f"fleet {name}: tenant rows differ from the single-sketch loop "
             f"for {len(bad)} tenants, e.g. {bad[:4]}")


def _fleet_query_check(name, fl, qs_dev, qt, oracle, query, direct, device,
                       exact, launches):
    """Fleet answers for ``qs`` against each tenant's own sketch, block by
    block as the fleet cuts them; ``exact`` lists the fields compared bit for
    bit, the others within (RTOL, ATOL).  Returns queries/s; the fleet's
    launches are added to ``launches``."""
    import numpy as np
    from repro_torch.serve import engine, tenant_fleet
    from repro_torch.kernels import ops
    qs = qs_dev.cpu().numpy()
    sync(device)
    ops.reset_launches()
    t0 = time.perf_counter()
    got = direct(qs, qt)
    sync(device)
    rate = qs.shape[0] / (time.perf_counter() - t0)
    _add_launches(launches)
    got = got if isinstance(got, tuple) else (got,)
    for idx in tenant_fleet.plan_ops(qt, fl.cfg.hot_slots):
        a, b = int(idx[0]), int(idx[-1]) + 1
        for t in np.unique(qt[a:b]):
            m = qt[a:b] == t
            want = engine.to_host(query(oracle[int(t)], qs_dev[a:b]))
            want = want if isinstance(want, tuple) else (want,)
            for j, (g, w) in enumerate(zip(got, want)):
                g, w = g[a:b][m], w[m]
                ok = (np.array_equal(g, w) if j in exact else
                      np.allclose(g, w, rtol=RTOL, atol=ATOL, equal_nan=True))
                if not ok:
                    fail(f"fleet {name}: answers of tenant {t} differ from "
                         f"its own sketch's (field {j})")
    return rate


def _fleet_cpu_replay(kind, fl, host, tids, codes, ops, device):
    """The fleet's operations re-run on the CPU through the core fleet
    functions (the plain versions of every kernel) with the card's codes;
    the tenants all fit (no eviction), so tenant t sits in the slot of its
    first appearance.  The stacked state must equal the card's."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.core import fleet, prng
    from repro_torch.serve.tenant_fleet import _next_pow2
    T = fl.cfg.hot_slots
    params = convert.params_from_numpy(convert.to_numpy(fl.params), "cpu")
    empty = type(fl.empty_state)(*(x.cpu() for x in fl.empty_state))
    st = fleet.fleet_broadcast(empty, T)
    base = fl.base_key.cpu()
    slot_of, exts = {}, np.zeros(T, np.int64)
    for seq, (a, b) in enumerate(ops):
        tt = tids[a:b]
        for t in dict.fromkeys(tt.tolist()):
            if t not in slot_of:
                slot_of[t] = len(slot_of)
                exts[slot_of[t]] = t
        sl = torch.tensor([slot_of[t] for t in tt.tolist()], dtype=torch.int32)
        x = torch.from_numpy(host[a:b])
        c = codes[a:b].cpu()
        cap = _next_pow2(int(np.bincount(sl.numpy()).max()))
        if kind == "race":
            st = fleet.race_fleet_ingest(st, params, x, sl, codes=c)
        elif kind == "swakde":
            st = fleet.swakde_fleet_ingest(st, params, x, sl, fl.sketch_cfg, cap,
                                           codes=c)
        else:
            keys = fleet.sann_fleet_keys(prng.fold_in(base, seq),
                                         torch.from_numpy(exts))
            st = fleet.sann_fleet_ingest(st, params, x, sl, keys,
                                         fl.sketch_cfg, cap, codes=c)
    bad = differing_leaves(fl.stacked, st)
    if bad:
        fail(f"fleet {kind} T={T}: card and CPU stacked states differ in {bad}")
    return len(ops)


def _fleet_gate(kind, T, make, host, data, seed, device):
    """A fleet of T hot slots fed FLEET_GATE_CHUNKS[T] chunks of a stream
    Zipf over T tenants (all fit): one launch of the kind's commit kernel
    (and, for the SRP RACE fleet, of ``srp_hash`` and ``race_hist``) an
    operation; every tenant's row equal to its single-sketch core loop on
    the card; at T = 8 the whole stream also re-run on the CPU."""
    from repro_torch.kernels import ops
    n = FLEET_GATE_CHUNKS[T] * CHUNK
    tids = zipf_tids(n, T, seed + T)
    fl = make(T)
    launches = {k: 0 for k in ops.LAUNCHES}
    ops.reset_launches()
    secs = _fleet_feed(fl, host[:n], tids, device)
    _add_launches(launches)
    per_op = {"race": ("srp_hash", "race_hist"),
              "swakde": ("swakde_segment_pass",),
              "sann": ("sann_table_scatter",)}[kind]
    bad = {k: launches[k] for k in per_op if launches[k] != fl.seq}
    if bad or fl.splits:
        fail(f"fleet {kind} T={T}: {fl.seq} operations launched {bad} "
             f"(splits {fl.splits}); expected one launch each an operation")
    op_rows = _fleet_ops(tids, T)
    codes = _fleet_codes(fl.params, data, op_rows)
    _oracle_check(f"{kind} T={T}", fl, T, _fleet_oracle(
        kind, fl, data, codes, tids, op_rows, device))
    line = {"T": T, "points": n, "operations": fl.seq,
            "points_per_s": n / secs, "launches": {k: launches[k] for k in per_op},
            "launches_per_operation": 1,
            "tenant_rows_bit_identical": T,
            "device_bytes": _state_bytes(fl.stacked)}
    if T == FLEET_GATE_T[0]:
        line["cpu_cross_check_chunks"] = FLEET_GATE_CHUNKS[T]
        line["cpu_operations"] = _fleet_cpu_replay(kind, fl, host, tids,
                                                   codes, op_rows, device)
        line["cpu_bit_identical"] = True
    fl.close()
    return line, launches


def phase_fleet(seed, sann_run, kde_run, device, n_race=FLEET_RACE_N,
                n_sw=FLEET_SW_N, n_sann=FLEET_SANN_N,
                n_queries=FLEET_QUERIES):
    """Multi-tenant fleets through `serve.tenant_fleet.TenantFleet` at full
    width, fed mixed chunks of 4096 rows whose tenants are Zipf (s = 1.1),
    with one chunk all one tenant's:

    * RACE (SRP, news width): 256 hot slots over 1024 tenants, spilling and
      reactivating; every tenant's row against its sub-stream through the
      single-sketch core loop on the card with the fleet's codes; a durable
      fleet recovered by a fresh one;
    * SW-AKDE (p-stable, eps 0.1, window 8192 a tenant): 256 tenants in 256
      slots, hot tenants expiring and cold ones not;
    * S-ANN (SIFT shape, n_max 65 536 a tenant): 64 hot slots over 72
      tenants, every operation's per-tenant keys replayed; top-50 and (c, r)
      queries in a 2048-query block against each tenant's own sketch;
    * the kernels of one operation of each fleet (and of one query block of
      each S-ANN path) run again on the inputs the fleet gave them, against
      their plain versions on the card;
    * each kind at T = 8 (cross-checked on the CPU) and T = 256: one launch
      of the commit kernel an operation whatever T is, every tenant's row
      its single-sketch loop's;
    * a profile window of 4 fleet chunks each."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import race, sann, swakde
    from repro_torch.kernels import ops
    from repro_torch.serve import tenant_fleet

    out = {"phase": "fleet", "zipf_s": FLEET_ZIPF_S, "chunk": CHUNK}
    launches = {k: 0 for k in ops.LAUNCHES}
    checks = []

    def feed(fl, host, tids, at):
        """The counted feed, capturing the calls ``at`` names."""
        with capturing(at) as kept:
            ops.reset_launches()
            secs = _fleet_feed(fl, host, tids, device)
            _add_launches(launches)
        return secs, kept

    kdata = kde_run["data"]
    khost = kdata[:max(n_race, n_sw)].cpu().numpy()
    L = W = 96

    # --- RACE: 256 hot slots over 1024 tenants ----------------------------
    rcfg = tenant_fleet.TenantFleetConfig(kind="race", dim=KDE_DIM,
                                          hot_slots=FLEET_HOT, seed=seed,
                                          L=L, W=W, k=2)

    def make_race(T=FLEET_HOT, **kw):
        return tenant_fleet.TenantFleet(
            dataclasses.replace(rcfg, hot_slots=T, **kw), device=device)

    tids = zipf_tids(n_race, FLEET_TENANTS, seed, FLEET_HOT_CHUNK)
    op_rows = _fleet_ops(tids, FLEET_HOT)
    pick = _pick_op(op_rows, tids)
    fl = make_race()
    secs, kept = feed(fl, khost[:n_race], tids,
                      {"srp_hash": pick, "race_hist": pick})
    if len(op_rows) != fl.seq or fl.spills == 0:
        fail(f"fleet race: {fl.seq} operations, {len(op_rows)} planned, "
             f"{fl.spills} spills")
    checks += [dict(r, operation=pick, T=FLEET_HOT)
               for r in _check_captured("race", kept, device)]
    del kept
    codes = _fleet_codes(fl.params, kdata, op_rows)
    of = _fleet_oracle("race", fl, kdata, codes, tids, op_rows, device)
    oracle = {t: of(t) for t in range(FLEET_TENANTS)}
    _oracle_check("race", fl, FLEET_TENANTS, oracle.__getitem__)
    qsrc = torch.randint(0, n_race, (n_queries,), generator=torch.Generator(
        device="cpu").manual_seed(seed + 7)).numpy()
    qt = tids[qsrc]
    qs_dev = kdata[torch.from_numpy(qsrc).to(device)]
    q_rate = _fleet_query_check(
        "race", fl, qs_dev, qt, oracle,
        lambda st, q: race.race_query_batch(st, fl.params, q), fl.query,
        device, (0,), launches)
    out["race"] = {"tenants": FLEET_TENANTS, "hot_slots": FLEET_HOT,
                   "points": n_race, "L": L, "W": W, "hash": "srp",
                   "operations": fl.seq, "splits": fl.splits,
                   "spills": fl.spills, "activations": fl.activations,
                   "ingest_s": secs, "points_per_s": n_race / secs,
                   "queries": n_queries, "queries_per_s": q_rate,
                   "device_bytes": _state_bytes(fl.stacked),
                   "tenant_rows_bit_identical": FLEET_TENANTS,
                   "hot_chunk": FLEET_HOT_CHUNK}
    race_fleet = fl
    del oracle, codes

    # --- RACE durable: snapshots every 4 operations, spills to disk --------
    with tempfile.TemporaryDirectory() as tmp:
        n_dur = FLEET_DURABLE_CHUNKS * CHUNK
        live = make_race(snapshot_dir=tmp, snapshot_every=FLEET_SNAPSHOT_EVERY)
        ops.reset_launches()
        t_dur = _fleet_feed(live, khost[:n_dur], tids[:n_dur], device)
        # one operation past the last snapshot: a WAL tail to replay
        live.ingest(khost[n_dur:n_dur + 100], np.zeros(100, np.int64))
        _add_launches(launches)
        live.close()
        rec = make_race(snapshot_dir=tmp, snapshot_every=FLEET_SNAPSHOT_EVERY)
        t0 = time.perf_counter()
        replayed = rec.recover()
        t_rec = time.perf_counter() - t0
        if rec.seq != live.seq or rec.hot_tenants != live.hot_tenants:
            fail("fleet race durable: the recovered fleet's op seq or hot set "
                 "differs from the live one's")
        _oracle_check("race recovered", rec, FLEET_TENANTS, live.peek_state)
        out["race_durable"] = {
            "points": n_dur, "operations": live.seq, "spills": live.spills,
            "snapshot_every": FLEET_SNAPSHOT_EVERY,
            "points_per_s_durable": n_dur / t_dur,
            "recovered_records": replayed, "recovery_s": t_rec,
            "tenants_bit_identical": FLEET_TENANTS,
            "dir_bytes": _dir_bytes(tmp)}
        rec.close()
        del live, rec

    # --- SW-AKDE: 256 tenants in 256 slots, window 8192 a tenant -----------
    scfg = tenant_fleet.TenantFleetConfig(
        kind="swakde", dim=KDE_DIM, hot_slots=FLEET_HOT, seed=seed, L=L, W=W,
        k=2, w=4.0, window=FLEET_SW_WINDOW, eh_eps=0.1)

    def make_sw(T=FLEET_HOT, **kw):
        return tenant_fleet.TenantFleet(
            dataclasses.replace(scfg, hot_slots=T, **kw), device=device)

    tids = zipf_tids(n_sw, FLEET_SW_TENANTS, seed + 1, FLEET_HOT_CHUNK)
    op_rows = _fleet_ops(tids, FLEET_HOT)
    pick = _pick_op(op_rows, tids)
    fl = make_sw()
    secs, kept = feed(fl, khost[:n_sw], tids, {"swakde_segment_commit": pick})
    checks += [dict(r, operation=pick, T=FLEET_HOT)
               for r in _check_captured("swakde", kept, device)]
    del kept
    codes = _fleet_codes(fl.params, kdata, op_rows)
    cfg = fl.sketch_cfg
    of = _fleet_oracle("swakde", fl, kdata, codes, tids, op_rows, device)
    oracle = {t: of(t) for t in range(FLEET_SW_TENANTS)}
    _oracle_check("swakde", fl, FLEET_SW_TENANTS, oracle.__getitem__)
    counts = np.bincount(tids, minlength=FLEET_SW_TENANTS)
    if not (counts.max() > FLEET_SW_WINDOW > counts.min()):
        fail("fleet swakde: the stream must expire hot tenants and not cold ones")
    qsrc = torch.randint(0, n_sw, (n_queries,), generator=torch.Generator(
        device="cpu").manual_seed(seed + 8)).numpy()
    qt = tids[qsrc]
    qs_dev = kdata[torch.from_numpy(qsrc).to(device)]
    q_rate = _fleet_query_check(
        "swakde", fl, qs_dev, qt, oracle,
        lambda st, q: swakde.swakde_query_batch(st, fl.params, q, cfg),
        fl.query, device, (0,), launches)
    out["swakde"] = {"tenants": FLEET_SW_TENANTS, "hot_slots": FLEET_HOT,
                     "points": n_sw, "L": L, "W": W, "hash": "pstable",
                     "window": FLEET_SW_WINDOW, "eh_eps": 0.1,
                     "operations": fl.seq, "splits": fl.splits,
                     "tenants_expiring": int((counts > FLEET_SW_WINDOW).sum()),
                     "ingest_s": secs, "points_per_s": n_sw / secs,
                     "queries": n_queries, "queries_per_s": q_rate,
                     "device_bytes": _state_bytes(fl.stacked),
                     "tenant_rows_bit_identical": FLEET_SW_TENANTS}
    sw_fleet = fl
    del oracle, codes

    # --- S-ANN: 64 hot slots over 72 tenants at the SIFT shape -------------
    sdata = sann_run["data"]
    shost = sdata[:n_sann].cpu().numpy()
    r, c = sann_run["r"], sann_run["c"]
    acfg = tenant_fleet.TenantFleetConfig(
        kind="sann", dim=SANN_DIM, hot_slots=FLEET_SANN_HOT, seed=seed,
        n_max=FLEET_SANN_NMAX, eta=0.3, r=r, c=c, w=2.0 * r, L=12, k=6,
        bucket_cap=32)

    def make_sann(T=FLEET_SANN_HOT, **kw):
        return tenant_fleet.TenantFleet(
            dataclasses.replace(acfg, hot_slots=T, **kw), device=device)

    tids = zipf_tids(n_sann, FLEET_SANN_TENANTS, seed + 2, FLEET_HOT_CHUNK)
    op_rows = _fleet_ops(tids, FLEET_SANN_HOT)
    pick = _pick_op(op_rows, tids)
    fl = make_sann()
    secs, kept = feed(fl, shost, tids, {"sann_table_commit": pick})
    checks += [dict(r, operation=pick, T=FLEET_SANN_HOT)
               for r in _check_captured("sann", kept, device)]
    del kept
    cfg = fl.sketch_cfg
    codes = _fleet_codes(fl.params, sdata, op_rows)
    of = _fleet_oracle("sann", fl, sdata, codes, tids, op_rows, device)
    oracle = {t: of(t) for t in range(FLEET_SANN_TENANTS)}
    _oracle_check("sann", fl, FLEET_SANN_TENANTS, oracle.__getitem__)
    qsrc = torch.randint(0, n_sann, (n_queries,), generator=torch.Generator(
        device="cpu").manual_seed(seed + 9)).numpy()
    qt = tids[qsrc]
    g = torch.Generator(device=device).manual_seed(seed + 9)
    qs_dev = sdata[torch.from_numpy(qsrc).to(device)] + 0.01 * torch.randn(
        (n_queries, SANN_DIM), generator=g, device=device)
    # the scorer on the fleet's own query inputs (one untimed block each)
    qs_np = qs_dev.cpu().numpy()
    for path, run in (("sann (c, r)", fl.query),
                      ("sann top-50", lambda q, t: fl.query_topk(q, t, TOPK))):
        with capturing({"batch_score_topk_gather": 0}, clone=True) as kept:
            run(qs_np, qt)
        checks += [dict(r, T=FLEET_SANN_HOT, queries=n_queries)
                   for r in _check_captured(path, kept, device)]
        del kept
    q_rate = _fleet_query_check(
        "sann (c, r)", fl, qs_dev, qt, oracle,
        lambda st, q: tuple(sann.sann_query_batch(st, fl.params, q, cfg)),
        lambda q, t: tuple(fl.query(q, t)), device, (0, 2, 3), launches)
    k_rate = _fleet_query_check(
        "sann top-50", fl, qs_dev, qt, oracle,
        lambda st, q: sann.sann_query_topk_batch(st, fl.params, q, cfg, TOPK),
        lambda q, t: fl.query_topk(q, t, TOPK), device, (0,), launches)
    out["sann"] = {"tenants": FLEET_SANN_TENANTS, "hot_slots": FLEET_SANN_HOT,
                   "points": n_sann, "dim": SANN_DIM, "n_max": FLEET_SANN_NMAX,
                   "L": cfg.L, "k": cfg.k, "bucket_cap": cfg.bucket_cap,
                   "capacity": cfg.capacity, "operations": fl.seq,
                   "splits": fl.splits, "spills": fl.spills,
                   "activations": fl.activations,
                   "ingest_s": secs, "points_per_s": n_sann / secs,
                   "queries": n_queries, "cr_queries_per_s": q_rate,
                   "topk_queries_per_s": k_rate,
                   "device_bytes": _state_bytes(fl.stacked),
                   "tenant_rows_bit_identical": FLEET_SANN_TENANTS}
    out["kernel_checks"] = checks
    del oracle, codes

    # --- profile windows of 4 fleet chunks ---------------------------------
    profile = {}
    n4 = 4 * CHUNK
    for name, f, host, tt in (
            ("race", race_fleet, khost, zipf_tids(n4, FLEET_TENANTS, seed + 11)),
            ("swakde", sw_fleet, khost, zipf_tids(n4, FLEET_SW_TENANTS, seed + 12)),
            ("sann", fl, shost, zipf_tids(n4, FLEET_SANN_TENANTS, seed + 13))):
        ops.reset_launches()
        row = profile_window(f"{name}_fleet_ingest_4_chunks",
                             lambda f=f, h=host, t=tt: _fleet_feed(
                                 f, h[:n4], t, device), device)
        _add_launches(launches)
        profile[name] = {k: row[k] for k in ("wall_ms", "device_busy_ms",
                                             "device_busy_share", "device_ops",
                                             "host_waits")}
    out["profile_4_chunks"] = profile
    for f in (race_fleet, sw_fleet, fl):
        f.close()
    del race_fleet, sw_fleet, fl

    # --- one launch an operation at T = 8 and T = 256 ---------------------
    gates = {}
    for kind, make, host, data in (("race", make_race, khost, kdata),
                                   ("swakde", make_sw, khost, kdata),
                                   ("sann", make_sann, shost, sdata)):
        gates[kind] = []
        for T in FLEET_GATE_T:
            line, got = _fleet_gate(kind, T, make, host, data, seed, device)
            for k in launches:
                launches[k] += got[k]
            gates[kind].append(line)
            torch.cuda.empty_cache()
    out["per_T"] = gates
    emit({**out, "launches": launches})
    return {"launches": launches}


# --------------------------------------------------------------------------
# phase 4c: the in-process merge cluster on the card
# --------------------------------------------------------------------------

def _cluster_feed(cl, host, device):
    """``host`` rows through ``ingest_async`` calls of SERVICE_CALL_ROWS
    rows, then ``flush``; returns the seconds."""
    t0 = time.perf_counter()
    for i in range(0, host.shape[0], SERVICE_CALL_ROWS):
        cl.ingest_async(host[i:i + SERVICE_CALL_ROWS])
    cl.flush()
    sync(device)
    return time.perf_counter() - t0


def _timed_merge(cl, device):
    """The coordinator's merge of the workers' current states, timed (ms),
    and the merged state it serves."""
    states = [w.snapshot()[0] for w in cl.workers]
    sync(device)
    t0 = time.perf_counter()
    merged = cl._merge_fn(states) if len(states) > 1 else states[0]
    sync(device)
    return (time.perf_counter() - t0) * 1e3, merged


def _timed_queries(fn, qs, device, reps=3):
    """Queries/s of ``fn(qs)`` (a 2048-query block), best of ``reps``."""
    best = 0.0
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn(qs)
        sync(device)
        best = max(best, qs.shape[0] / (time.perf_counter() - t0))
    return best


def _cpu_sann_merge(a, b, params_dev, params_cpu, cfg, device):
    """The canonical interleaving rule, on the CPU: the stored points of
    ``a`` then ``b`` ordered by (invalid last, arrival stamp), ties a before
    b (numpy's stable lexsort), replayed from an empty sketch through the
    plain versions with the card's codes, stamps restored."""
    import numpy as np
    import torch
    from repro_torch.core import lsh, sann
    from repro_torch.core.util import saturating_add, set_drop
    pts = torch.cat([a.points.cpu(), b.points.cpu()])
    valid = torch.cat([a.valid.cpu(), b.valid.cpu()])
    stamps = torch.cat([a.stamps.cpu(), b.stamps.cpu()])
    order = torch.from_numpy(np.lexsort((stamps.numpy(), ~valid.numpy())))
    xs, keep, st_sorted = pts[order], valid[order], stamps[order]
    codes = lsh.hash_points(params_dev, xs.to(device)).cpu()
    prep = sann.sann_prepare_given_keep(params_cpu, xs, keep, cfg, codes=codes)
    merged = sann.sann_commit_chunk(sann.sann_empty_state(cfg, "cpu"), prep, cfg)
    slot = prep.kept_rank % cfg.capacity
    win = torch.where(prep.winner, slot, cfg.capacity)
    return merged._replace(stamps=set_drop(merged.stamps, win, st_sorted),
                           n_seen=saturating_add(a.n_seen.cpu(), b.n_seen.cpu()))


def phase_cluster(seed, sann_run, kde_run, device, n_sann=SANN_N,
                  n_race=KDE_N, n_kde=CLUSTER_KDE_N,
                  n_durable=CLUSTER_DURABLE_N, workers=CLUSTER_WORKERS):
    """In-process merge clusters on the one card, at K = 1, 2 and 4 workers,
    fed from host numpy through ``ingest_async`` and ``flush``:

    * `ClusterRetrievalService` at the SIFT1M shape of the ``sann`` phase:
      the merged state equals the port's `sann_merge` of the workers' states
      on the card and the canonical interleaving rule replayed on the CPU;
    * `ClusterKDEService` at the news shape (SRP), eps 0.01, worker windows
      65 536 / K, a stream short enough that nothing expires: answers equal
      one `KDEService` (window 65 536) over the stream, bit for bit; then
      the rest of the news stream through the same cluster, timed for the
      ingest rate;
    * `ClusterRACEService` at the news shape (SRP): the merged counters
      equal one `RACEService` over the stream, bit for bit;
    * a durable RACE cluster (K = 2) recovered by a fresh one, and a K = 4
      RACE cluster whose worker 1 dies at a ``faults`` site (its commit,
      then every recovery): its WAL tail re-partitioned to the survivors,
      the merge still one service's."""
    import dataclasses
    import functools
    import tempfile
    from repro_torch import convert
    from repro_torch.core import sann
    from repro_torch.kernels import ops
    from repro_torch.persist import faults
    from repro_torch.serve import cluster, engine, kde_service, race_service
    from repro_torch.serve import retrieval

    out = {"phase": "cluster", "workers": list(workers),
           "call_rows": SERVICE_CALL_ROWS}
    launches = {k: 0 for k in ops.LAUNCHES}

    # --- S-ANN retrieval at the SIFT1M shape ------------------------------
    shost = sann_run["data"][:n_sann].cpu().numpy()
    qs_dev = sann_run["queries"][:QUERY_BLOCK]
    qs = qs_dev.cpu().numpy()
    rcfg = retrieval.RetrievalConfig(
        dim=SANN_DIM, n_max=SANN_N, eta=0.3, r=sann_run["r"], c=sann_run["c"],
        w=2.0 * sann_run["r"], L=12, k=6, bucket_cap=32, seed=seed,
        ingest_chunk=CHUNK, query_block=QUERY_BLOCK, topk=TOPK,
        max_pending=SERVICE_CALL_ROWS)
    rows = []
    for K in workers:
        cl = cluster.ClusterRetrievalService(rcfg, num_workers=K,
                                             merge_every=8, device=device)
        ops.reset_launches()
        secs = _cluster_feed(cl, shost, device)
        merge_ms, merged = _timed_merge(cl, device)
        served = cl.merged_state()
        got_cr = cl.query(qs)
        cr_rate = _timed_queries(cl.query, qs, device)
        topk_rate = _timed_queries(cl.query_topk, qs, device)
        _add_launches(launches)
        w0 = cl.workers[0]
        direct = functools.reduce(
            lambda a, b: sann.sann_merge(a, b, w0.params, w0.cfg),
            [w.state for w in cl.workers])
        _same_state(f"cluster retrieval K={K}", direct=direct, served=served,
                    timed=merged)
        if K > 1:
            pc = convert.params_from_numpy(convert.to_numpy(w0.params), "cpu")
            cpu = functools.reduce(
                lambda a, b: _cpu_sann_merge(a, b, w0.params, pc, w0.cfg,
                                             device),
                [w.state for w in cl.workers])
            _same_state(f"cluster retrieval K={K} (CPU rule)", card=served,
                        cpu=cpu)
        cr = engine.to_host(sann.sann_query_batch(served, w0.params, qs_dev,
                                                  w0.cfg))
        _same_answers(f"cluster retrieval K={K}", got_cr, cr)
        rows.append({"K": K, "points": n_sann, "ingest_s": secs,
                     "points_per_s": n_sann / secs, "merge_ms": merge_ms,
                     "n_stored": int(served.n_stored),
                     "cr_queries_per_s": cr_rate,
                     "topk_queries_per_s": topk_rate,
                     "cpu_rule_checked": K > 1,
                     "device_bytes": sum(_state_bytes(w.state)
                                         for w in cl.workers)})
        cl.close()
        del cl, merged, served, direct
    out["retrieval"] = rows

    # --- SW-AKDE at the news shape, eps 0.01, nothing expires -------------
    kdata = kde_run["data"]
    n_long = max(n_race, n_kde)
    khost = kdata[:n_long].cpu().numpy()
    kqs = kde_run["queries"][:QUERY_BLOCK].cpu().numpy()
    kcfg = kde_service.KDEServiceConfig(
        dim=KDE_DIM, L=96, W=96, window=CLUSTER_KDE_WINDOW, eh_eps=0.01,
        hash_family="srp", k=2, seed=seed, ingest_chunk=CHUNK,
        query_block=QUERY_BLOCK, max_pending=SERVICE_CALL_ROWS)
    single = kde_service.KDEService(kcfg, device=device)
    _cluster_feed(single, khost[:n_kde], device)
    want = single.query(kqs)
    rows, kept_kde = [], {}
    for K in workers:
        cl = cluster.ClusterKDEService(
            dataclasses.replace(kcfg, window=CLUSTER_KDE_WINDOW // K),
            num_workers=K, merge_every=8, device=device)
        ops.reset_launches()
        secs = _cluster_feed(cl, khost[:n_kde], device)
        merge_ms, _ = _timed_merge(cl, device)
        got = cl.query(kqs)
        q_rate = _timed_queries(cl.query, kqs, device)
        _add_launches(launches)
        if max(w.steps for w in cl.workers) >= CLUSTER_KDE_WINDOW // K:
            fail(f"cluster kde K={K}: a worker's window expired")
        _same_answers(f"cluster kde K={K}", got, want)
        kept_kde[K] = {"gate": (cl.merged_state(), got)}
        # the ingest rate over the rest of the news stream (no gate: the
        # workers' windows expire), the short gate stream's being too short
        ops.reset_launches()
        secs_long = _cluster_feed(cl, khost[n_kde:n_long], device)
        _add_launches(launches)
        kept_kde[K]["end"] = (cl.merged_state(), cl.query(kqs))
        rows.append({"K": K, "points": n_kde, "worker_window":
                     CLUSTER_KDE_WINDOW // K, "eh_eps": 0.01,
                     "ingest_s_gate_stream": secs,
                     "points_per_s_gate_stream": n_kde / secs,
                     "points_long": n_long - n_kde, "ingest_s_long": secs_long,
                     "points_per_s": (n_long - n_kde) / secs_long,
                     "merge_ms": merge_ms,
                     "queries_per_s": q_rate,
                     "answers_equal_single_service": True,
                     "device_bytes": sum(_state_bytes(w.state)
                                         for w in cl.workers)})
        cl.close()
    single.close()
    out["kde"] = rows

    # --- RACE at the news shape -------------------------------------------
    ccfg = race_service.RACEServiceConfig(
        dim=KDE_DIM, L=96, W=96, hash_family="srp", k=2, seed=seed,
        ingest_chunk=CHUNK, query_block=QUERY_BLOCK,
        max_pending=SERVICE_CALL_ROWS)
    single = race_service.RACEService(ccfg, device=device)
    _cluster_feed(single, khost[:n_race], device)
    rows, kept_race = [], {}
    for K in workers:
        cl = cluster.ClusterRACEService(ccfg, num_workers=K, merge_every=8,
                                        device=device)
        ops.reset_launches()
        secs = _cluster_feed(cl, khost[:n_race], device)
        merge_ms, _ = _timed_merge(cl, device)
        got = cl.query(kqs)
        q_rate = _timed_queries(cl.query, kqs, device)
        _add_launches(launches)
        kept_race[K] = (cl.merged_state(), got)
        _same_state(f"cluster race K={K}", single=single.state,
                    merged=kept_race[K][0])
        _same_answers(f"cluster race K={K}", got, single.query(kqs))
        rows.append({"K": K, "points": n_race, "ingest_s": secs,
                     "points_per_s": n_race / secs, "merge_ms": merge_ms,
                     "queries_per_s": q_rate,
                     "state_equals_single_service": True,
                     "device_bytes": sum(_state_bytes(w.state)
                                         for w in cl.workers)})
        cl.close()
    single.close()
    out["race"] = rows

    # --- durability and failover (RACE) -----------------------------------
    part = khost[:n_durable]
    single = race_service.RACEService(ccfg, device=device)
    _cluster_feed(single, part, device)
    with tempfile.TemporaryDirectory() as tmp:
        dcfg = dataclasses.replace(ccfg, snapshot_dir=f"{tmp}/durable",
                                   snapshot_every=SERVICE_SNAPSHOT_EVERY // 4)
        live = cluster.ClusterRACEService(dcfg, num_workers=2, device=device)
        ops.reset_launches()
        t_dur = _cluster_feed(live, part, device)
        _add_launches(launches)
        want = live.merged_state()
        live.close()
        rec = cluster.ClusterRACEService(dcfg, num_workers=2, device=device)
        t0 = time.perf_counter()
        replayed = rec.recover()
        t_rec = time.perf_counter() - t0
        _same_state("cluster race durable", live=want,
                    recovered=rec.merged_state(), single=single.state)
        rec.close()
        out["durable"] = {"K": 2, "points": n_durable,
                          "points_per_s_durable": n_durable / t_dur,
                          "recovered_records": replayed, "recovery_s": t_rec,
                          "device_bytes": 2 * _state_bytes(want)}

        fcfg = dataclasses.replace(ccfg, snapshot_dir=f"{tmp}/failover",
                                   snapshot_every=10**6)
        cl = cluster.ClusterRACEService(
            fcfg, num_workers=4, device=device,
            failover=cluster.FailoverConfig(on_degraded="partial",
                                            max_retries=1, backoff_s=0.001))
        plan = faults.FaultPlan([
            faults.FaultSpec(site="worker_1/engine.commit", mode="crash",
                             hit=2),
            faults.FaultSpec(site="worker_1/engine.recover", mode="crash",
                             hit=1, count=99)])
        ops.reset_launches()
        with faults.installed(plan):
            for i in range(0, part.shape[0], SERVICE_CALL_ROWS):
                cl.ingest(part[i:i + SERVICE_CALL_ROWS])
        _add_launches(launches)
        h = cl.health()
        if h["dead_workers"] != [1] or h["salvage_complete"] != [1]:
            fail(f"cluster failover: dead {h['dead_workers']}, salvaged "
                 f"{h['salvage_complete']}")
        _same_state("cluster race after a dead worker's salvage",
                    single=single.state, merged=cl.merged_state())
        out["failover"] = {"K": 4, "points": n_durable,
                           "device_bytes": sum(_state_bytes(w.state)
                                               for w in cl.workers),
                           "dead_workers": h["dead_workers"],
                           "salvaged_rows": h["counters"]["salvaged_rows"],
                           "coverage": h["coverage"],
                           "merged_equals_single_service": True}
        cl.close()
    single.close()
    emit({**out, "launches": launches})
    # what the rpc_cluster phase holds its clusters to: the same streams,
    # configurations and in-process merged states and answers
    return {"launches": launches, "shost": shost, "khost": khost,
            "qs": qs, "kqs": kqs, "rcfg": rcfg, "kcfg": kcfg, "ccfg": ccfg,
            "n_kde": n_kde, "n_race": n_race, "n_durable": n_durable,
            "race": kept_race, "kde": kept_kde}


# --------------------------------------------------------------------------
# the RPC cluster: each worker a spawned CUDA process (repro_torch.net)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _rpc_open(make):
    """The RPC cluster ``make()`` builds, with its start-up seconds (every
    worker process spawned and connected); closed on the way out, after
    which no worker process may be alive."""
    import multiprocessing
    t0 = time.perf_counter()
    cl = make()
    start_s = time.perf_counter() - t0
    try:
        yield cl, start_s
    finally:
        cl.close()
    left = [p.pid for p in multiprocessing.active_children()
            if p.name.startswith("sketch-worker")]
    if left:
        fail(f"rpc cluster: worker processes {left} outlived close()")


def _worker_launches(cl, acc, need, device):
    """Add each live worker process's kernel launch counts (its ``K_STATS``
    reply) to ``acc``; on the card each must have launched ``need``."""
    for w, eng in enumerate(cl.workers):
        if w in cl._dead:
            continue
        got = eng.stats()["launches"]
        for k in acc:
            acc[k] += got[k]
        missing = [k for k in need if got[k] <= 0]
        if device.type == "cuda" and missing:
            fail(f"rpc worker {w}: its process never launched {missing}")


def _timed_rpc_merge(cl, device):
    """Ms to pull every worker's snapshot over its channel onto the card,
    and ms to fold them on the coordinator."""
    t0 = time.perf_counter()
    states = [w.snapshot()[0] for w in cl.workers]
    sync(device)
    t1 = time.perf_counter()
    if len(states) > 1:
        cl._merge_fn(states)
    sync(device)
    return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def _same_sann_answers(name, got_cr, want_cr, got_topk, want_topk):
    """(c, r) and top-k ids exact; distances within the scorer's
    tolerance (fp32 sums in another order)."""
    import numpy as np
    for f in ("index", "found", "n_candidates"):
        if not np.array_equal(getattr(got_cr, f), getattr(want_cr, f)):
            fail(f"{name}: (c, r) {f} differs")
    if not np.array_equal(got_topk[0], want_topk[0]):
        fail(f"{name}: top-{TOPK} ids differ")
    for g, w in ((got_cr.distance, want_cr.distance),
                 (got_topk[1], want_topk[1])):
        if not np.allclose(g, w, rtol=RTOL, atol=ATOL):
            fail(f"{name}: distances outside rtol {RTOL}, atol {ATOL}")


def rpc_frame_cap(cfg, shost, rc, device):
    """An S-ANN RPC cluster at K = 2 whose worker snapshot is larger than
    the protocol's frame cap: the first merge must be refused by the
    worker, naming the cap, well inside the RPC timeout."""
    from repro_torch.net import cluster as rpc
    from repro_torch.net import protocol
    with _rpc_open(lambda: rpc.RPCClusterRetrievalService(
            cfg, num_workers=2, merge_every=RPC_MERGE_EVERY, rpc=rc,
            device=device)) as (cl, start_s):
        cl.ingest(shost[:CHUNK])
        t0 = time.perf_counter()
        try:
            cl.merged_state()
        except protocol.RemoteError as e:
            refusal = str(e)
        else:
            fail("rpc retrieval: a snapshot past MAX_BODY went through")
        refuse_s = time.perf_counter() - t0
        if "MAX_BODY" not in refusal or refuse_s >= rc.rpc_timeout_s:
            fail(f"rpc retrieval: the frame cap's refusal ({refuse_s:.1f} s)"
                 f" does not name the cap: {refusal}")
        snap_mb = _state_bytes(cl._template.state) / 1e6
    return {"K": 2, "n_max": cfg.n_max, "start_s": start_s,
            "snapshot_mb_per_worker": snap_mb, "refused_after_s": refuse_s,
            "refusal": refusal[:300]}


def phase_rpc_cluster(cluster_run, device, workers=CLUSTER_WORKERS,
                      sann_nmax=RPC_SANN_NMAX, cap_nmax=RPC_CAP_NMAX):
    """The multi-process cluster (`repro_torch.net`): every worker a
    spawned process with its own CUDA context on the one card, the
    coordinator the in-process cluster's with `RemoteEngine` proxies,
    each chunk one RPC, each merge every worker's snapshot over TCP.  On
    the `cluster` phase's streams and configurations, fed the same way:

    * `RPCClusterRACEService` at K = 1, 2, 4 (news shape, SRP): merged
      counters and answers equal the in-process cluster's at the same K;
    * `RPCClusterKDEService` at K = 4 (eps 0.01, worker windows 65 536 /
      K): the gate stream, then the rest, each equal to the in-process
      cluster's state and answers;
    * `RPCClusterRetrievalService` at K = 4, SIFT shape, n_max 250 000 a
      worker (a snapshot must fit the protocol's 256 MiB frame): state,
      (c, r) and top-50 ids equal the in-process cluster's at the same
      configuration, distances within the scorer's tolerance; at K = 2 and
      n_max 1 000 000 the first snapshot must be refused, naming the cap;
    * durable RACE at K = 2: a ``net.send`` drop retried in place, every
      worker stopped and a fresh cluster recovered; worker 1 SIGKILLed
      mid-stream and respawned (bit-exact), and with ``respawn=False``
      declared dead and salvaged (the merge still one service's).

    Each worker's process must launch its commit kernels on the card, and
    no worker process may outlive its cluster's ``close()``."""
    import dataclasses
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.net import cluster as rpc
    from repro_torch.net import protocol
    from repro_torch.persist import faults
    from repro_torch.serve import cluster, race_service

    khost, kqs = cluster_run["khost"], cluster_run["kqs"]
    shost, qs = cluster_run["shost"], cluster_run["qs"]
    ccfg, n_race = cluster_run["ccfg"], cluster_run["n_race"]
    rc = rpc.RPCConfig(rpc_timeout_s=RPC_TIMEOUT_S)
    out = {"phase": "rpc_cluster", "workers": list(workers),
           "call_rows": SERVICE_CALL_ROWS, "rpc_timeout_s": RPC_TIMEOUT_S,
           "max_body": protocol.MAX_BODY}
    coord = {k: 0 for k in ops.LAUNCHES}        # the coordinator's launches
    in_workers = {k: 0 for k in ops.LAUNCHES}   # the worker processes'

    # --- RACE at the news shape, K = 1, 2, 4 ------------------------------
    rows = []
    for K in workers:
        with _rpc_open(lambda: rpc.RPCClusterRACEService(
                ccfg, num_workers=K, merge_every=8, rpc=rc,
                device=device)) as (cl, start_s):
            ops.reset_launches()
            secs = _cluster_feed(cl, khost[:n_race], device)
            pull_ms, fold_ms = _timed_rpc_merge(cl, device)
            got = cl.query(kqs)
            q_rate = _timed_queries(cl.query, kqs, device)
            _add_launches(coord)
            _worker_launches(cl, in_workers, ("srp_hash", "race_hist"),
                             device)
            want_state, want = cluster_run["race"][K]
            _same_state(f"rpc race K={K}", inprocess=want_state,
                        rpc=cl.merged_state())
            _same_answers(f"rpc race K={K}", got, want)
        rows.append({"K": K, "points": n_race, "start_s": start_s,
                     "ingest_s": secs, "points_per_s": n_race / secs,
                     "snapshot_pull_ms": pull_ms, "merge_fold_ms": fold_ms,
                     "queries_per_s": q_rate,
                     "equals_inprocess_cluster": True})
    out["race"] = rows

    # --- SW-AKDE at the news shape, eps 0.01, K = 4 -----------------------
    K = max(workers)
    n_kde, n_long = cluster_run["n_kde"], khost.shape[0]
    kcfg = dataclasses.replace(cluster_run["kcfg"],
                               window=CLUSTER_KDE_WINDOW // K)
    with _rpc_open(lambda: rpc.RPCClusterKDEService(
            kcfg, num_workers=K, merge_every=RPC_MERGE_EVERY, rpc=rc,
            device=device)) as (cl, start_s):
        ops.reset_launches()
        secs = _cluster_feed(cl, khost[:n_kde], device)
        want_state, want = cluster_run["kde"][K]["gate"]
        _same_state(f"rpc kde K={K} gate stream", inprocess=want_state,
                    rpc=cl.merged_state())
        _same_answers(f"rpc kde K={K} gate stream", cl.query(kqs), want)
        secs_long = _cluster_feed(cl, khost[n_kde:n_long], device)
        pull_ms, fold_ms = _timed_rpc_merge(cl, device)
        got = cl.query(kqs)
        q_rate = _timed_queries(cl.query, kqs, device)
        _add_launches(coord)
        _worker_launches(cl, in_workers, ("srp_hash", "swakde_segment_pass"),
                         device)
        want_state, want = cluster_run["kde"][K]["end"]
        _same_state(f"rpc kde K={K}", inprocess=want_state,
                    rpc=cl.merged_state())
        _same_answers(f"rpc kde K={K}", got, want)
        snap_mb = _state_bytes(cl._template.state) / 1e6
    out["kde"] = {"K": K, "worker_window": CLUSTER_KDE_WINDOW // K,
                  "eh_eps": kcfg.eh_eps, "start_s": start_s,
                  "points_gate": n_kde, "ingest_s_gate": secs,
                  "points_long": n_long - n_kde, "ingest_s_long": secs_long,
                  "points_per_s": (n_long - n_kde) / secs_long,
                  "snapshot_mb_per_worker": snap_mb,
                  "snapshot_pull_ms": pull_ms, "merge_fold_ms": fold_ms,
                  "queries_per_s": q_rate, "equals_inprocess_cluster": True}

    # --- S-ANN at the SIFT shape, n_max 250 000 a worker, K = 4 -----------
    scfg = dataclasses.replace(cluster_run["rcfg"], n_max=sann_nmax)
    inproc = cluster.ClusterRetrievalService(
        scfg, num_workers=K, merge_every=RPC_MERGE_EVERY, device=device)
    in_secs = _cluster_feed(inproc, shost, device)
    want_state = inproc.merged_state()
    want_cr, want_topk = inproc.query(qs), inproc.query_topk(qs)
    inproc.close()
    del inproc
    with _rpc_open(lambda: rpc.RPCClusterRetrievalService(
            scfg, num_workers=K, merge_every=RPC_MERGE_EVERY, rpc=rc,
            device=device)) as (cl, start_s):
        ops.reset_launches()
        secs = _cluster_feed(cl, shost, device)
        pull_ms, fold_ms = _timed_rpc_merge(cl, device)
        got_state = cl.merged_state()
        got_cr, got_topk = cl.query(qs), cl.query_topk(qs)
        cr_rate = _timed_queries(cl.query, qs, device)
        topk_rate = _timed_queries(cl.query_topk, qs, device)
        _add_launches(coord)
        _worker_launches(cl, in_workers, ("sann_table_scatter",), device)
        _same_state(f"rpc retrieval K={K}", inprocess=want_state,
                    rpc=got_state)
        _same_sann_answers(f"rpc retrieval K={K}", got_cr, want_cr,
                           got_topk, want_topk)
        snap_mb = _state_bytes(cl._template.state) / 1e6
        n_stored = int(got_state.n_stored)
    del want_state, got_state
    out["retrieval"] = {"K": K, "n_max": sann_nmax, "points": shost.shape[0],
                        "start_s": start_s, "ingest_s": secs,
                        "points_per_s": shost.shape[0] / secs,
                        "inprocess_points_per_s": shost.shape[0] / in_secs,
                        "snapshot_mb_per_worker": snap_mb,
                        "snapshot_pull_ms": pull_ms, "merge_fold_ms": fold_ms,
                        "n_stored": n_stored, "cr_queries_per_s": cr_rate,
                        "topk_queries_per_s": topk_rate,
                        "equals_inprocess_cluster": True}

    out["frame_cap"] = rpc_frame_cap(
        dataclasses.replace(cluster_run["rcfg"], n_max=cap_nmax), shost, rc,
        device)

    # --- durability and failover (RACE, K = 2) ----------------------------
    part = khost[:cluster_run["n_durable"]]
    half = part.shape[0] // 2
    single = race_service.RACEService(ccfg, device=device)
    _cluster_feed(single, part, device)
    fo = cluster.FailoverConfig(max_retries=2, backoff_s=0.01)
    with tempfile.TemporaryDirectory() as tmp:
        dcfg = dataclasses.replace(ccfg, snapshot_dir=f"{tmp}/durable",
                                   snapshot_every=SERVICE_SNAPSHOT_EVERY // 4)
        plan = faults.FaultPlan([faults.FaultSpec(
            site="worker_1/net.send", mode="drop", hit=2)])
        with _rpc_open(lambda: rpc.RPCClusterRACEService(
                dcfg, num_workers=2, failover=fo, rpc=rc,
                device=device)) as (cl, start_s):
            ops.reset_launches()
            with faults.installed(plan):
                t_dur = _cluster_feed(cl, part, device)
            _add_launches(coord)
            _worker_launches(cl, in_workers, ("srp_hash", "race_hist"),
                             device)
            h = cl.health()
            if not plan.fired or h["counters"]["retries"] < 1 \
                    or h["counters"]["recoveries"]:
                fail(f"rpc race: the net.send drop was not retried in place "
                     f"({h['counters']})")
            want = cl.merged_state()
        with _rpc_open(lambda: rpc.RPCClusterRACEService(
                dcfg, num_workers=2, rpc=rc, device=device)) as (cl, _):
            t0 = time.perf_counter()
            replayed = cl.recover()
            t_rec = time.perf_counter() - t0
            _same_state("rpc race durable", live=want,
                        recovered=cl.merged_state(), single=single.state)
        out["durable"] = {"K": 2, "points": part.shape[0], "start_s": start_s,
                          "points_per_s_durable": part.shape[0] / t_dur,
                          "send_drops_retried": h["counters"]["retries"],
                          "recovered_records": replayed, "recovery_s": t_rec}

        for name, respawn in (("respawn", True), ("salvage", False)):
            kcfg2 = dataclasses.replace(
                ccfg, snapshot_dir=f"{tmp}/{name}",
                snapshot_every=(SERVICE_SNAPSHOT_EVERY // 4 if respawn
                                else 10**6))
            fo2 = fo if respawn else cluster.FailoverConfig(
                on_degraded="partial", max_retries=1, backoff_s=0.001)
            with _rpc_open(lambda: rpc.RPCClusterRACEService(
                    kcfg2, num_workers=2, failover=fo2, device=device,
                    rpc=dataclasses.replace(rc, respawn=respawn))) as (cl, _):
                ops.reset_launches()
                _cluster_feed(cl, part[:half], device)
                victim = cl._procs[1]
                victim.kill()                   # SIGKILL, no goodbye
                victim.join(10.0)
                t0 = time.perf_counter()
                _cluster_feed(cl, part[half:], device)
                t_fail = time.perf_counter() - t0
                _add_launches(coord)
                _worker_launches(cl, in_workers, ("srp_hash", "race_hist"),
                                 device)
                h = cl.health()
                if respawn and (h["counters"]["recoveries"] < 1
                                or h["dead_workers"]
                                or cl._procs[1].pid == victim.pid):
                    fail(f"rpc race: worker 1 was not respawned ({h})")
                if not respawn and (h["dead_workers"] != [1]
                                    or h["salvage_complete"] != [1]):
                    fail(f"rpc race: worker 1 was not salvaged ({h})")
                _same_state(f"rpc race after worker 1's SIGKILL ({name})",
                            unkilled=want, single=single.state,
                            merged=cl.merged_state())
            out[name] = {"K": 2, "points": part.shape[0],
                         "killed_after_points": half,
                         "second_half_s": t_fail,
                         "recoveries": h["counters"]["recoveries"],
                         "dead_workers": h["dead_workers"],
                         "salvaged_rows": h["counters"]["salvaged_rows"]}
    single.close()
    launches = {k: coord[k] + in_workers[k] for k in coord}
    emit({**out, "coordinator_launches": coord,
          "worker_launches": in_workers})
    return {"launches": launches}


# --------------------------------------------------------------------------
# phase 5: where the time goes (torch.profiler over short main-path windows)
# --------------------------------------------------------------------------

def profile_window(name, fn, device, top=10):
    """Profile ``fn()`` once (after one warm-up call): wall time, the summed
    device time of all kernels and copies, the device's busy share, the
    number of device ops launched, the host's waits on the device and its
    copies to the device, and the device ops (kernels by symbol) with the
    most time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    # _device_us counts device-side events only (kernels, copies, fills): a
    # CPU op's own device time would count its kernels twice
    events = prof.key_averages()
    rows = [(e.key, _device_us(e), e.count) for e in events]
    rows = [r for r in rows if r[1] > 0]
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    # the window's closing synchronize is one of the host waits
    waits = sum(e.count for e in events if e.key in SYNC_EVENTS)
    row = {"phase": "profile", "window": name, "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / wall_us if wall_us else None,
          "device_ops": sum(r[2] for r in rows),
          "host_waits": waits,
          # copies by name, whether or not the profiler gave them a time
          "copies_to_device": sum(e.count for e in events if "HtoD" in e.key),
          "top_device_ops": [{"op": k[:80], "ms": us / 1e3, "calls": c}
                             for k, us, c in rows[:top]]}
    emit(row)
    return row


def phase_profile(sann_run, kde_run, srp_run, serve_run, services_run, device,
                  n_chunks=4):
    from repro_torch.core import prng, race, sann, swakde
    s, k = sann_run, kde_run
    qs = s["queries"][:QUERY_BLOCK]
    kq = k["data"][:QUERY_BLOCK]

    def sann_ingest():
        st = s["state"]
        for i in range(n_chunks):
            st = sann.sann_insert_batch(st, s["params"],
                                        s["data"][i * CHUNK:(i + 1) * CHUNK],
                                        s["key"], s["cfg"])

    def sann_queries():
        sann.sann_query_batch(s["state"], s["params"], qs, s["cfg"])
        sann.sann_query_topk_batch(s["state"], s["params"], qs, s["cfg"], TOPK)

    def kde_ingest():
        st = k["state"]
        rc = race.race_init(k["cfg"].L, k["cfg"].W, device)
        for i in range(n_chunks):
            x = k["data"][i * CHUNK:(i + 1) * CHUNK]
            st = swakde.swakde_update_chunk(st, k["params"], x, k["cfg"])
            rc = race.race_update_batch(rc, k["params"], x)

    def kde_queries():
        swakde.swakde_query_batch(k["state"], k["params"], kq, k["cfg"])
        race.race_query_batch(race.race_init(k["cfg"].L, k["cfg"].W, device),
                              k["params"], kq)

    def srp_ingest():
        st = srp_run["state"]
        for i in range(n_chunks):
            x = srp_run["data"][i * CHUNK:(i + 1) * CHUNK]
            st = swakde.swakde_update_chunk(st, srp_run["params"], x,
                                            srp_run["cfg"])

    def sann_service_ingest():
        # the same 4 chunks from the host through a volatile
        # RetrievalService: one ingest_async call, then flush
        services_run["retrieval"].ingest(
            services_run["host"][:n_chunks * CHUNK])

    def sann_keep_draws():
        # the threefry keep draws of `sann_ingest`'s 4 chunks alone
        for _ in range(n_chunks):
            prng.bernoulli(sann.sann_row_keys(s["key"], CHUNK),
                           s["cfg"].keep_prob)

    def sann_oracle_queries():
        for q in qs[:64]:
            sann.sann_query(s["state"], s["params"], q, s["cfg"])

    def lm_decode_step():
        # one more token for lm_serve's 4 requests (their cache has room)
        r = serve_run
        logits, r["cache"] = r["step"](r["params"], r["cache"], r["tok"])
        r["tok"] = logits.argmax(-1)

    for name, fn in (("sann_ingest_4_chunks", sann_ingest),
                     ("sann_service_ingest_4_chunks", sann_service_ingest),
                     ("sann_keep_draws_4_chunks", sann_keep_draws),
                     ("sann_query_block_2048", sann_queries),
                     ("swakde_race_ingest_4_chunks", kde_ingest),
                     ("swakde_race_query_block_2048", kde_queries),
                     ("srp_swakde_ingest_4_chunks", srp_ingest),
                     ("sann_query_oracle_64", sann_oracle_queries),
                     ("lm_serve_decode_step", lm_decode_step)):
        row = profile_window(name, fn, device)
        # the SW-AKDE commit drains on the device: only the window's
        # closing synchronize waits (2 events, the floor of every window)
        if "swakde" in name and "ingest" in name and row["host_waits"] != 2:
            fail(f"profile window {name}: {row['host_waits']} host waits, "
                 f"expected 2 (the commit must not sync the host)")
        # the service waits once a commit (its pacing), as the reference's
        # block_until_ready does, and no more
        if "service" in name and row["host_waits"] > 2 + n_chunks:
            fail(f"profile window {name}: {row['host_waits']} host waits for "
                 f"{n_chunks} commits")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")

    phase_device()
    sann_run = phase_sann(args.seed, device)
    kde_run = phase_kde(args.seed, device)
    srp_run = phase_srp_kde(args.seed, kde_run, device)
    oracle_launches = phase_sann_oracles(sann_run, device)
    phase_kde_oracles(srp_run, device)
    phase_lm_cross_check(args.seed, device)
    serve_run = phase_lm_serve(args.seed, device)
    phase_lm_long(args.seed, serve_run, device)
    launches = {**{k: sann_run["launches"][k] for k in
                   ("sann_table_scatter", "batch_score_topk")},
                **{k: kde_run["launches"][k] for k in
                   ("race_hist", "swakde_segment_pass")},
                "srp_hash": srp_run["launches"]["srp_hash"],
                "cand_score": oracle_launches["cand_score"],
                "sketch_decode_attn": serve_run["launches"]["sketch_decode_attn"]}
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    rows = [check_srp_hash(srp_run, device),
            check_race_hist(kde_run, device),
            *check_cand_score(sann_run, device),
            *check_batch_score_topk(sann_run, device),
            check_swakde_segment_pass(kde_run, device),
            check_swakde_many_slots(kde_run, device, SLOTS_EPS, SLOTS_WARM,
                                    SLOTS_CROSS),
            check_swakde_many_slots(kde_run, device, BIG_CELL_EPS, SLOTS_WARM,
                                    BIG_CELL_CROSS, cpu_rows=BIG_CELL_ROWS),
            *check_sann_table_scatter(sann_run, device),
            *check_sketch_decode_attn(serve_run, device)]
    for row in rows:
        emit({"phase": "kernel_check", **row})
    services_run = phase_services(args.seed, sann_run, kde_run, device)
    fleet_run = phase_fleet(args.seed, sann_run, kde_run, device)
    cluster_run = phase_cluster(args.seed, sann_run, kde_run, device)
    rpc_run = phase_rpc_cluster(cluster_run, device)
    fleet_cluster = {k: fleet_run["launches"][k] + cluster_run["launches"][k]
                     for k in launches}
    del cluster_run
    phase_profile(sann_run, kde_run, srp_run, serve_run, services_run, device)
    services_run["retrieval"].close()
    summary = []
    for row in rows:
        if row["name"] == "batch_score_topk" and (
                row["shape"][-1] == 1 or row["entry"] == "batch_score_topk"):
            continue        # the (c, r) shape and the (B, M, d) entry; in
                            # their kernel_check lines
        if row.get("eh_slots"):
            continue        # the 52- and 5002-slot commits; in their
                            # kernel_check lines
        if row["name"] == "cand_score" and row["shape"][0] == 3 * sann_run["cfg"].L:
            continue        # the 3L shape; reported in its kernel_check line
        if row["name"] == "sketch_decode_attn" and row["case"] != "lm_serve":
            continue        # the long-context shapes; in their kernel_check lines
        if row.get("entry") == "sann_table_scatter":
            continue        # the in-place append alone; the main path's entry
                            # is the commit (`sann_table_commit`)
        summary.append({
            "name": row["name"], "route": "cuda", "source": SOURCES[row["name"]],
            "replaces": REPLACES[row["name"]], "launches": launches[row["name"]],
            "services_launches": services_run["launches"].get(row["name"], 0),
            "fleet_cluster_launches": fleet_cluster[row["name"]],
            "rpc_cluster_launches": rpc_run["launches"][row["name"]],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"], "shape": row["shape"],
            **{k: row[k] for k in ("flips_at_sign_boundaries", "codes",
                                   "entry", "library", "library_device_ms",
                                   "library_graph_ms",
                                   "matmul_only_ms", "matmul_only_device_ms",
                                   "matmul_only_graph_ms", "graph_ms", "pass_graph_ms",
                                   "tensor_core_bound_ms", "kernel_device_ms",
                                   "pass_ms", "pass_device_ms", "pass_bound_ms",
                                   "launches_per_call", "device_ops_per_call",
                                   "live_entries", "distinct_rows",
                                   "old_path_ms", "old_path_graph_ms")
               if k in row}})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
