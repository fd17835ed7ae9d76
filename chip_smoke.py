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
  copy of the weights).

Keep decisions come from a threefry key on each device.  Kernel launch
counts are zeroed just before each path and read just after.  Each path's
first 8 chunks are re-run on the CPU (the kernels' plain versions) with the
same codes, and with keep masks the CPU draws itself from the same key, and
must give bit-identical state.  Then every kernel is held against its plain
PyTorch version on the card at the main path's shapes and timed beside it
(and beside the one PyTorch call that computes the same function, where
there is one; for the S-ANN table commit, beside the plain PyTorch
sequence it replaced).

Prints one JSON line per phase, the ``{"kernels": [...]}`` summary, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
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

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores

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


KERNEL_SYMBOLS = {"race_hist": "race_hist_smem",
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
    passes = launches["swakde_segment_pass"]
    emit({"phase": "swakde_race", "points": n, "queries": n_queries,
          "dim": KDE_DIM, "L": L, "W": W, "window": window,
          "eh_levels": eh.levels, "eh_slots": eh.slots, "hash_k": kp, "w": w,
          "swakde_ingest_s": t_sw, "swakde_points_per_s": n / t_sw,
          "race_ingest_s": t_rc, "race_points_per_s": n / t_rc,
          "swakde_query_s": t_swq, "swakde_queries_per_s": n_queries / t_swq,
          "race_query_s": t_rcq, "race_queries_per_s": n_queries / t_rcq,
          "segment_passes": passes, "passes_per_chunk": passes / n_chunks,
          "host_syncs_in_commit": passes + n_chunks,
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

def check_race_hist(kde, device):
    import torch
    from repro_torch.core import lsh
    from repro_torch.kernels import race_update, ref
    W = kde["cfg"].W
    codes = lsh.hash_points(kde["params"], kde["data"][:CHUNK]).contiguous()
    B, L = codes.shape
    got = race_update.race_hist(codes, W)
    want = ref.race_hist_ref(codes, W)
    err = int((got - want).abs().max())
    if err != 0:
        fail("race_hist differs from its plain version")
    flat = (codes.long() + torch.arange(L, device=device) * W).reshape(-1)
    b_ms, b_by = bound(B * L * 4 + L * W * 4)
    return {"name": "race_hist", "shape": [B, L, W], "max_abs_err": err,
            "ms": time_ms(lambda: race_update.race_hist(codes, W), 50, device),
            "device_ms": device_ms(lambda: race_update.race_hist(codes, W),
                                   "race_hist", device),
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
    import torch
    from repro_torch.core import sann
    from repro_torch.kernels import batch_score, ref
    cfg, params, state = sann_run["cfg"], sann_run["params"], sann_run["state"]
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
    vecs1 = state.points[sel_cand.clamp(min=0).long()]
    # top-k path: the deduplicated bucket union, k = 50
    mask = ok & sann._first_occurrence_mask(cand, cfg.capacity)
    vecs2 = state.points[cand.clamp(min=0).long()]
    for vecs, okm, k in ((vecs1, sel_ok, 1), (vecs2, mask, TOPK)):
        B, M, d = vecs.shape
        d_k, i_k = batch_score.batch_score_topk(qs, vecs, okm, k)
        d_r, i_r = ref.batch_score_topk_ref(qs, vecs, okm, k)
        full = torch.where(okm, ref.batch_score_ref(qs, vecs), float("inf"))
        err, mism = topk_err(d_k, i_k, d_r, i_r, full)
        b_ms, b_by = bound(B * d * 4 + B * M * d * 4 + B * M + B * k * 8,
                           3.0 * B * M * d)
        rows.append({
            "name": "batch_score_topk", "shape": [B, M, d, k],
            "max_abs_err": err, "id_mismatches_at_near_ties": mism,
            "ms": time_ms(lambda: batch_score.batch_score_topk(qs, vecs, okm, k),
                          50, device),
            "device_ms": device_ms(lambda: batch_score.batch_score_topk(
                qs, vecs, okm, k), "batch_score_topk", device),
            "plain_ms": time_ms(lambda: ref.batch_score_topk_ref(qs, vecs, okm, k),
                                10, device),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
    return rows


def check_swakde_segment_pass(kde, device):
    """Drain one chunk on the state at the end of the stream (stamps cross
    the window, so passes split at expiry): every pass bit-exact."""
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
    R, G, LV, S = first[0].shape
    consumed = int((ingest_commit.swakde_segment_pass(*first, *fixed, **kw)[2]
                    - first[2]).sum())
    active = int((first[2] < prep.seg_len).sum())
    ring = R * G * LV * S * 4 + R * G * LV * 4
    b_ms, b_by = bound(2 * ring + 4 * R * G * 4 + (consumed + active) * 4)
    return {"name": "swakde_segment_pass", "shape": [R, G, LV, S, sorted_ts.shape[1]],
            "passes_to_drain": passes, "max_abs_err": err,
            "ms": time_ms(lambda: ingest_commit.swakde_segment_pass(
                *first, *fixed, **kw), 50, device),
            "device_ms": device_ms(lambda: ingest_commit.swakde_segment_pass(
                *first, *fixed, **kw), "swakde_segment_pass", device),
            "plain_ms": time_ms(lambda: ref.swakde_segment_pass_ref(
                *first, *fixed, **kw), 10, device),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


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
    b_ms, b_by = bound(B * d * 4 + d * LK * 4 + mix.numel() * 8 + B * params.L * 4,
                       2.0 * B * d * LK)
    return {"name": "srp_hash", "shape": [B, d, LK], "max_abs_err": err,
            "flips_at_sign_boundaries": flips, "codes": B * params.L,
            "ms": time_ms(lambda: srp_hash.srp_hash(x, proj, mix, nb), 100, device),
            "device_ms": device_ms(lambda: srp_hash.srp_hash(x, proj, mix, nb),
                                   "srp_hash", device),
            "plain_ms": time_ms(lambda: ref.srp_hash_ref(x, proj, mix, nb), 50,
                                device),
            "library_ms": None, "library": "none (no single call)",
            "matmul_only_ms": time_ms(lambda: x @ proj, 100, device),
            "bound_ms": b_ms, "bound_by": b_by}


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
        library_ms = library_device_ms = None
        if softcap == 0.0 and n_pos:
            ql = q.reshape(B, Hkv * G, 1, dh)
            kl, vl = k.transpose(1, 2), v.transpose(1, 2)
            mask = pos_live[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, enable_gqa=True)
            library_ms = time_ms(sdpa, 10, device)
            library_device_ms = device_ms_all(sdpa, device, 10)
        rows.append({
            "name": "sketch_decode_attn", "case": name,
            "shape": [B, S, Hkv, G, dh], "kv_len": kv_len, "softcap": softcap,
            "live_blocks": int(live.sum()), "live_positions": n_pos,
            "max_abs_err": err, "tolerance": [SDA_RTOL, SDA_ATOL],
            "ms": time_ms(call, 20, device),
            "device_ms": device_ms(call, "sketch_decode_attn", device),
            "plain_ms": time_ms(lambda: ref.sketch_decode_attn_ref(
                q, k, v, live, kv_len, LM_BLOCK, softcap), 3, device),
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "library": "F.scaled_dot_product_attention(attn_mask, enable_gqa) "
                       "over the whole cache",
            "bound_ms": b_ms, "bound_by": b_by})
    return rows


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
    waits = sum(e.count for e in events if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"))
    emit({"phase": "profile", "window": name, "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / wall_us if wall_us else None,
          "device_ops": sum(r[2] for r in rows),
          "host_waits": waits,
          "copies_to_device": sum(r[2] for r in rows if "HtoD" in r[0]),
          "top_device_ops": [{"op": k[:80], "ms": us / 1e3, "calls": c}
                             for k, us, c in rows[:top]]})


def phase_profile(sann_run, kde_run, srp_run, serve_run, device, n_chunks=4):
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
                     ("sann_keep_draws_4_chunks", sann_keep_draws),
                     ("sann_query_block_2048", sann_queries),
                     ("swakde_race_ingest_4_chunks", kde_ingest),
                     ("swakde_race_query_block_2048", kde_queries),
                     ("srp_swakde_ingest_4_chunks", srp_ingest),
                     ("sann_query_oracle_64", sann_oracle_queries),
                     ("lm_serve_decode_step", lm_decode_step)):
        profile_window(name, fn, device)


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
            *check_sann_table_scatter(sann_run, device),
            *check_sketch_decode_attn(serve_run, device)]
    for row in rows:
        emit({"phase": "kernel_check", **row})
    phase_profile(sann_run, kde_run, srp_run, serve_run, device)
    summary = []
    for row in rows:
        if row["name"] == "batch_score_topk" and row["shape"][-1] == 1:
            continue        # the (c, r) shape; reported in its kernel_check line
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
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"], "shape": row["shape"],
            **{k: row[k] for k in ("flips_at_sign_boundaries", "codes",
                                   "entry", "library", "library_device_ms")
               if k in row}})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
