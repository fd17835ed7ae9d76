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
  10 000 queries through ``swakde_query_batch`` and ``race_query_batch``.

Kernel launch counts are zeroed just before each path and read just after.
Each path's first 8 chunks are re-run on the CPU (the kernels' plain
versions) with the same keep masks and codes, and must give bit-identical
state.  Then every kernel is held against its plain PyTorch version on the
card at the main path's shapes and timed beside it (and beside the one
PyTorch call that computes the same function, where there is one).

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

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores

# file:line of the TPU kernel each CUDA kernel replaces
REPLACES = {
    "race_hist": "src/repro/kernels/race_update.py:41",
    "sann_table_scatter": "src/repro/kernels/ingest_commit.py:135",
    "batch_score_topk": "src/repro/kernels/batch_score.py:73",
    "swakde_segment_pass": "src/repro/kernels/ingest_commit.py:57",
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
                  "sann_table_scatter": "sann_table_scatter_kernel",
                  "batch_score_topk": "batch_score_topk_kernel",
                  "swakde_segment_pass": "swakde_segment_pass_kernel"}


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
    from repro_torch.core import lsh, sann
    from repro_torch.kernels import ops

    gen = torch.Generator(device=device).manual_seed(seed)
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
    state = sann.sann_insert_chunked(state, params, data, gen, cfg,
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

    # --- cross-check: the first chunks re-run on the CPU, same keep/codes ---
    g2 = torch.Generator(device=device).manual_seed(seed + 1)
    params_cpu = convert.params_from_numpy(convert.to_numpy(params), "cpu")
    st_dev = sann.sann_empty_state(cfg, device)
    st_cpu = sann.sann_empty_state(cfg, "cpu")
    for i in range(CROSS_CHUNKS):
        x = data[i * CHUNK:(i + 1) * CHUNK]
        prep = sann.sann_prepare_chunk(params, x, g2, cfg)
        st_dev = sann.sann_commit_chunk(st_dev, prep, cfg)
        codes = lsh.hash_points(params, x)
        prep_cpu = sann.sann_prepare_given_keep(
            params_cpu, x.cpu(), prep.keep.cpu(), cfg, codes=codes.cpu())
        st_cpu = sann.sann_commit_chunk(st_cpu, prep_cpu, cfg)
    bad = differing_leaves(st_dev, st_cpu)
    emit({"phase": "sann_cross_check", "chunks": CROSS_CHUNKS,
          "n_stored": int(st_cpu.n_stored), "bit_identical": not bad,
          "differing": bad})
    if bad:
        fail(f"S-ANN device/CPU state differs in {bad}")
    del st_dev, st_cpu
    return dict(cfg=cfg, params=params, state=state, queries=queries,
                data=data, gen=gen, launches=launches)


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
                launches=launches)


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
    import torch
    from repro_torch.core import sann
    from repro_torch.kernels import ingest_commit, ref
    cfg, params, state = sann_run["cfg"], sann_run["params"], sann_run["state"]
    prep = sann.sann_prepare_chunk(params, sann_run["queries"][:CHUNK],
                                   sann_run["gen"], cfg)
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
    return {"name": "sann_table_scatter", "shape": [L, NB, cap, E],
            "masked": n_masked, "max_abs_err": err,
            "ms": time_ms(lambda: ingest_commit.sann_table_scatter(tab_k, *args),
                          50, device),
            "device_ms": device_ms(lambda: ingest_commit.sann_table_scatter(
                tab_k, *args), "sann_table_scatter", device),
            "plain_ms": time_ms(lambda: ref.sann_table_scatter_ref(tab_r, *args),
                                20, device),
            "library_ms": time_ms(lambda: tab_l.view(-1).index_put_(
                (flat,), vals), 50, device),
            "bound_ms": b_ms, "bound_by": b_by,
            "library": "Tensor.index_put_"}


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
    passes = 0
    while bool((carry[2] < prep.seg_len).any()):
        got = ingest_commit.swakde_segment_pass(*carry, *fixed, **kw)
        want = ref.swakde_segment_pass_ref(*carry, *fixed, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
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
            "passes_to_drain": passes, "max_abs_err": 0,
            "ms": time_ms(lambda: ingest_commit.swakde_segment_pass(
                *first, *fixed, **kw), 50, device),
            "device_ms": device_ms(lambda: ingest_commit.swakde_segment_pass(
                *first, *fixed, **kw), "swakde_segment_pass", device),
            "plain_ms": time_ms(lambda: ref.swakde_segment_pass_ref(
                *first, *fixed, **kw), 10, device),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


# --------------------------------------------------------------------------
# phase 5: where the time goes (torch.profiler over short main-path windows)
# --------------------------------------------------------------------------

def profile_window(name, fn, device, top=10):
    """Profile ``fn()`` once (after one warm-up call): wall time, the summed
    device time of all kernels and copies, the device's busy share, and the
    device ops (kernels by symbol) with the most time."""
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
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    emit({"phase": "profile", "window": name, "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / wall_us if wall_us else None,
          "top_device_ops": [{"op": k[:80], "ms": us / 1e3, "calls": c}
                             for k, us, c in rows[:top]]})


def phase_profile(sann_run, kde_run, device, n_chunks=4):
    from repro_torch.core import race, sann, swakde
    s, k = sann_run, kde_run
    qs = s["queries"][:QUERY_BLOCK]
    kq = k["data"][:QUERY_BLOCK]

    def sann_ingest():
        st = s["state"]
        for i in range(n_chunks):
            st = sann.sann_insert_batch(st, s["params"],
                                        s["data"][i * CHUNK:(i + 1) * CHUNK],
                                        s["gen"], s["cfg"])

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

    for name, fn in (("sann_ingest_4_chunks", sann_ingest),
                     ("sann_query_block_2048", sann_queries),
                     ("swakde_race_ingest_4_chunks", kde_ingest),
                     ("swakde_race_query_block_2048", kde_queries)):
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
    launches = {**{k: sann_run["launches"][k] for k in
                   ("sann_table_scatter", "batch_score_topk")},
                **{k: kde_run["launches"][k] for k in
                   ("race_hist", "swakde_segment_pass")}}
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    rows = [check_race_hist(kde_run, device),
            check_sann_table_scatter(sann_run, device),
            *check_batch_score_topk(sann_run, device),
            check_swakde_segment_pass(kde_run, device)]
    for row in rows:
        emit({"phase": "kernel_check", **row})
    phase_profile(sann_run, kde_run, device)
    summary = []
    for row in rows:
        if row["name"] == "batch_score_topk" and row["shape"][-1] == 1:
            continue        # the (c, r) shape; reported in its kernel_check line
        summary.append({
            "name": row["name"], "route": "cuda", "source": SOURCES[row["name"]],
            "replaces": REPLACES[row["name"]], "launches": launches[row["name"]],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"], "shape": row["shape"]})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
