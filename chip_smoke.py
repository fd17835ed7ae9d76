#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]            # one card, every phase
    python3 chip_smoke.py --cards 4             # the sharding phase on four
    python3 chip_smoke.py --only train          # the training phase alone
    python3 chip_smoke.py --only lm_serve       # gemma3-4b decode on one card
    python3 chip_smoke.py --only lm_families    # the other families' decode
    python3 chip_smoke.py --only train_families # the other families' training
    python3 chip_smoke.py --only lm_mesh        # LM training on a 2 x 2 mesh
    python3 chip_smoke.py --only lm_mesh --cards 4  # ... on cards 0..3
    python3 chip_smoke.py --only lm_mesh_decode  # decode on a 2 x 2 mesh
    python3 chip_smoke.py --only lm_mesh_decode --cards 4  # ... on cards 0..3

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch/``), then drives the main path through the entry points a
user calls, at full width:

* **the training path** (first, on an empty card): gemma3-4b at its
  published width and depth (34 layers, 4.55 G parameters, random bf16
  weights from the seed) trained with AdamW on the reference's synthetic
  token stream, B = 2 x S = 4096 with per-layer remat, through
  ``make_train_step``, the drift monitor (SW-AKDE over the batches'
  embeddings: one ``srp_hash`` and one ``swakde_segment_pass`` launch a
  step, and no other kernel) before every step, for 3 steps and one
  profiled step; the monitor's codes against the CPU under the flip rule
  and its state against a CPU twin.  Then, at full width with the depth
  cut to 2 layers: the fp32 step's loss, gradients and AdamW update
  against the CPU's (TF32 off) and the bf16 step against the fp32 one
  (the ``Trainer``'s resume here is cut for time; ``train_families``
  resumes it on zamba2).  The
  flash attention ``Function`` against dense attention at gemma3-4b's
  heads (global and 1024-window layers, fp32), the embedding gather's two
  backwards run twice and timed, and attention forward + backward against
  ``scaled_dot_product_attention`` as a yardstick;
* **the other model families' batched decode** (``lm_families``, next, on
  a card that holds nothing else, one configuration at a time):
  deepseek-moe-16b (28 layers, 64 experts top-6 + 2 shared),
  deepseek-v3-671b (MLA, 256 experts top-8; cut to 5 of 61 layers: 3 dense
  + 2 MoE), zamba2-2.7b (54 Mamba2 layers in 9 groups + the shared
  attention block), xlstm-125m (6 mLSTM/sLSTM pairs), whisper-large-v3 (32
  + 32 layers; ``encode_cross_cache`` over 1500 synthetic frame embeddings,
  the stub frontend's input) and internvl2-76b (cut to 36 of 80 layers,
  sketch attention on, so every layer runs ``sketch_decode_attn`` at G =
  8, dh = 128), each at its published width in bf16 with random weights
  from the seed: B = 4 requests, 64 prompt tokens fed one a step, then 32
  greedy tokens over a 4096-token cache, through ``init_model`` →
  ``init_cache`` → ``make_serve_step``.  Logits finite and greedy ids in
  range every step, and one ``sketch_decode_attn`` launch a layer a step
  for internvl2 (its kernel also held against its plain version at that
  shape); step times, tokens/s, peak memory and one profiled step each.
  Then each at full width with its depth cut to its family's smallest unit
  in fp32: card against the CPU's plain path over 6 steps (logits, every
  cache leaf, MoE expert ids but for counted near ties; deepseek-v3's
  experts come to the CPU only where a step routes), and bf16 against
  fp32 on the card (logit cosine);
* **the other model families' training** (``train_families``, next, one
  configuration at a time on a card that holds nothing else, random bf16
  weights at published width from the seed): deepseek-moe-16b (6 of 28
  layers: 1 dense + 5 MoE, the capacity buffer and the aux loss) and
  zamba2-2.7b (all 54 Mamba2 layers and the shared block: the chunked
  SSD) through the ``Trainer`` (AdamW, the token stream, B = 2 x S =
  4096, its drift monitor checked at every batch), xlstm-125m (12 layers,
  B = 2 x S = 64) likewise, deepseek-v3-671b (4 of 61 layers, 3 dense +
  1 MoE with MLA, and the MTP block; B = 1 x S = 2048) through one
  microbatch's ``grads_and_metrics``, whisper-large-v3 (32 + 32 layers, B
  = 2, 1500 frames and 448 tokens) and internvl2-76b (2 of 80 layers, B =
  2, 256 patches + 3840 tokens) through ``make_train_step``: 2 steps and
  one profiled each, finite loss and gradient norm at every step, and no
  kernel but the monitor's one ``srp_hash`` and one ``swakde_segment_pass``
  a step.  Then each family's smallest unit at full width in fp32 (TF32
  off) on the card against the CPU's plain path (loss and every gradient
  leaf; deepseek-v3 at its smoke width), and the ``Trainer``'s resume on
  zamba2 at one group (Adam8bit), bit-identical to an unbroken run;
* **LM training on a (data, model) mesh** (``lm_mesh``, next): one card
  repeated as a 2 x 2 mesh.  fp32 (TF32 off) at full width, depth cut to
  each family's smallest unit (qwen3-4b 1 layer; deepseek-moe-16b 1 dense
  + 1 MoE, ``moe_ep``, dropless), one AdamW step (lr 1e-3, no warmup)
  sharded by ``param_specs`` against the unsharded step on the same card
  at the reference's bounds (loss 2e-4; parameters rtol 2e-4, atol 2e-5),
  every gradient leaf and the gradient norm against the unsharded ones,
  the MoE aux against the per-shard estimate; the same for the other five
  families: deepseek-v3-671b at its smoke width, 1 dense + 1 MoE layer
  (MLA split by heads, the MoE expert-parallel, the MTP head's
  cross-entropy), zamba2-2.7b's one
  group (Mamba2 split by heads, the shared block; within one bf16 ulp),
  xlstm-125m's one pair (the mLSTM split by heads), whisper-large-v3's one
  encoder and one decoder layer over 1500 frames (the cross-attention from
  each rank's encoder rows) and internvl2-76b's one layer after 256
  patches; ``moe_ep`` against ``moe_dense``
  at deepseek-moe-16b's published width (one bf16 layer); the compressed
  all-reduce's 20-step bound; then in bf16 at published width through the
  ``Trainer`` on the mesh (AdamW, the drift monitor, B = 2 x S = 4096, 2
  steps and one profiled): deepseek-moe-16b (6 of 28 layers) and
  zamba2-2.7b (2 of its 9 groups), four shards of the whole model on one
  card.  With ``--cards 4`` (cards 0..3, data 2 x model 2): the same gates
  but the compressed all-reduce's, deepseek-v3's smoke step repeated bit
  for bit and against the same mesh on one card, then deepseek-moe-16b's
  28 layers and deepseek-v3-671b at published width (3 dense + 1 MoE layer
  and the MTP head, 16.9 G parameters, Adam8bit, its 8 microbatches, B =
  16 x S = 2048, one step and one profiled), each card's peak against its
  reckoning;
* **batched decode on a (data, model) mesh** (``lm_mesh_decode``, next):
  the fp32 gates (TF32 off) of every decode branch on one card repeated
  as a 2 x 2 mesh (gemma3-4b with the sketch at B = 1, the sequence over
  (data, model); qwen3-4b at B = 4, the batch over data; internvl2-76b;
  deepseek-moe-16b (GQA, ``moe_ep``); deepseek-v3-671b's MLA at its smoke
  width; zamba2-2.7b, Mamba2 heads over model; xlstm-125m; whisper-large-v3
  with its cross cache split), each family's smallest unit at published
  width, 2 steps from a random prompt (the second into the next rank's
  block of the sequence), against the one-device step on the same card;
  ``sketch_decode_attn``'s partial entry against its plain version at the
  lm_long shape split in four and at the lm_serve shape, and
  four ranks' partials merged against the whole-cache kernel; then bf16
  at published width against one device on the same weights: gemma3-4b,
  sketch on, B = 1 over 131 072 tokens (four blocks of 32 768), 32 steps,
  every global layer's kernel launched on every rank; deepseek-moe-16b
  whole, B = 4 over 4096, 16 steps.  With ``--cards 4``: gemma3-4b at 131
  072 on cards 0..3 against one card repeated, then at the reference's
  long_500k (B = 1 x 524 288, 73 GB of cache, a quarter a card);
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
  requests of 384 prompt tokens fed one a step, then 192 greedy tokens,
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
  news width, 524 288 points) in 256 hot slots over 1024 tenants,
  spilling and reactivating, also durable and recovered; SW-AKDE
  (p-stable, eps 0.1, window 8192 a tenant, 1 048 576 points) over 256
  tenants; S-ANN (SIFT shape, n_max 65 536 a tenant, 20 480 points) in 64
  hot slots over 72 tenants, then a 2048-query block of top-50 and (c, r)
  queries.  Every tenant's row must equal its sub-stream through the
  single-sketch core loop on the card with the fleet's codes and keys, and
  every answer its own sketch's; each kind at T = 8 (re-run on the CPU)
  launches each commit kernel once an operation;
* **the in-process merge cluster** at K = 1, 2 and 4 workers on the card:
  ``ClusterRetrievalService`` (SIFT1M shape, the stream's first 524 288
  points; the merge against
  ``sann_merge`` of the workers and the canonical interleaving rule
  replayed on the CPU), ``ClusterKDEService`` (news shape, eps 0.01,
  worker windows 65 536 / K, nothing expiring: answers equal one service's)
  and ``ClusterRACEService`` (equal to one service over the stream's
  first 524 288 points), a
  durable cluster recovered, and a worker killed at a ``faults`` site and
  salvaged;
* **the RPC cluster** (``repro_torch.net``): the same clusters with each
  worker a spawned process and CUDA context of its own on the card, one
  RPC a chunk over the reference's wire format: RACE at K = 4,
  SW-AKDE at K = 4 and S-ANN at K = 4 (n_max 250 000 a worker: a worker's
  snapshot must fit the protocol's 256 MiB frame), each equal bit for bit
  to the in-process cluster on the same stream; a durable K = 2 RACE cluster
  with a dropped ``net.send`` retried in place, stopped and recovered; a
  SIGKILLed worker respawned and recovered.
  Each worker process must launch its commit kernels (its ``K_STATS``
  reply), and no worker process may outlive ``close()``;
* **sketch sharding** (``parallel/sketch_sharding.py``) on a mesh of K = 4
  shards, one card repeated (``--cards 4``: cards 0..3, after only the
  phases it reads): RACE and SW-AKDE split by rows over the news stream
  (p-stable at EH eps 0.1, SRP at eps 0.01), S-ANN by tables over the
  SIFT-shape stream (the point store replicated) and merged from two
  halves, each state equal to one device's bit for bit and each 2048-query
  block to one device's answers; the three services on the mesh, durable,
  fed 16 chunks, their snapshot files byte for byte the single-device
  service's and each recovering the other's directory; fleets split by
  tenant (RACE and SW-AKDE at T = 256, S-ANN at T = 64, 4 mixed chunks)
  equal to the unsharded fleets.  Every commit kernel launches once a
  shard a chunk, and every shard's leaves lie on their own device.

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
cell in global memory), bit-identical to it on row 0; ``race_hist``
must run as one device op a call.

Prints one JSON line per phase, the ``{"kernels": [...]}`` summary, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
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
# row 0 only
SLOTS_EPS, SLOTS_WARM, SLOTS_CROSS = 0.01, 16, 2
BIG_CELL_EPS, BIG_CELL_CROSS, BIG_CELL_ROWS = 1e-4, 1, 1
RTOL, ATOL = 1e-5, 1e-6          # fp32 summation order (scorers)
SRP_FLIP_TOL = 1e-5              # |y| <= tol * |x| * |proj column| may flip
# LM decode (gemma3-4b at its published width): lm_serve, lm_long, and the
# depth-cut fp32 cross-check against the CPU
LM_BLOCK = 512                   # SKETCH_BLOCK
LM_B, LM_S, LM_PROMPT, LM_GEN = 4, 4096, 384, 192    # 576 steps: two sketch blocks
LM_LONG_S, LM_LONG_LEN, LM_LONG_STEPS = 131_072, 131_000, 8
LM_CROSS_LAYERS = 6              # one 5:1 local:global period
SDA_RTOL, SDA_ATOL = 2e-5, 2e-5  # fp32 sums in another order (the reference
                                 # kernel's own bound, tests/test_kernels.py)
# lm_families: every other family's batched decode at its published width,
# random bf16 weights from the seed, one configuration at a time on a card
# that holds nothing else: (arch, layers run or None for all, sketch).
# deepseek-v3 is cut to 5 of 61 layers (3 dense + 2 MoE/MLA: 56.9 GB; six
# layers, ~80 GB, do not fit), internvl2 to 36 of 80 (~66 GB)
FAMILY_RUNS = (("deepseek-moe-16b", None, False),
               ("deepseek-v3-671b", 5, False),
               ("zamba2-2.7b", None, False),
               ("xlstm-125m", None, False),
               ("whisper-large-v3", None, False),
               ("internvl2-76b", 36, True))
FAM_B, FAM_S, FAM_PROMPT, FAM_GEN = 4, 4096, 64, 32
# the fp32 card-vs-CPU check at full width, depth cut to the family's
# smallest unit (moe: 1 dense + 1 MoE layer; hybrid: one group of 6 Mamba2
# layers and the shared block; encdec: 2 encoder + 2 decoder layers; vlm: 2
# layers; ssm: all 12 layers, 0.7 GB), B = 2 over 3 teacher-forced steps
# (cut from 8 for time): logits within FAM_LOGIT_TOL of their largest, every
# float cache leaf within FAM_CACHE_TOL of its largest (fp32 sums in another
# order: gemma3-4b's 6 fp32 layers measured 1.9e-6 and 1.3e-6; the
# recurrent states and the softmaxes amplify), MoE routes equal except
# where two experts' probabilities lie within FAM_ROUTE_TIE of each other
# (counted; the comparison stops at such a step); whisper's cross cache,
# bfloat16 in both (the reference stores it so), within one bf16 ulp of its
# largest value, FAM_BF16_LEAF_TOL (an fp32 value near a rounding boundary
# rounds either way); the bf16 decode against the fp32 one on the card over
# the same tokens: every step's logit cosine >= FAM_BF16_COSINE.  3 steps,
# cut from 6 for time
FAM_CROSS_B, FAM_CROSS_S, FAM_CROSS_STEPS = 2, 1024, 3
FAM_CROSS_LEN = 600              # internvl2's injected start (two sketch blocks)
FAM_LOGIT_TOL, FAM_CACHE_TOL, FAM_ROUTE_TIE = 1e-4, 1e-4, 1e-5
FAM_BF16_COSINE = 0.99
FAM_BF16_LEAF_TOL = 2.0 ** -7
# the leaves the reference keeps in float32 whatever the parameter dtype
FP32_LEAVES = ("router", "A_log", "D", "dt_bias", "b_if", "b")
# train_families: every other family's training at its published width,
# random bf16 weights from the seed, one configuration at a time on a card
# that holds nothing else: (arch, layers run or None for all, how, B, S),
# "how" the entry point: the Trainer (token-only families, drift monitor
# on), make_train_step (the frontends' frames or patches), or one
# microbatch's grads_and_metrics (deepseek-v3: parameters + gradients are
# 67.6 GB at 4 layers; no optimizer state fits).  Depths reckoned at 12
# bytes a parameter (bf16 weights and gradients, AdamW's two fp32 moments):
# deepseek-moe-16b 6 of 28 layers (3.44 G parameters, ~41 GB),
# deepseek-v3-671b 4 of 61 (3 dense + 1 MoE/MLA) and the MTP block (16.9 G),
# internvl2-76b 2 of 80 (3.8 G, ~46 GB); S counts internvl2's 256 patches
# (3840 text tokens) and not whisper's 1500 frames.  xlstm-125m runs S =
# 64: its recurrences loop over time in Python, ~1.9 M device ops a step at
# S = 1024 (60-67 s a step on the card, 6% busy), 7.8 s at S = 128
TRAIN_FAMILY_RUNS = (("deepseek-moe-16b", 6, "trainer", 2, 4096),
                     ("deepseek-v3-671b", 4, "grads", 1, 2048),
                     ("zamba2-2.7b", None, "trainer", 2, 4096),
                     ("xlstm-125m", None, "trainer", 2, 64),
                     ("whisper-large-v3", None, "step", 2, 448),
                     ("internvl2-76b", 2, "step", 2, 4096))
TRAIN_FAM_STEPS = 2                  # then one profiled
# the fp32 card-vs-CPU check at each family's smallest unit: loss and
# metrics within TRAIN_FAM_LOSS_TOL relative, every gradient leaf within
# TRAIN_FAM_GRAD_TOL of its largest entry (fp32 sums in another order);
# zamba2's Mamba2 layers round their intra-chunk scores to bf16 in both
# packages, so a score whose fp32 value differs in its last bit rounds one
# bf16 ulp apart: its gradients within one bf16 ulp of their largest,
# TRAIN_FAM_SSD_TOL; bf16 against fp32 on the card: loss within 2e-2
# relative, whole-gradient cosine >= 0.99 (cut for time)
TRAIN_FAM_CROSS_B, TRAIN_FAM_CROSS_S = 2, 128
TRAIN_FAM_LOSS_TOL, TRAIN_FAM_GRAD_TOL = 1e-5, 1e-4
TRAIN_FAM_SSD_TOL = 2.0 ** -8
# lm_mesh: LM training on a (data, model) mesh.  The fp32 gates (TF32 off)
# at full width, depth cut to each family's smallest unit (qwen3-4b 1
# layer, deepseek-moe-16b 1 dense + 1 MoE), MESH_GATE_B x MESH_GATE_S
# tokens: the sharded step against the unsharded step on the same card at
# the reference's bounds (tests/test_distributed.py): loss (MoE: the
# cross-entropy; its aux against the per-shard estimate) within
# MESH_LOSS_TOL, every parameter within rtol MESH_RTOL, atol MESH_ATOL,
# after one AdamW step at MESH_GATE_LR with no warmup (it moves a parameter
# 50 times MESH_ATOL, so the bound can fail); the gradients (AdamW's first
# moment after the step) leaf by leaf within MESH_GRAD_TOL of each leaf's
# largest, the gradient norm within MESH_GRAD_TOL relative (MoE: the ranks'
# bf16 combine, moe_ep's bf16 bound 2e-2; the router 1e-1, as it takes the
# gradient of the per-shard aux, an estimate of the unsharded one); where
# the two gradients differ by more than half the unsharded one (their
# signs may differ) or the unsharded one is under 100 eps, the step's
# update g / (|g| + eps) may take either sign, and the parameter is held
# within the bound plus 2 MESH_GATE_LR.  The MoE gate runs dropless
# (capacity factor n_experts / topk: C = T), so the ranks' local
# capacities drop nothing either.  moe_ep against
# moe_dense at deepseek-moe-16b's published width, one layer in bf16, over
# MESH_EP_B x MESH_EP_S tokens at capacity factor 64 (the reference's
# bounds: rtol / atol 2e-2, mean error < 5e-3; aux equal to the per-shard
# estimate).  The compressed all-reduce's 20-step error-feedback bound.
# The other five families' gates (MESH_FAMILY_GATES: arch, depth, S, width;
# one AdamW step each, the batch's frames or patches from launch.inputs): each
# family's smallest unit at published width (zamba2 one group, xlstm one
# pair at S = 64, whisper one encoder and one decoder layer over its 1500
# frames, internvl2 one layer after its 256 patches), deepseek-v3 at its
# smoke width (its smoke config's: one fp32 MoE layer at published width is
# 46 GB of weights) cut to 1 dense + 1 MoE layer and the MTP head, at one
# microbatch (its published 8 run on cards 0..3); the hybrid's gradients
# and gradient norm within one bf16 ulp of the largest (TRAIN_FAM_SSD_TOL),
# deepseek-v3's at the MoE bounds and its MTP cross-entropy within
# MESH_LOSS_TOL.  (The smoke config's 3 MoE layers move the
# cross-entropy by up to 2.8e-4 at S = 256 through the ranks' bf16
# combine; on the CPU the reference's own 2 x 2 mesh moves its MTP
# cross-entropy by 2.4e-4 there, tests/torch_mesh_drift.py.)  The sharded step runs first;
# its parameters and first moment are gathered, its state dropped, and the
# unsharded step runs on the same parameters drawn again from the seed
# (internvl2's fp32 layer and embeddings: 11.9 GB, each step's state four
# times that).
# Then bf16 at published width through the Trainer (the drift monitor, no
# checkpoint; MESH_RUNS: arch, depth, B, S, optimizer, steps before the
# profiled one): deepseek-moe-16b cut to 6 layers and zamba2-2.7b to 2 of
# its 9 groups on one card repeated as a 2 x 2 mesh (four shards of the
# whole model on one card); on cards 0..3 (MESH_RUNS_4): deepseek-moe-16b
# whole, and deepseek-v3-671b at 3 dense + 1 MoE layer and the MTP head
# (16.9 G parameters: Adam8bit, 2.1 bytes a parameter, as AdamW's 8 would
# leave no room) with its published 8 microbatches accumulated in bf16.
# Each card's peak against `_reckon_mesh_bytes`.  Cards 0..3 also run
# deepseek-v3's smoke step twice (bit for bit) and against the same mesh on
# card 0 repeated (metrics within 1e-6 relative, gradients within 1e-4 of
# their largest: only the order in which the cards' backward threads add a
# block's terms differs)
MESH_SHAPE = (2, 2)
MESH_GATE_B, MESH_GATE_S = 4, 256
MESH_LOSS_TOL, MESH_RTOL, MESH_ATOL = 2e-4, 2e-4, 2e-5
MESH_GATE_LR = 1e-3
MESH_GRAD_TOL = {"dense": 1e-4, "moe": 2e-2, "router": 1e-1,
                 "hybrid": TRAIN_FAM_SSD_TOL, "ssm": 1e-4, "encdec": 1e-4,
                 "vlm": 1e-4}
CMP_PIECE = 2 ** 26          # elements a gate compares at a time
MESH_FAMILY_GATES = (("deepseek-v3-671b", 2, MESH_GATE_S, "smoke"),
                     ("zamba2-2.7b", 6, MESH_GATE_S, "published"),
                     ("xlstm-125m", 2, 64, "published"),
                     ("whisper-large-v3", 1, MESH_GATE_S, "published"),
                     ("internvl2-76b", 1, MESH_GATE_S, "published"))
MESH_EP_B, MESH_EP_S = 2, 512
MESH_RUNS = (("deepseek-moe-16b", 6, 2, 4096, "adamw", 2),
             ("zamba2-2.7b", 12, 2, 4096, "adamw", 2))
MESH_RUNS_4 = (("deepseek-moe-16b", None, 2, 4096, "adamw", 2),
               ("deepseek-v3-671b", 4, 16, 2048, "adam8bit", 1))
MESH_FOUR_B, MESH_FOUR_S = 8, 32

# lm_mesh_decode: batched decode on a (data, model) mesh.  fp32 gates (TF32
# off) on a 2 x 2 mesh of one card repeated, each family's smallest unit at
# published width (deepseek-v3 at its smoke width: a full-width fp32 MoE
# layer is 45 GB a copy): (arch, layers, B, s_max, start, sketch),
# MDEC_GATE_STEPS
# steps from a random prefix of `start` tokens whose last steps cross from
# one rank's block of the sequence into the next; the mesh step against the
# one-device step on the same card: logits within MDEC_LOGIT_TOL of their
# largest, written k / v and latents within MDEC_KV_TOL of their largest,
# recurrent states within MDEC_STATE_TOL (fp32 sums in another order: the
# column blocks, the merge of the ranks' partials).  Then bf16 at
# published width against one device on the same weights: gemma3-4b, sketch
# on, B = 1 over LM_LONG_S (four blocks of 32 768 rows), MDEC_LONG_STEPS
# steps from LM_LONG_LEN; deepseek-moe-16b whole, B = MDEC_MOE_B over
# MDEC_MOE_S: logit cosine >= MDEC_BF16_COSINE every step, the one device
# following the mesh step's live lists and expert ids (their flips under
# bf16 rounding counted); the MoE configs dropless (`_dropless`).  Cards
# 0..3: the reference's long_500k, B = 1 over MDEC_500K_S
MDEC_GATES = (("gemma3-4b", 6, 1, 8192, 6143, True),
              ("qwen3-4b", 1, 4, 1024, 511, False),
              ("internvl2-76b", 2, 2, 4096, 2047, True),
              ("deepseek-moe-16b", 2, 2, 1024, 511, False),
              ("deepseek-v3-671b", "smoke", 1, 1024, 255, False),
              ("zamba2-2.7b", 6, 2, 1024, 511, False),
              ("xlstm-125m", 2, 2, 0, 0, False),
              ("whisper-large-v3", 2, 2, 1024, 511, False))
MDEC_GATE_STEPS = 2
MDEC_LOGIT_TOL, MDEC_KV_TOL, MDEC_STATE_TOL = 1e-5, 3e-6, 1e-5
MDEC_BF16_COSINE = 0.999
MDEC_LONG_STEPS = 32
MDEC_TAIL_STEPS = 2          # mesh steps after the comparison: peak, profile
MDEC_MOE_B, MDEC_MOE_S, MDEC_MOE_START, MDEC_MOE_STEPS = 4, 4096, 4000, 16
MDEC_500K_S, MDEC_500K_LEN, MDEC_500K_STEPS = 524_288, 524_200, 16

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
# T = 8 (4 chunks, re-run on the CPU); the T = 256 gates (S-ANN's: 16.5 GB
# of tables) are cut for time: the sharding phase splits RACE and SW-AKDE
# fleets of T = 256 by tenant and holds each tenant's row against its
# single-sketch loop, and an S-ANN fleet of T = 64
FLEET_ZIPF_S, FLEET_TENANTS, FLEET_HOT, FLEET_HOT_CHUNK = 1.1, 1024, 256, 4
FLEET_SW_N = KDE_N
FLEET_RACE_N = KDE_N // 2
FLEET_SW_TENANTS, FLEET_SW_WINDOW = 256, 8192
FLEET_SANN_TENANTS, FLEET_SANN_HOT = 72, 64
FLEET_SANN_NMAX = 65_536
FLEET_SANN_N = 5 * CHUNK             # reaches the all-one-tenant chunk
FLEET_GATE_T, FLEET_GATE_CHUNKS = (8,), {8: 4}
FLEET_SANN_GATE_T = (8,)
FLEET_DURABLE_CHUNKS, FLEET_SNAPSHOT_EVERY, FLEET_QUERIES = 4, 4, 2048
# the cluster phase: K workers on the one card; the KDE stream stays under
# every worker's window (65 536 / K) so nothing expires
CLUSTER_WORKERS = (1, 2, 4)
CLUSTER_KDE_WINDOW, CLUSTER_KDE_N, CLUSTER_DURABLE_N = 65_536, 61_440, 262_144
# the points fed past the KDE gate stream before the second gate: they carry
# a worker of K = 4 past its window (65 536 / 4), so that gate holds a state
# whose windows have expired (every K of the smoke runs expires there)
CLUSTER_KDE_TAIL = CLUSTER_KDE_WINDOW // 4
# the clusters' RACE and S-ANN streams: the first half of each
CLUSTER_RACE_N, CLUSTER_SANN_N = KDE_N // 2, SANN_N // 2
# the rpc_cluster phase: the cluster phase's workloads, each worker a spawned
# process; S-ANN at n_max 250 000 a worker, so that a worker's snapshot
# (164.5 MB) fits the wire protocol's 256 MiB frame (at 1 000 000 it is 434
# MB: tests/test_torch_net.py checks the refusal with the cap lowered; the
# K = 2 cluster that showed it here is cut for time); SW-AKDE and S-ANN
# merge at query time only (each merge pulls every worker's snapshot over
# TCP), RACE every 8 commits
RPC_SANN_NMAX = 250_000
# the RPC S-ANN stream (and its in-process twin): the cluster phase's
# stream's first half (cut for time)
RPC_SANN_N = CLUSTER_SANN_N // 2
RPC_MERGE_EVERY, RPC_TIMEOUT_S = 10**9, 120.0
# every RPC cluster runs at K = 4 but the durable and failover ones (K =
# 2): the in-process `cluster` phase covers K = 1, 2, 4 of each kind, and
# each spawned cluster costs ~10 s of start-up
RPC_K = 4

# the sharding phase: K = 4 shards (one card repeated, or four cards); SRP
# SW-AKDE at eps 0.01 (52 slots); S-ANN merged from two halves of 8 chunks;
# answers also at query batches of 16 and 1024; the services fed 24 chunks
# (the KDE window of 65 536 expires; the retrieval service at n_max 16 384,
# 3565 slots, wraps its ring), snapshots every 8 operations; fleets split by
# tenant fed 64 mixed chunks (the 5 heaviest SW-AKDE tenants expire; the
# S-ANN fleet at n_max 4096 a tenant, 1351 slots, wraps the 3 heaviest)
SHARD_K, SHARD_SRP_EPS, SHARD_MERGE_CHUNKS = 4, 0.01, 8
SHARD_OTHER_BATCHES = (16, 1024)
SHARD_SERVICE_ROWS, SHARD_SNAPSHOT_EVERY = 24 * CHUNK, 8
SHARD_SERVICE_SANN_NMAX = 16_384
SHARD_FLEET_CHUNKS, SHARD_FLEET_SANN_NMAX = 64, 4096
SHARD_FLEET_T = {"race": 256, "swakde": 256, "sann": 64}

# the train phase: gemma3-4b at full width and depth, bf16, AdamW, B x S
# with per-layer remat, TRAIN_STEPS steps then one profiled; the fp32
# cross-check (card vs CPU) and the Trainer's resume at full width, depth
# cut to 2 layers; flash vs dense attention within FLASH_TOL of the
# largest value (fp32, sums in another order); after one AdamW step a
# parameter may differ from the CPU's by more than TRAIN_PARAM_TOL (and a
# rounding) only by what its two gradients predict through the step's
# formula
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 2, 4096, 3, 3e-4
TRAIN_CROSS_LAYERS, TRAIN_CROSS_S, TRAIN_RESUME_S = 2, 128, 512
FLASH_TOL, TRAIN_PARAM_TOL = 2e-5, 1e-7

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


def device_profile(prof, top=10):
    """(busy ms, device ops, top ops) of a finished profile, read from its
    raw device events: building the profiler's per-event objects for a step
    of 10^5-10^6 ops takes minutes."""
    busy_ns, n, by_name = 0, 0, {}
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        dur = (e.duration_ns() if hasattr(e, "duration_ns")
               else e.duration_us() * 1000)
        busy_ns += dur
        n += 1
        ns, c = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (ns + dur, c + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return busy_ns / 1e6, n, [{"op": k[:80], "ms": ns / 1e6, "calls": c}
                              for k, (ns, c) in rows]


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
                results=results, topk=topk, r=r, c=c,
                rates={"points_per_s": n / t_ingest,
                       "queries_per_s": n_queries / t_query,
                       "topk_queries_per_s": n_queries / t_topk})


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
    return dict(cfg=cfg, params=params, state=sw, race=rc, data=data,
                gen=gen, queries=queries, launches=launches,
                rates={"swakde_points_per_s": n / t_sw,
                       "race_points_per_s": n / t_rc})



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
                race=rc, data=data, queries=queries, launches=launches,
                rates={"race_points_per_s": n / t_rc})


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
    flips, unexplained = _sig_flips(caches[device], caches["cpu"], length, steps)
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


def _sig_flips(cache_dev, cache_cpu, length, steps):
    """(signature bits that differ between the card's cache and the CPU's,
    those of them not at a sign boundary): a bit may differ only where one
    of the ``steps`` new keys' projections is at the boundary."""
    import torch
    from repro_torch.serve import serve_step
    new_k = cache_cpu["k"][:, :, length:length + steps]
    L, B, T, Hkv, dh = new_k.shape
    mean = serve_step._head_mean(new_k.reshape(L * B, T, Hkv, dh)).reshape(L, B, T, dh)
    near = serve_step.sig_near_boundary(mean, serve_step._sig_proj(dh))
    near_blk = torch.zeros_like(cache_cpu["block_sigs"])
    for t in range(steps):
        near_blk[:, :, (length + t) // LM_BLOCK] |= near[:, :, t]
    diff = cache_dev["block_sigs"].cpu() != cache_cpu["block_sigs"]
    return int(diff.sum()), int((diff & ~near_blk).sum())


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


def _long_layers(cfg, device, length, s_max, seed):
    """`long_cache`'s content layer by layer: ``(k, v, sigs)`` of one layer
    (bf16 ``(1, s_max, Hkv, dh)`` keys clustered by block, random values,
    the block signatures of the keys below ``length``)."""
    import torch
    from repro_torch.serve import serve_step
    gen = torch.Generator(device=device).manual_seed(seed)
    Hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    nb = s_max // LM_BLOCK
    proj = serve_step._sig_proj(dh, device)
    pos_ok = (torch.arange(s_max, device=device) < length).reshape(nb, LM_BLOCK, 1)
    for _ in range(cfg.n_layers):
        dirs = torch.randn((nb, 1, Hkv, dh), generator=gen, device=device)
        noise = torch.randn((nb, LM_BLOCK, Hkv, dh), generator=gen, device=device)
        k = (dirs + 0.1 * noise).reshape(1, s_max, Hkv, dh)
        del noise
        k[:, length:] = 0
        k = k.to(torch.bfloat16)
        v = torch.randn((1, s_max, Hkv, dh), generator=gen, device=device)
        v[:, length:] = 0
        v = v.to(torch.bfloat16)
        bits = serve_step._sig_bits(serve_step._head_mean(k)[0], proj)
        yield k, v, (bits.reshape(nb, LM_BLOCK, 64) & pos_ok).any(1)


def long_cache(cfg, device, length, s_max, seed):
    """A B = 1 cache at ``length`` whose keys cluster by block: each block's
    keys are a block-specific direction per KV head plus noise, so the block
    signatures are sparse; values are random (`_long_layers`).  The
    signatures are built with the port's own rule (the OR of `_sig_bits` of
    each key's head mean over its block), and for the last block of every
    global layer checked against replaying `_update_sigs` token by
    token."""
    import torch
    from repro_torch.serve import kv_cache, serve_step
    cache = kv_cache.init_cache(cfg, 1, s_max, sketch=True, device=device)
    cache["length"] = length
    nb = s_max // LM_BLOCK
    replay_ok = True
    last = (length - 1) // LM_BLOCK
    glob = set(global_layers(cfg))
    for layer, (k, v, sigs) in enumerate(_long_layers(cfg, device, length,
                                                      s_max, seed)):
        cache["k"][layer] = k
        cache["v"][layer] = v
        cache["block_sigs"][layer, 0] = sigs
        if layer in glob:
            kl = cache["k"][layer]
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
# phase 3e: the training path (gemma3-4b at full width): token stream, drift
# monitor, flash attention with its backward, forward, AdamW, train step,
# the resumable Trainer
# --------------------------------------------------------------------------

def _train_tokens(cfg, B, S, seed):
    from repro_torch.data import pipeline
    return pipeline.TokenStream(pipeline.DataConfig(
        vocab=cfg.vocab, batch=B, seq=S, seed=seed)).next_batch()


def _leaf_err(a, b) -> float:
    """max |a - b| over max |b|, compared on the CPU in float32."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _cosine(a, b) -> float:
    import torch
    a, b = a.detach().double().flatten(), b.detach().double().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den else float(torch.equal(a, b))


def _drift_codes_check(monitor, cpu_params, tokens, device):
    """The drift monitor's rows for ``tokens`` hashed on the card (the
    `srp_hash` kernel) and by the plain version on the CPU: codes that
    differ must sit at a sign boundary (`srp_flips`); returns the card's
    codes and the count of those that differ."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref, srp_hash
    emb = monitor.embed(tokens)
    rows = torch.from_numpy(np.concatenate(
        [emb, emb.mean(axis=0)[None]]).astype(np.float32))
    p = monitor.params
    x = rows.to(device)
    got = srp_hash.srp_hash(x, p.proj, p.mix, p.n_buckets)
    want = ref.srp_hash_ref(rows, cpu_params.proj, cpu_params.mix,
                            cpu_params.n_buckets)
    return got, srp_flips(x, p, got, want.to(device))


def phase_train_full(seed, device, B=TRAIN_B, S=TRAIN_S, steps=TRAIN_STEPS):
    """gemma3-4b at full width and depth in bf16, AdamW: the token stream
    and its drift monitor through `make_train_step` for ``steps`` steps (no
    checkpoint), then one profiled step.  Each step must launch `srp_hash`
    and `swakde_segment_pass` once (the monitor) and no other kernel.  A
    CPU twin of the monitor's sketch, fed the card's own codes through the
    plain commit, must hold the monitor's state bit for bit after every
    step, and give its density before the update."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint.checkpoint import tree_leaves, tree_map
    from repro_torch.core import swakde
    from repro_torch.core.util import mean_last
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.optim import adam
    from repro_torch.train import train_step as ts
    cfg = lm_config()
    step_fn, init = ts.make_train_step(cfg, adam.adamw(lr=TRAIN_LR))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init(torch.Generator(device=device).manual_seed(seed + 21), device)
    sync(device)
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(state.params)
    n_params = sum(p.numel() for p in leaves)
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, batch=B, seq=S, seed=seed)
    stream = pipeline.TokenStream(dcfg)
    monitor = pipeline.DriftMonitor(dcfg, device)
    cpu_params = monitor.params._replace(proj=monitor.params.proj.cpu(),
                                         mix=monitor.params.mix.cpu())
    twin = swakde.swakde_init(monitor.cfg, "cpu")
    rows, flips, density_err = [], 0, 0.0
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    for i in range(steps + 1):
        profiled = i == steps
        tokens = stream.next_batch()
        codes, n = _drift_codes_check(monitor, cpu_params, tokens, device)
        flips += n
        codes = codes.cpu()
        twin_density = float(mean_last(swakde.swakde_row_estimates_from_codes(
            twin, codes[-1], monitor.cfg)))
        twin = swakde.swakde_commit_chunk(
            twin, swakde.swakde_prepare_from_codes(codes[:-1], monitor.cfg),
            monitor.cfg)
        before = dict(ops.LAUNCHES)
        sync(device)
        # device activity alone on the card: ~10^5 kernels a step, and the
        # host ops would triple the trace to reduce
        acts = ([ProfilerActivity.CUDA] if device.type == "cuda"
                else [ProfilerActivity.CPU])
        with (profile(activities=acts) if profiled
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            drift = monitor.observe(tokens)          # ends in a host read
            t1 = time.perf_counter()
            batch = {"tokens": torch.from_numpy(tokens).to(device)}
            state, m = step_fn(state, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            t2 = time.perf_counter()
        per = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        launches = {k: launches[k] + per[k] for k in per}
        if per != {k: int(k in ("srp_hash", "swakde_segment_pass"))
                   for k in ops.LAUNCHES}:
            fail(f"train: step {i + 1} launched {per}; the drift monitor "
                 "launches srp_hash and swakde_segment_pass once a step")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"train: step {i + 1} loss {loss} grad norm {gnorm}")
        differ = differing_leaves(monitor.state, twin)
        err = abs(drift["density"] - twin_density) / max(abs(twin_density),
                                                         1e-30)
        density_err = max(density_err, err)
        if differ or err > 1e-6:
            fail(f"train: step {i + 1}: the drift monitor's state on the "
                 f"card differs from the plain commit of its codes in "
                 f"{differ}, density {drift['density']} against "
                 f"{twin_density}")
        rows.append({"step": i + 1, "ms": (t2 - t0) * 1e3,
                     "drift_ms": (t1 - t0) * 1e3, "loss": loss,
                     "grad_norm": gnorm, "density": drift["density"],
                     "profiled": profiled})
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    busy_ms, n_ops, top = device_profile(prof)
    reduce_s = time.perf_counter() - t0
    prof_wall_ms = rows[-1]["ms"]
    # AdamW's update alone on the run's state, gradients in the parameters'
    # dtype as the step gives them (after the peak was read); it reads p
    # and g (bf16), m and v (fp32) and writes p, m and v once
    grads = tree_map(lambda t: torch.full_like(t, 1e-3), state.params)
    opt = adam.adamw(lr=TRAIN_LR)
    opt_ms = time_ms(lambda: opt.update(grads, state.opt_state, state.params),
                     2, device, warmup=1)
    opt_bytes = sum(t.numel() * (3 * t.element_size() + 16) for t in leaves)
    del grads
    steady = sorted(r["ms"] for r in rows[1:-1])
    step_ms = steady[len(steady) // 2]
    emit({"phase": "train", "part": "full", "arch": cfg.arch_id,
          "dtype": cfg.param_dtype, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "params": n_params,
          "optimizer": "adamw", "lr": TRAIN_LR, "B": B, "S": S,
          "remat": cfg.remat, "init_s": init_s, "steps": rows,
          "step_ms_median": step_ms, "step_ms_first": rows[0]["ms"],
          "tokens_per_s": B * S / (step_ms / 1e3),
          "drift_ms_median": sorted(r["drift_ms"] for r in rows[1:-1])[
              (steps - 1) // 2],
          "peak_mem_bytes": peak,
          "param_bytes": sum(p.numel() * p.element_size() for p in leaves),
          "launches": launches,
          "launches_per_step": {"srp_hash": 1, "swakde_segment_pass": 1},
          "monitor_code_flips": flips, "monitor_state_equals_cpu": True,
          "monitor_density_err_rel_max": density_err,
          "profiled_step_ms": prof_wall_ms,
          "profiled_device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / prof_wall_ms,
          # the profiled step's device time over an unprofiled step's wall
          "device_busy_over_median_step": busy_ms / step_ms,
          "profile_reduce_s": reduce_s,
          "profiled_device_ops": n_ops,
          "optimizer_update_ms": opt_ms,
          "optimizer_update_bound_ms": opt_bytes / PEAK_BYTES_PER_S * 1e3,
          "top_device_ops": top})
    del state, m, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": steps + 1}


def _dense_attention(q, k, v, window):
    """Causal (and windowed) attention through one masked softmax over the
    whole (S, S) score matrix, in q's dtype, GQA by repeating K and V."""
    import torch
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def phase_train_flash(device, B=1, S=TRAIN_S):
    """The flash `Function` against autograd through dense masked-softmax
    attention on the card, fp32 (TF32 off), at gemma3-4b's heads (8 x 256,
    kv 4), for a global and a 1024-window layer: output and gradients
    within FLASH_TOL of the largest value."""
    import torch
    from repro_torch.models import flash
    cfg = lm_config()
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=device).manual_seed(31)
    mk = lambda *s: torch.randn(s, generator=gen, device=device)
    q, k, v, go = mk(B, S, H, dh), mk(B, S, Hkv, dh), mk(B, S, Hkv, dh), mk(B, S, H, dh)
    out = []
    for window in (0, cfg.local_window):
        res = {}
        for name, fn in (("flash", lambda a, b, c: flash.flash_attention(
                              a, b, c, causal=True, window=window)),
                         ("dense", lambda a, b, c: _dense_attention(a, b, c, window))):
            a, b, c = (t.clone().requires_grad_() for t in (q, k, v))
            o = fn(a, b, c)
            o.backward(go)
            res[name] = (o.detach(), a.grad, b.grad, c.grad)
        errs = {n: _leaf_err(x, y) for n, x, y in zip(
            ("o", "dq", "dk", "dv"), res["flash"], res["dense"])}
        out.append({"window": window, "err_rel": errs})
        if max(errs.values()) > FLASH_TOL:
            fail(f"train: flash attention disagrees with dense attention "
                 f"(window {window}): {errs}")
    emit({"phase": "train", "part": "flash_vs_dense", "B": B, "S": S,
          "heads": [H, Hkv, dh], "dtype": "float32", "tol_rel": FLASH_TOL,
          "cases": out})


def phase_train_cross_check(seed, device, n_layers=TRAIN_CROSS_LAYERS,
                            B=1, S=TRAIN_CROSS_S):
    """gemma3-4b at full width, depth cut to ``n_layers``: the fp32 step's
    loss, gradients and AdamW update on the card against the same step on
    the CPU (the plain path; TF32 off), then the bf16 step against the
    fp32 one on the card."""
    import torch
    from repro_torch.checkpoint.checkpoint import _flatten, tree_map
    from repro_torch.models import model
    from repro_torch.optim import adam
    from repro_torch.train import train_step as ts
    cfg = lm_config(n_layers, "float32")
    params = model.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed + 22), device)
    tokens = torch.from_numpy(_train_tokens(cfg, B, S, seed + 23))
    # the same weights in bf16 on the card and in fp32 on the CPU
    p16 = tree_map(lambda t: t.bfloat16(), params)
    copies = {"card": params,
              "cpu": tree_map(lambda t: t.to("cpu", copy=True), params)}
    runs = {}
    for name, d in (("card", device), ("cpu", torch.device("cpu"))):
        p = copies.pop(name)
        t0 = time.perf_counter()
        g, m = ts.grads_and_metrics(p, cfg, {"tokens": tokens.to(d)})
        opt = adam.adamw(lr=TRAIN_LR)
        opt.update(g, opt.init(p), p)
        sync(device)
        runs[name] = dict(p=p, g=g, m=m, gnorm=ts.grad_norm(g),
                            s=time.perf_counter() - t0)
    dev, cpu = runs["card"], runs["cpu"]
    loss_err = abs(float(dev["m"]["loss"]) - float(cpu["m"]["loss"])) \
        / abs(float(cpu["m"]["loss"]))
    gnorm_err = abs(float(dev["gnorm"]) - float(cpu["gnorm"])) / float(cpu["gnorm"])
    grad_err = {k: _leaf_err(a, b) for (k, a), (_, b) in
                zip(_flatten(dev["g"]), _flatten(cpu["g"]))}
    # AdamW's first step (zero moments, AdamW's defaults) moves a parameter
    # by -lr_t * (u + wd * p) with u = g / (|g| + eps): +-1 unless |g| is
    # within a few eps of 0.  Where the card's and the CPU's parameters
    # are more than PARAM_TOL apart, the difference of their u (a sign
    # flip, or both gradients that close to 0) must account for all of it
    # but PARAM_TOL and one float32 rounding of the parameter.
    lr_t = float(adam._step_scalars(torch.ones((), dtype=torch.int32),
                                    TRAIN_LR, 0.9, 0.95, 100)[0])
    past, flipped, unexplained, resid_max, small = 0, 0, 0, 0.0, 0.0
    for (k, a), (_, b), (_, ga), (_, gb) in zip(
            _flatten(dev["p"]), _flatten(cpu["p"]), _flatten(dev["g"]),
            _flatten(cpu["g"])):
        diff = a.cpu() - b
        bad = diff.abs() > TRAIN_PARAM_TOL
        if not bad.any():
            continue
        past += int(bad.sum())
        gmax = float(gb.abs().max().clamp(min=1e-30))
        ga, gb = ga.cpu()[bad].double(), gb[bad].double()
        u = [g / (g.abs() + 1e-8) for g in (ga, gb)]
        resid = (diff[bad].double() + lr_t * (u[0] - u[1])).abs()
        allow = TRAIN_PARAM_TOL + b[bad].double().abs() * 2.0 ** -23
        flipped += int((ga.sign() != gb.sign()).sum())
        unexplained += int((resid > allow).sum())
        resid_max = max(resid_max, float(resid.max()))
        small = max(small, float(torch.minimum(ga.abs(), gb.abs()).max())
                    / gmax)
    row = {"phase": "train", "part": "cross_check", "arch": cfg.arch_id,
           "layers": [n_layers, lm_config().n_layers], "d_model": cfg.d_model,
           "vocab": cfg.vocab, "B": B, "S": S, "fp32_loss": float(dev["m"]["loss"]),
           "loss_err_rel": loss_err, "grad_norm_err_rel": gnorm_err,
           "grad_err_rel_max": max(grad_err.values()),
           "grad_err_rel_worst_leaf": max(grad_err, key=grad_err.get),
           "params_past_tol": past, "params_past_tol_sign_flips": flipped,
           "params_past_tol_unexplained": unexplained,
           "params_past_tol_residual_max": resid_max,
           "params_past_tol_min_grad_rel_max": small,
           "param_tol": TRAIN_PARAM_TOL, "lr_t": lr_t, "card_step_s": dev["s"],
           "cpu_step_s": cpu["s"],
           "depth_cut": "the CPU copy of the fp32 weights, moments and "
                        "gradients: 24 GB at 2 layers"}
    if (loss_err > 1e-5 or gnorm_err > 1e-4 or max(grad_err.values()) > 1e-4
            or unexplained):
        emit(row)
        fail("train: the card's fp32 step disagrees with the CPU's")
    # the bf16 step against the fp32 step, from the same weights
    cfg16 = lm_config(n_layers, "bfloat16")
    g16, m16 = ts.grads_and_metrics(p16, cfg16, {"tokens": tokens.to(device)})
    adam.adamw(lr=TRAIN_LR).update(g16, adam.adamw(lr=TRAIN_LR).init(p16), p16)
    cos = {k: _cosine(a, b) for (k, a), (_, b) in
           zip(_flatten(g16), _flatten(dev["g"]))}
    row.update(bf16_loss=float(m16["loss"]),
               bf16_loss_err_rel=abs(float(m16["loss"]) - float(dev["m"]["loss"]))
               / abs(float(dev["m"]["loss"])),
               bf16_grad_norm_err_rel=abs(float(ts.grad_norm(g16))
                                          - float(dev["gnorm"])) / float(dev["gnorm"]),
               bf16_grad_cosine_min=min(cos.values()),
               bf16_grad_cosine_worst_leaf=min(cos, key=cos.get),
               bf16_params_finite=all(bool(torch.isfinite(t).all())
                                      for _, t in _flatten(p16)))
    emit(row)
    if (row["bf16_loss_err_rel"] > 2e-2 or row["bf16_grad_norm_err_rel"] > 5e-2
            or row["bf16_grad_cosine_min"] < 0.99 or not row["bf16_params_finite"]):
        fail("train: the card's bf16 step is too far from its fp32 step")
    del runs, dev, cpu, p16, g16
    torch.cuda.empty_cache()


class _TimedCheckpointer:
    """An `AsyncCheckpointer` that records the seconds each save spends on
    the caller (the copy to the host) and in `wait` (the write); with
    ``write=False`` it saves nothing (a run whose checkpoint no one reads)."""

    def __init__(self, write: bool = True):
        from repro_torch.checkpoint.checkpoint import AsyncCheckpointer
        self._inner = AsyncCheckpointer()
        self.write = write
        self.save_s, self.wait_s = [], []

    def save(self, *args, **kw):
        t0 = time.perf_counter()
        if self.write:
            self._inner.save(*args, **kw)
        self.save_s.append(time.perf_counter() - t0)

    def wait(self):
        t0 = time.perf_counter()
        self._inner.wait()
        self.wait_s.append(time.perf_counter() - t0)


def phase_train_resume(seed, device, n_layers=TRAIN_CROSS_LAYERS, B=2,
                       S=TRAIN_RESUME_S, arch=None):
    """The Trainer (Adam8bit, drift monitor on) at full width, depth cut to
    ``n_layers`` (gemma3-4b, or ``arch``): 2 steps without a break against
    1 step, a checkpoint, and a fresh Trainer resuming it for the second:
    parameters, optimizer state and step bit-identical on the card."""
    import torch
    from repro_torch import convert
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.data import pipeline
    from repro_torch.train import trainer

    def config(n):
        return (family_config(arch, n) if arch
                else lm_config(n, "bfloat16"))

    cfg = config(n_layers)
    # one checkpoint: bf16 params widened to fp32, int8 moments, fp32 scales
    est = cfg.param_count() * (4 + 2 + 2 * 4 / 64)
    free = shutil.disk_usage(ROOT).free
    if free < 2.5 * est:           # two checkpoints at once, and a margin
        n_layers = 1
        cfg = config(1)
    root = ROOT / "build" / "train_resume"
    shutil.rmtree(root, ignore_errors=True)
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, batch=B, seq=S, seed=seed + 24)

    restore_s = []

    def timed_restore(*args, **kw):       # the Trainer's resume, timed
        t0 = time.perf_counter()
        out = restore(*args, **kw)
        sync(device)
        restore_s.append(time.perf_counter() - t0)
        return out

    def run(tag, steps, write=True):
        tcfg = trainer.TrainerConfig(steps=steps, ckpt_every=100,
                                     ckpt_dir=str(root / tag),
                                     optimizer="adam8bit", lr=TRAIN_LR,
                                     log_every=100)
        tr = trainer.Trainer(cfg, dcfg, tcfg, device=device,
                             log_fn=lambda s: None)
        tr.ckpt = _TimedCheckpointer(write)
        t0 = time.perf_counter()
        out = tr.run(seed=seed + 25)
        sync(device)
        return out, tr.ckpt, time.perf_counter() - t0

    whole, _, whole_s = run("whole", 2, write=False)
    want = convert.train_state_to_numpy(whole["state"])
    del whole
    first, first_ck, _ = run("broken", 1)
    ckpt_bytes = _dir_bytes(root / "broken" / "step_1")
    del first
    restore, trainer.ckpt_lib.restore = trainer.ckpt_lib.restore, timed_restore
    try:
        resumed, second_ck, resumed_s = run("broken", 2)
    finally:
        trainer.ckpt_lib.restore = restore
    got = convert.train_state_to_numpy(resumed["state"])
    differ = [k for (k, a), (_, b) in zip(_flatten(got), _flatten(want))
              if not (a.shape == b.shape and (a == b).all())]
    row = {"phase": "train_families" if arch else "train", "part": "resume",
           "arch": cfg.arch_id, "layers": [n_layers, config(None).n_layers],
           "optimizer": "adam8bit",
           "B": B, "S": S, "steps": 2, "resumed_at": 1,
           "history_steps": [h["step"] for h in resumed["history"]],
           "differing_leaves": differ, "step": int(resumed["state"].step),
           "ckpt_bytes": ckpt_bytes, "disk_free_bytes": free,
           "save_host_copy_s": first_ck.save_s + second_ck.save_s,
           "save_write_s": first_ck.wait_s + second_ck.wait_s,
           "restore_s": restore_s, "uninterrupted_run_s": whole_s,
           "uninterrupted_run_saved": False,
           "resumed_run_s": resumed_s, "embedding_backward": "F.embedding"}
    emit(row)
    shutil.rmtree(root, ignore_errors=True)
    if differ or row["step"] != 2 or row["history_steps"] != [2]:
        fail(f"train: the resumed run differs from the uninterrupted one: {differ}")
    del resumed
    torch.cuda.empty_cache()


def phase_train_embedding(device, B=TRAIN_B, S=TRAIN_S, iters=5):
    """What makes the embedding gather's gradient repeat bit for bit: the
    gather's own backward (``index_put_`` with accumulate) against
    `F.embedding`'s, at gemma3-4b's table and the full run's tokens, twice
    each, timed forward + backward."""
    import torch
    import torch.nn.functional as F
    cfg = lm_config()
    gen = torch.Generator(device=device).manual_seed(32)
    table = torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=device,
                        dtype=torch.bfloat16)
    tokens = torch.from_numpy(_train_tokens(cfg, B, S, 33)).to(device)
    go = torch.randn((B, S, cfg.d_model), generator=gen, device=device,
                     dtype=torch.bfloat16)
    ways = {"index": lambda t: t[tokens], "embedding": lambda t: F.embedding(tokens, t)}
    row = {"phase": "train", "part": "embedding_backward", "B": B, "S": S,
           "vocab": cfg.vocab, "d_model": cfg.d_model,
           "distinct_tokens": int(tokens.unique().numel())}
    for name, fn in ways.items():
        leaf = table.detach().requires_grad_()

        def grad():
            return torch.autograd.grad(fn(leaf), leaf, go)[0]

        a, b = grad(), grad()
        row[f"{name}_repeats_bitwise"] = bool(torch.equal(a, b))
        row[f"{name}_fwd_bwd_ms"] = time_ms(grad, iters, device)
    emit(row)
    if not row["embedding_repeats_bitwise"]:
        fail("train: F.embedding's backward does not repeat bit for bit")


def phase_train_yardstick(device, B=TRAIN_B, S=TRAIN_S, iters=3):
    """Attention forward + backward of one gemma3-4b global layer and one
    local (1024-window) layer at the full run's B x S, bf16: the port's
    flash `Function` against `scaled_dot_product_attention` with the same
    mask (a yardstick only; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import flash
    cfg = lm_config()
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=device).manual_seed(34)
    mk = lambda *s: torch.randn(s, generator=gen, device=device,
                                dtype=torch.bfloat16)
    q, k, v, go = mk(B, S, H, dh), mk(B, S, Hkv, dh), mk(B, S, Hkv, dh), mk(B, S, H, dh)
    pos = torch.arange(S, device=device)
    out = []
    for window in (0, cfg.local_window):
        mask = pos[None, :] <= pos[:, None]
        if window:
            mask &= pos[None, :] > pos[:, None] - window

        def port():
            a, b, c = (t.detach().requires_grad_() for t in (q, k, v))
            o = flash.flash_attention(a, b, c, causal=True, window=window)
            o.backward(go)
            return o

        def sdpa():
            a, b, c = (t.detach().requires_grad_() for t in (q, k, v))
            kk = b.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
            vv = c.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
            o = F.scaled_dot_product_attention(
                a.transpose(1, 2), kk, vv, attn_mask=mask if window else None,
                is_causal=not window).transpose(1, 2)
            o.backward(go)
            return o

        err = _leaf_err(port(), sdpa())
        # causal: half the (S, S) products; a window of W: about S * W
        live = S * (S + 1) / 2 if not window else S * window - window * (window - 1) / 2
        flops = 4 * B * H * live * dh * 3.5      # fwd 2 products, bwd 5
        out.append({"window": window, "port_ms": time_ms(port, iters, device, 1),
                    "sdpa_ms": time_ms(sdpa, iters, device, 1),
                    "o_err_rel": err, "flops": flops,
                    "bf16_bound_ms": flops / 989e12 * 1e3,
                    # the port's block products are fp32 (TF32 off)
                    "fp32_bound_ms": flops / PEAK_FP32_PER_S * 1e3})
    emit({"phase": "train", "part": "attention_yardstick", "B": B, "S": S,
          "heads": [H, Hkv, dh], "dtype": "bfloat16", "cases": out})


def phase_train(seed, device):
    """The training path: the full run, the flash check, the cross-checks,
    the embedding backward and the SDPA yardstick.  (gemma3-4b's `Trainer`
    resume, a 9.4 GB checkpoint, is cut for time: `train_families` resumes
    the `Trainer` on zamba2.)"""
    run = phase_train_full(seed, device)
    phase_train_flash(device)
    phase_train_cross_check(seed, device)
    phase_train_embedding(device)
    phase_train_yardstick(device)
    return run


# --------------------------------------------------------------------------
# phase 3f: the other model families' batched decode (lm_families)
# --------------------------------------------------------------------------

def family_config(arch, n_layers=None, dtype="bfloat16"):
    """``arch`` at its published width (`configs/<arch>.py`) in ``dtype``;
    ``n_layers`` cuts the depth, keeping the family's shape: a MoE stack
    keeps at least one MoE layer after its dense ones, an encoder-decoder
    cuts both stacks."""
    import dataclasses
    from repro_torch.configs import registry
    cfg = dataclasses.replace(registry.get_config(arch), param_dtype=dtype)
    return _cut_depth(cfg, n_layers)


def _cut_depth(cfg, n_layers):
    """``cfg`` cut to ``n_layers`` (None: whole), keeping the family's
    shape (`family_config`)."""
    import dataclasses
    if n_layers is None:
        return cfg
    cut = dict(n_layers=n_layers)
    if cfg.family == "moe":
        cut["n_dense_layers"] = min(cfg.n_dense_layers, n_layers - 1)
    if cfg.family == "encdec":
        cut["n_enc_layers"] = n_layers
    return dataclasses.replace(cfg, **cut)


def cross_layers(cfg):
    """The fp32 cross-check's depth: the family's smallest unit."""
    return {"moe": 2, "hybrid": cfg.attn_every, "ssm": None, "encdec": 2,
            "vlm": 2}[cfg.family]


def _weight_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def _frames(cfg, B, gen, device):
    """The stub audio frontend's output: ``enc_frames`` synthetic frame
    embeddings a request, float32."""
    import torch
    return torch.randn((B, cfg.enc_frames, cfg.d_model), generator=gen,
                       device=device)


def family_decode(seed, arch, n_layers, sketch, device, smi):
    """``arch`` in bf16 at its published width (depth ``n_layers`` or all),
    random weights from the seed: ``init_model`` → ``init_cache`` →
    (whisper: ``encode_cross_cache`` over the stub frontend's frames) →
    ``make_serve_step``; FAM_B requests of FAM_PROMPT prompt tokens fed one
    a step, then FAM_GEN greedy tokens, over an FAM_S-token cache.  Gates:
    finite logits and greedy ids in range at every step; with sketch on,
    one `sketch_decode_attn` launch a layer a step and no other kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.serve import kv_cache, serve_step
    cfg = family_config(arch, n_layers)
    full = family_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed + 40)
    t0 = time.perf_counter()
    params = model.init_model(cfg, gen, device)
    sync(device)
    init_s = time.perf_counter() - t0
    cache = kv_cache.init_cache(cfg, FAM_B, FAM_S, sketch=sketch, device=device)
    encode_s = None
    if cfg.family == "encdec":
        frames = _frames(cfg, FAM_B, gen, device)
        sync(device)
        t0 = time.perf_counter()
        cache = serve_step.encode_cross_cache(params, cfg, frames, cache)
        sync(device)
        encode_s = time.perf_counter() - t0
        if not all(bool(torch.isfinite(cache[n]).all()) for n in ("xk", "xv")):
            fail(f"lm_families {arch}: the cross cache is not finite")
    step = serve_step.make_serve_step(cfg, sketch=sketch)
    prompts = torch.from_numpy(np.random.default_rng(seed + 42).integers(
        0, cfg.vocab, (FAM_B, FAM_PROMPT))).to(device)
    n_steps = FAM_PROMPT + FAM_GEN
    zero = lambda: torch.zeros((), dtype=torch.int64, device=device)
    nonfinite, bad_ids, live_sum = zero(), zero(), zero()
    times = []
    sync(device)
    ops.reset_launches()
    t_all = time.perf_counter()
    tok = prompts[:, :1]
    for t in range(n_steps):
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tok)
        nonfinite += (~torch.isfinite(logits)).sum()
        if t + 1 < FAM_PROMPT:
            tok = prompts[:, t + 1:t + 2]
        else:
            tok = logits.argmax(-1)
            bad_ids += ((tok < 0) | (tok >= cfg.vocab)).sum()
        if sketch:
            live_sum += torch.stack([n for _, n in step.last_live]).sum()
        sync(device)
        times.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    launches = dict(ops.LAUNCHES)
    want = {name: 0 for name in launches}
    if sketch:
        want["sketch_decode_attn"] = cfg.n_layers * n_steps
    if launches != want:
        fail(f"lm_families {arch}: launches {launches}, expected {want}")
    if int(nonfinite) or int(bad_ids):
        fail(f"lm_families {arch}: {int(nonfinite)} non-finite logits, "
             f"{int(bad_ids)} greedy ids out of range")
    if logits.shape != (FAM_B, 1, cfg.vocab) or cache["length"] != n_steps:
        fail(f"lm_families {arch}: logits {tuple(logits.shape)}, "
             f"length {cache['length']}")
    peak = torch.cuda.max_memory_allocated()
    holder = {"cache": cache, "tok": tok}

    def one_step():
        lg, holder["cache"] = step(params, holder["cache"], holder["tok"])
        holder["tok"] = lg.argmax(-1)

    prof = profile_window(f"lm_families_{arch}_decode_step", one_step, device)
    ms = sorted(x * 1e3 for x in times[1:])
    row = {"phase": "lm_families", "arch": arch, "family": cfg.family,
           "dtype": cfg.param_dtype, "nvidia_smi": smi,
           "layers_run": [cfg.n_layers, full.n_layers],
           "d_model": cfg.d_model, "vocab": cfg.vocab, "sketch": sketch,
           "B": FAM_B, "s_max": FAM_S, "prompt_tokens": FAM_PROMPT,
           "generated_tokens": FAM_GEN, "steps": n_steps,
           "weight_bytes": _weight_bytes(params),
           "cache_bytes": kv_cache.cache_bytes(holder["cache"]),
           "peak_memory_bytes": peak, "init_s": init_s, "encode_s": encode_s,
           "first_step_ms": times[0] * 1e3, "step_ms_median": ms[len(ms) // 2],
           "step_ms_p90": ms[int(0.9 * len(ms))], "wall_s": wall,
           "tokens_per_s": FAM_B * n_steps / wall,
           "device_busy_share": prof["device_busy_share"],
           "device_busy_ms": prof["device_busy_ms"],
           "device_ops": prof["device_ops"],
           "top_device_ops": prof["top_device_ops"][:5],
           "launches": launches}
    if cfg.family == "moe":
        row["experts"] = [cfg.n_experts, cfg.moe_topk, cfg.n_shared_experts]
    kernel_row = None
    if sketch:
        row["mean_live_blocks_per_global_layer"] = float(live_sum) / (
            cfg.n_layers * FAM_B * n_steps)
        row["in_range_blocks_last_step"] = -(-n_steps // LM_BLOCK)
        # the kernel at this path's shape: the last layer's cache and the
        # live lists of the last step, a random q
        Hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
        c = holder["cache"]
        ids, n_live = step.last_live[-1]
        q = torch.randn((FAM_B, Hkv, cfg.n_heads // Hkv, dh), generator=gen,
                        device=device).to(c["k"].dtype)
        kernel_row = sda_row(f"lm_families_{arch}", q, c["k"][-1], c["v"][-1],
                             ids, n_live, c["length"], 0.0, device)
    emit(row)
    del params, cache, holder, step
    torch.cuda.empty_cache()
    return row, kernel_row


class _RouteLog:
    """Records, while installed, the expert ids and router probabilities of
    every MoE layer's routing (`models.moe._route`), on the CPU."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._orig = orig = moe._route

        def route(router_w, x_flat, topk):
            w, idx, aux = orig(router_w, x_flat, topk)
            probs = torch.softmax(x_flat.float() @ router_w, dim=-1)
            self.calls.append((idx.cpu(), probs.cpu()))
            return w, idx, aux

        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self._orig

    def take(self):
        out, self.calls = self.calls, []
        return out


def _route_ties(card, cpu):
    """(mismatched route entries, those of them that are not near ties)
    between two steps' route logs: a mismatch is a near tie where the two
    experts' CPU probabilities lie within FAM_ROUTE_TIE of the larger."""
    mism = unexplained = 0
    for (ia, _), (ib, pb) in zip(card, cpu):
        rows, cols = (ia != ib).nonzero(as_tuple=True)
        for t, j in zip(rows.tolist(), cols.tolist()):
            a, b = float(pb[t, ia[t, j]]), float(pb[t, ib[t, j]])
            mism += 1
            unexplained += abs(a - b) > FAM_ROUTE_TIE * max(a, b)
    return mism, unexplained


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _host_params(params, routes=None, base=None):
    """The card's fp32 tree on the CPU.  A MoE stack's expert weights come
    over only for the experts ``routes`` (one route log entry a MoE layer)
    names, into tensors allocated but not written elsewhere (their pages
    untouched): the others receive no rows.  ``base`` (returned second) is
    the tree with the expert leaves still on the card, copied once."""
    import torch

    def copy(tree, in_moe=False):
        return {k: copy(v, k == "moe") if isinstance(v, dict) else
                (v if in_moe and k in EXPERT_LEAVES else v.cpu())
                for k, v in tree.items()}

    if base is None:        # the MTP head serves training only: left behind
        base = copy({k: v for k, v in params.items() if k != "mtp"})
    if "moe_blocks" not in params:
        return base, base
    experts = {}
    for name in EXPERT_LEAVES:
        src = params["moe_blocks"]["moe"][name]
        out = torch.empty(src.shape, dtype=src.dtype)
        for layer, (idx, _) in enumerate(routes or ()):
            e = torch.unique(idx.reshape(-1))
            out[layer, e] = src[layer, e.to(src.device)].cpu()
        experts[name] = out
    mb = base["moe_blocks"]
    tree = {**base, "moe_blocks": {**mb, "moe": {**mb["moe"], **experts}}}
    return tree, base


def _leaf_rel(a, b) -> float:
    """max |a - b| over max |b|, on the CPU in float32."""
    a, b = a.cpu().float(), b.cpu().float()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))




def family_cross_check(seed, arch, device, smi):
    """``arch`` at full width in fp32 (TF32 off), depth cut to the
    family's smallest unit (`cross_layers`), on the card and on the CPU
    (plain versions) from one tree, one cache (internvl2: the injected
    state at FAM_CROSS_LEN with sketch on; whisper: each device encodes the
    same frames) and the same FAM_CROSS_STEPS tokens: logits within
    FAM_LOGIT_TOL of their largest, every float cache leaf within
    FAM_CACHE_TOL of its largest, signature bits equal except at sign
    boundaries and live sets equal, MoE routes equal except at counted near
    ties.  Then the same tree cast to bf16 (the FP32_LEAVES kept) on the
    card over the same tokens: each step's logit cosine with the fp32 run's
    at least FAM_BF16_COSINE."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.models import model
    from repro_torch.serve import kv_cache, serve_step
    cfg = family_config(arch, None, "float32")
    cfg = family_config(arch, cross_layers(cfg), "float32")
    sketch = cfg.family == "vlm"
    B, steps = FAM_CROSS_B, FAM_CROSS_STEPS
    gen = torch.Generator(device=device).manual_seed(seed + 43)
    params = model.init_params(cfg, gen, device)
    tokens = np.random.default_rng(seed + 44).integers(0, cfg.vocab, (B, steps))
    cpu = torch.device("cpu")

    def fresh_cache(d, c):
        if sketch:
            state = injected_lm_state(c, B, FAM_CROSS_S, FAM_CROSS_LEN, seed + 45)
            cache = convert.lm_cache_from_numpy(state, d)
            dt = model._dtype(c)
            return {k: v.to(dt) if k in ("k", "v") else v
                    for k, v in cache.items()}
        return kv_cache.init_cache(c, B, FAM_CROSS_S, device=d)

    frames = (_frames(cfg, B, torch.Generator().manual_seed(seed + 46), cpu)
              if cfg.family == "encdec" else None)

    def start(tree, c, d):
        cache = fresh_cache(d, c)
        if frames is not None:
            cache = serve_step.encode_cross_cache(tree, c, frames.to(d), cache)
        return cache

    t0 = time.perf_counter()
    caches = {"card": start(params, cfg, device)}
    step = serve_step.make_serve_step(cfg, sketch=sketch)
    host, base = _host_params(params)
    caches["cpu"] = start(host, cfg, cpu)
    logits32, logit_err, mism, unexplained, tie_step = [], 0.0, 0, 0, None
    live_equal, pruned, cpu_s = True, 0, 0.0
    with _RouteLog() as log:
        for t in range(steps):
            tok = torch.from_numpy(tokens[:, t:t + 1])
            lg, caches["card"] = step(params, caches["card"], tok.to(device))
            sync(device)
            card_routes = log.take()
            live_card = live_sets(step.last_live) if sketch else None
            if cfg.family == "moe":
                host, _ = _host_params(params, card_routes, base)
            t1 = time.perf_counter()
            lc, caches["cpu"] = step(host, caches["cpu"], tok)
            cpu_s += time.perf_counter() - t1
            cpu_routes = log.take()
            logits32.append(lg)
            if not torch.isfinite(lg).all():
                fail(f"lm_families cross-check {arch}: logits not finite")
            m, u = _route_ties(card_routes, cpu_routes)
            mism, unexplained = mism + m, unexplained + u
            if m:
                tie_step = t
                break
            logit_err = max(logit_err, _leaf_rel(lg, lc))
            if sketch:
                live_equal &= live_card == live_sets(step.last_live)
                in_range = -(-(FAM_CROSS_LEN + t + 1) // LM_BLOCK)
                pruned += sum(len(s) < in_range for layer in live_card
                              for s in layer)
    cache_err, bf16_leaf_err, flips = {}, {}, None
    if tie_step is None:
        for name, want in caches["cpu"].items():
            if name in ("length", "block_sigs"):
                continue
            err = _leaf_rel(caches["card"][name], want)
            if want.dtype == torch.bfloat16:    # whisper's cross cache
                bf16_leaf_err[name] = err
            else:
                cache_err[name] = err
        if sketch:
            flips = _sig_flips(caches["card"], caches["cpu"], FAM_CROSS_LEN,
                               steps)
    card_s = time.perf_counter() - t0 - cpu_s
    del host, base, caches, step      # the step's views hold fp32 leaves
    # bf16 on the card over the same tokens
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16")

    def to_bf16(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                to_bf16(v)
            elif k not in FP32_LEAVES:
                tree[k] = v.to(torch.bfloat16)
    to_bf16(params)
    cache16 = start(params, cfg16, device)
    step16 = serve_step.make_serve_step(cfg16, sketch=sketch)
    cosines = []
    for t, lg32 in enumerate(logits32):
        tok = torch.from_numpy(tokens[:, t:t + 1]).to(device)
        lg, cache16 = step16(params, cache16, tok)
        cosines.append(float(torch.nn.functional.cosine_similarity(
            lg.reshape(B, -1).double(), lg32.reshape(B, -1).double(),
            dim=-1).min()))
    row = {"phase": "lm_families_cross_check", "arch": arch,
           "nvidia_smi": smi, "family": cfg.family,
           "layers": [cfg.n_layers, family_config(arch).n_layers],
           "d_model": cfg.d_model, "B": B, "steps": steps,
           "sketch": sketch, "max_logit_err_rel": logit_err,
           "cache_err_rel": cache_err, "tolerance": [FAM_LOGIT_TOL,
                                                     FAM_CACHE_TOL],
           "bf16_leaf_err_rel": bf16_leaf_err,
           "bf16_leaf_tolerance": FAM_BF16_LEAF_TOL,
           "route_mismatches": mism, "route_mismatches_not_ties": unexplained,
           "compared_steps": steps if tie_step is None else tie_step,
           "bf16_logit_cosine_min": min(cosines),
           "bf16_cosine_bound": FAM_BF16_COSINE,
           "card_s": card_s, "cpu_s": cpu_s}
    if sketch:
        row.update(sig_flips=flips, live_sets_equal=live_equal,
                   pruned_layer_requests=pruned)
    emit(row)
    if unexplained:
        fail(f"lm_families cross-check {arch}: {unexplained} expert ids "
             "differ away from a near tie")
    if logit_err > FAM_LOGIT_TOL or any(e > FAM_CACHE_TOL
                                        for e in cache_err.values()) \
            or any(e > FAM_BF16_LEAF_TOL for e in bf16_leaf_err.values()):
        fail(f"lm_families cross-check {arch}: card and CPU disagree "
             f"({logit_err}, {cache_err})")
    if sketch and (flips[1] or not live_equal or not pruned):
        fail(f"lm_families cross-check {arch}: signatures {flips}, live sets "
             f"equal {live_equal}, pruned {pruned}")
    if min(cosines) < FAM_BF16_COSINE:
        fail(f"lm_families cross-check {arch}: bf16 logit cosine "
             f"{min(cosines)} < {FAM_BF16_COSINE}")
    del params, cache16
    torch.cuda.empty_cache()
    return row


def phase_lm_families(seed, device):
    """Each configuration of FAMILY_RUNS in turn, its weights and cache
    freed before the next: the bf16 decode at full width, then its fp32
    card-vs-CPU and bf16-vs-fp32 checks at cut depth.  Returns the launch
    counts of the decode runs and the kernel row of internvl2's shape."""
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    launches, kernel_rows = {}, []
    for arch, n_layers, sketch in FAMILY_RUNS:
        gc.collect()                   # the last configuration's leaves
        torch.cuda.empty_cache()
        row, krow = family_decode(seed, arch, n_layers, sketch, device, smi)
        for name, n in row["launches"].items():
            launches[name] = launches.get(name, 0) + n
        if krow is not None:
            kernel_rows.append(krow)
        family_cross_check(seed, arch, device, smi)
    if not launches.get("sketch_decode_attn"):
        fail("lm_families: sketch_decode_attn was not launched")
    torch.cuda.empty_cache()
    return {"launches": launches, "kernel_rows": kernel_rows}


# --------------------------------------------------------------------------
# phase 3g: the other model families' training (train_families)
# --------------------------------------------------------------------------

class _CheckedMonitor:
    """The `DriftMonitor` of a run, checked at every batch: its codes on
    the card (`srp_hash`) against the plain version on the CPU (flips only
    at sign boundaries), and its state after the commit
    (`swakde_segment_pass`) bit for bit against a CPU twin fed the card's
    codes through the plain commit, density within 1e-6.  Each observe
    must launch each of the two kernels once and nothing else; the launches
    of the checks themselves are not counted."""

    def __init__(self, monitor, device, where):
        from repro_torch.core import swakde
        self.monitor, self.device, self.where = monitor, device, where
        self.cpu_params = monitor.params._replace(
            proj=monitor.params.proj.cpu(), mix=monitor.params.mix.cpu())
        self.twin = swakde.swakde_init(monitor.cfg, "cpu")
        self.flips, self.density_err, self.ms = 0, 0.0, []
        self.launches = None

    def observe(self, tokens):
        from repro_torch.core import swakde
        from repro_torch.core.util import mean_last
        from repro_torch.kernels import ops
        codes, n = _drift_codes_check(self.monitor, self.cpu_params, tokens,
                                      self.device)
        self.flips += n
        codes = codes.cpu()
        cfg = self.monitor.cfg
        want = float(mean_last(swakde.swakde_row_estimates_from_codes(
            self.twin, codes[-1], cfg)))
        self.twin = swakde.swakde_commit_chunk(
            self.twin, swakde.swakde_prepare_from_codes(codes[:-1], cfg), cfg)
        before = dict(ops.LAUNCHES)
        sync(self.device)
        t0 = time.perf_counter()
        drift = self.monitor.observe(tokens)          # ends in a host read
        self.ms.append((time.perf_counter() - t0) * 1e3)
        per = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        if per != {k: int(k in ("srp_hash", "swakde_segment_pass"))
                   for k in ops.LAUNCHES}:
            fail(f"{self.where}: the drift monitor launched {per}")
        self.launches = {k: (self.launches or {}).get(k, 0) + v
                         for k, v in per.items()}
        differ = differing_leaves(self.monitor.state, self.twin)
        err = abs(drift["density"] - want) / max(abs(want), 1e-30)
        self.density_err = max(self.density_err, err)
        if differ or err > 1e-6:
            fail(f"{self.where}: the drift monitor's state differs from the "
                 f"plain commit of its codes in {differ}, density "
                 f"{drift['density']} against {want}")
        return drift


def family_train(seed, arch, n_layers, how, B, S, device, smi):
    """``arch`` in bf16 at its published width (depth ``n_layers`` or all),
    random weights from the seed, trained ``TRAIN_FAM_STEPS`` steps and one
    profiled: through the `Trainer` (AdamW, the token stream and its drift
    monitor, checked at every batch by `_CheckedMonitor`; no checkpoint
    written), ``make_train_step`` (AdamW; frames or patches from
    ``launch.inputs.make_batch``) or ``grads_and_metrics`` alone (no
    optimizer).  Gates: finite loss and gradient norm at every step; no
    kernel launched by a step; the monitor's launches, one ``srp_hash`` and
    one ``swakde_segment_pass`` a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint.checkpoint import tree_leaves
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import inputs
    from repro_torch.models import model
    from repro_torch.optim import adam
    from repro_torch.train import train_step as ts
    from repro_torch.train import trainer
    cfg = family_config(arch, n_layers)
    steps = TRAIN_FAM_STEPS + 1
    where = f"train_families {arch}"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed + 60)
    calls, prof_box = [], {}

    def run_step(fn):
        """One step (``fn`` returns the metrics last), the last one under
        the profiler; no kernel may launch inside."""
        calls.append(1)
        before = dict(ops.LAUNCHES)
        sync(device)
        last = len(calls) == steps
        acts = ([ProfilerActivity.CUDA] if device.type == "cuda"
                else [ProfilerActivity.CPU])
        with (profile(activities=acts) if last
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            out = fn()
            m = out[-1]
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            wall = time.perf_counter() - t0
        if last:
            prof_box.update(prof=prof)
        if dict(ops.LAUNCHES) != before:
            fail(f"{where}: step {len(calls)} launched a kernel")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"{where}: step {len(calls)} loss {loss} grad norm {gnorm}")
        rows.append({"step": len(calls), "ms": wall * 1e3, "loss": loss,
                     "grad_norm": gnorm, "profiled": last})
        return out

    rows, monitor, state = [], None, None
    t0 = time.perf_counter()
    if how == "trainer":
        ckpt_dir = ROOT / "build" / "train_families"
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        dcfg = pipeline.DataConfig(vocab=cfg.vocab, batch=B, seq=S,
                                   seed=seed + 61)
        tcfg = trainer.TrainerConfig(steps=steps, ckpt_every=10**9,
                                     ckpt_dir=str(ckpt_dir), optimizer="adamw",
                                     lr=TRAIN_LR, log_every=10**9)
        tr = trainer.Trainer(cfg, dcfg, tcfg, device=device,
                             log_fn=lambda s: None)
        tr.ckpt = _TimedCheckpointer(write=False)
        tr.monitor = monitor = _CheckedMonitor(tr.monitor, device, where)
        step_fn = tr._step_fn
        tr._step_fn = lambda state, batch: run_step(
            lambda: step_fn(state, batch))
        state = tr.run(seed=seed + 62)["state"]
        params, init_s = state.params, None
    elif how == "step":
        step_fn, init = ts.make_train_step(cfg, adam.adamw(lr=TRAIN_LR))
        state = init(gen, device)
        sync(device)
        init_s = time.perf_counter() - t0
        for _ in range(steps):
            batch = inputs.make_batch(cfg, B, S, gen)
            state, m = run_step(lambda: step_fn(state, batch))
        params = state.params
    else:                       # one microbatch's gradients, no optimizer
        params = model.init_params(cfg, gen, device)
        sync(device)
        init_s = time.perf_counter() - t0
        for _ in range(steps):
            batch = inputs.make_batch(cfg, B, S, gen)

            def grads():
                g, m = ts.grads_and_metrics(params, cfg, batch)
                m["grad_norm"] = ts.grad_norm(g)
                return m,

            run_step(grads)
    peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(params)
    t1 = time.perf_counter()
    busy_ms, n_ops, top = device_profile(prof_box.pop("prof"))
    reduce_s = time.perf_counter() - t1
    tokens = B * (S if cfg.family != "vlm" else S - cfg.n_patches)
    steady = sorted(r["ms"] for r in rows[1:-1])
    step_ms = steady[len(steady) // 2]
    row = {"phase": "train_families", "arch": arch, "family": cfg.family,
           "how": how, "nvidia_smi": smi, "dtype": cfg.param_dtype,
           "layers_run": [cfg.n_layers, family_config(arch).n_layers],
           "d_model": cfg.d_model, "vocab": cfg.vocab, "B": B, "S": S,
           "loss_tokens_per_step": tokens,
           "params": sum(p.numel() for p in leaves),
           "param_bytes": sum(p.numel() * p.element_size() for p in leaves),
           "optimizer": None if how == "grads" else "adamw",
           "remat": cfg.remat, "init_s": init_s, "steps": rows,
           "step_ms_first": rows[0]["ms"], "step_ms_median": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "loss_falling": rows[-1]["loss"] < rows[0]["loss"],
           "peak_memory_bytes": peak,
           "profiled_step_ms": rows[-1]["ms"], "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / rows[-1]["ms"],
           "device_busy_over_median_step": busy_ms / step_ms,
           "device_ops": n_ops, "profile_reduce_s": reduce_s,
           "top_device_ops": top}
    if cfg.family == "moe":
        row["experts"] = [cfg.n_experts, cfg.moe_topk, cfg.n_shared_experts,
                          cfg.capacity_factor]
    if monitor is not None:
        row.update(drift_ms=monitor.ms, launches=monitor.launches,
                   monitor_code_flips=monitor.flips,
                   monitor_state_equals_cpu=True,
                   monitor_density_err_rel_max=monitor.density_err)
        if monitor.launches["srp_hash"] != steps:
            fail(f"{where}: the drift monitor ran {monitor.launches}")
    emit(row)
    del params, leaves, state
    gc.collect()
    torch.cuda.empty_cache()
    return row


class _FollowRoutes:
    """While installed, every MoE routing (`models.moe._route`) on the
    CPU takes the expert ids the card chose for the same layer (``card``,
    one entry a call, from a `_RouteLog`), its weights and aux loss
    recomputed from its own probabilities at those ids.  An id that differs
    must be a near tie (the two experts' CPU probabilities within
    FAM_ROUTE_TIE of the larger): counted; any other fails.  So one fp32
    rounding across a tie cannot move a token to another expert between
    the two runs being compared."""

    def __init__(self, card):
        self.card, self.i, self.mism = card, 0, 0

    def __enter__(self):
        import torch
        from repro_torch.core.util import fp32_reciprocal
        from repro_torch.models import moe
        self._orig = orig = moe._route

        def route(router_w, x_flat, topk):
            w, idx, aux = orig(router_w, x_flat, topk)
            want = self.card[self.i][0].to(idx.device)
            self.i += 1
            probs = torch.softmax(x_flat.float() @ router_w, dim=-1)
            m, u = _route_ties([(want, None)], [(idx, probs.detach())])
            if u:
                fail(f"train_families: {u} expert ids differ between the "
                     "card and the CPU away from a near tie")
            if not m:
                return w, idx, aux
            self.mism += m
            w = probs.gather(1, want)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
            E = router_w.shape[1]
            f = torch.zeros((E,), dtype=torch.float32, device=idx.device)
            f.index_add_(0, want.reshape(-1),
                         torch.ones((want.numel(),), dtype=torch.float32))
            f = f * fp32_reciprocal(want.numel())
            pbar = probs.sum(0) * fp32_reciprocal(probs.shape[0])
            return w, want, E * torch.sum(f * pbar)

        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self._orig


def family_train_cross_check(seed, arch, device, smi):
    """``arch`` at full width in fp32 (TF32 off), depth cut to the family's
    smallest unit (moe 1 dense + 1 MoE layer, hybrid one group, ssm one
    pair, encdec 1 + 1, vlm 1 layer; deepseek-v3 at its ``smoke()`` width,
    a full-width fp32 MoE layer being 45 GB a copy), B = 2 over
    TRAIN_FAM_CROSS_S tokens (and the published frames or patches): the
    loss and every gradient leaf of one ``grads_and_metrics`` on the card
    against the CPU's plain path, from the same tree and batch (the CPU
    follows the card's expert ids at near ties, `_FollowRoutes`).  (The
    bf16-against-fp32 check of the same tree is cut for time.)"""
    import dataclasses
    import torch
    from repro_torch.checkpoint.checkpoint import _flatten, tree_map
    from repro_torch.configs import registry
    from repro_torch.launch import inputs
    from repro_torch.models import model
    from repro_torch.train import train_step as ts
    full = family_config(arch)
    if arch == "deepseek-v3-671b":
        cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                  param_dtype="float32")
    else:
        unit = {"moe": 2, "hybrid": full.attn_every, "ssm": 2, "encdec": 1,
                "vlm": 1}[full.family]
        cfg = family_config(arch, unit, "float32")
    B, S = TRAIN_FAM_CROSS_B, TRAIN_FAM_CROSS_S
    seq = S + (cfg.n_patches if cfg.family == "vlm" else 0)
    params = model.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed + 70), device)
    batch = inputs.make_batch(cfg, B, seq,
                              torch.Generator().manual_seed(seed + 71))
    host = tree_map(lambda t: t.to("cpu", copy=True), params)
    t0 = time.perf_counter()
    with _RouteLog() as log:
        g_dev, m_dev = ts.grads_and_metrics(
            params, cfg, {k: v.to(device) for k, v in batch.items()})
        sync(device)
        card_s = time.perf_counter() - t0
        card_routes = log.take()
    t0 = time.perf_counter()
    with _FollowRoutes(card_routes) as follow:
        g_cpu, m_cpu = ts.grads_and_metrics(host, cfg, batch)
    cpu_s = time.perf_counter() - t0
    del host
    loss_err = {k: abs(float(m_dev[k]) - float(m_cpu[k]))
                / max(abs(float(m_cpu[k])), 1e-30) for k in m_cpu}
    grad_err = {k: _leaf_err(a, b) for (k, a), (_, b) in
                zip(_flatten(g_dev), _flatten(g_cpu))}
    del g_cpu
    grad_tol = TRAIN_FAM_SSD_TOL if cfg.family == "hybrid" else TRAIN_FAM_GRAD_TOL
    row = {"phase": "train_families_cross_check", "arch": arch,
           "nvidia_smi": smi, "family": cfg.family,
           "layers": [cfg.n_layers, full.n_layers], "d_model": cfg.d_model,
           "width": "smoke" if cfg.d_model != full.d_model else "published",
           "B": B, "S": seq, "fp32_loss": float(m_dev["loss"]),
           "metrics_err_rel": loss_err,
           "grad_err_rel_max": max(grad_err.values()),
           "grad_err_rel_worst_leaf": max(grad_err, key=grad_err.get),
           "tolerance": [TRAIN_FAM_LOSS_TOL, grad_tol],
           "route_near_ties_followed": follow.mism,
           "card_s": card_s, "cpu_s": cpu_s}
    emit(row)
    if max(loss_err.values()) > TRAIN_FAM_LOSS_TOL \
            or max(grad_err.values()) > grad_tol:
        fail(f"train_families cross-check {arch}: card and CPU disagree "
             f"({loss_err}, {row['grad_err_rel_worst_leaf']} "
             f"{row['grad_err_rel_max']})")
    del params, g_dev
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_train_families(seed, device):
    """Each configuration of TRAIN_FAMILY_RUNS in turn, its weights,
    optimizer state and gradients freed before the next: the bf16 training
    run at full width, then its fp32 card-vs-CPU check at cut depth; last
    the Trainer's resume on zamba2 at one group.  Returns
    the drift monitor's launch counts."""
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    launches = {}
    for arch, n_layers, how, B, S in TRAIN_FAMILY_RUNS:
        row = family_train(seed, arch, n_layers, how, B, S, device, smi)
        for name, n in row.get("launches", {}).items():
            launches[name] = launches.get(name, 0) + n
        family_train_cross_check(seed, arch, device, smi)
    phase_train_resume(seed, device, n_layers=6, arch="zamba2-2.7b")
    torch.cuda.empty_cache()
    return {"launches": launches}


# --------------------------------------------------------------------------
# lm_mesh: LM training on a (data, model) mesh
# --------------------------------------------------------------------------

def sync_all():
    """Wait for every visible card (a mesh may span them)."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _mesh_cards(mesh) -> list:
    return sorted({d.index for d in mesh.devices})


def _reckon_mesh_bytes(cfg, mesh, optimizer="adamw") -> dict:
    """Each card's bytes of a training step's state, from `param_specs`
    over the global shapes (meta tensors): a rank holds its block of every
    leaf (a leaf that does not split, whole) of the weights, their
    gradients, ``optimizer``'s state (its init over the meta tree, placed
    by `param_specs.opt_state_shardings`) and, with microbatches, the
    accumulator (``grad_accum_dtype``) and its float32 average."""
    import torch
    from repro_torch.models import layers, model
    from repro_torch.optim import adam
    from repro_torch.parallel import param_specs, sharding
    normal = layers._normal
    layers._normal = lambda gen, shape, scale, dtype, device: torch.empty(
        shape, dtype=dtype, device=device)
    try:
        tree = model.init_params(cfg, torch.Generator(), "meta")
    finally:
        layers._normal = normal
    state = adam.OPTIMIZERS[optimizer]().init(tree)
    specs = param_specs.param_shardings(tree, mesh,
                                        fsdp_over_pod=cfg.fsdp_over_pod)
    o_specs = param_specs.opt_state_shardings(state, specs, mesh)
    acc = 0
    if cfg.grad_microbatches > 1:
        acc = (2 if cfg.grad_accum_dtype == "bfloat16" else 4) + 4
    per_rank = [0] * mesh.size

    def add(x, spec, per_elem):
        for r in range(mesh.size):
            n = math.prod(sz for _, sz in sharding._blocks(
                tuple(x.shape), spec, mesh, r)) if x.dim() else 1
            per_rank[r] += n * per_elem(x)
    for _, x, spec in param_specs.leaves_with_paths(tree, specs):
        add(x, spec, lambda x: 2 * x.element_size() + acc)
    for _, x, spec in param_specs.leaves_with_paths(state, o_specs):
        add(x, spec, lambda x: x.element_size())
    cards = {}
    for r, d in enumerate(mesh.devices):
        cards[d.index] = cards.get(d.index, 0) + per_rank[r]
    return cards


def _route_capture():
    """Records every rank's MoE input as `models.moe.moe_ranks` sees it."""
    from repro_torch.models import moe
    inputs, orig = [], moe.moe_ranks

    def capture(params, xs, mesh, **kw):
        inputs.append([x.detach() for x in xs])
        return orig(params, xs, mesh, **kw)
    return inputs, orig, capture


def _per_shard_aux(cfg, params, inputs, nm):
    """The reference's per-shard estimate of the aux loss: each MoE
    layer's router on every rank's own input (`moe._route`), averaged over
    the ranks, summed over the layers, times ``moe_aux_coef / nm``."""
    from repro_torch.models import moe
    total = 0.0
    for i in range(nm):
        router = params["moe_blocks"]["moe"]["router"][i]
        vals = [float(moe._route(router.to(x.device),
                                 x.reshape(-1, x.shape[-1]), cfg.moe_topk)[2])
                for x in inputs[i]]
        total += sum(vals) / len(vals)
    return total * cfg.moe_aux_coef / nm


def _gate_config(arch, layers=None, width="published"):
    """An fp32 gate's configuration: ``arch`` at its ``width`` (published,
    or its smoke config's) cut to ``layers``, one microbatch, the MoE
    dropless."""
    import dataclasses
    from repro_torch.configs import registry
    if width == "smoke":
        cfg = _cut_depth(dataclasses.replace(registry.get_smoke_config(arch),
                                             param_dtype="float32"), layers)
    else:
        cfg = family_config(arch, layers, "float32")
    cfg = dataclasses.replace(cfg, grad_microbatches=1)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_topk)
    return cfg


def _gate_batch(cfg, B, S, seed, device) -> dict:
    """The token stream's batch of B x S, and the stub frontend's frames
    or patches from `launch.inputs.make_batch` (bfloat16) on ``device``."""
    import torch
    from repro_torch.launch import inputs
    batch = {"tokens": torch.from_numpy(_train_tokens(cfg, B, S, seed))}
    if cfg.family in ("vlm", "encdec"):
        gen = torch.Generator(device=device).manual_seed(seed)
        seq = S + (cfg.n_patches if cfg.family == "vlm" else 0)
        made = inputs.make_batch(cfg, B, seq, gen)
        batch.update({k: v for k, v in made.items() if k != "tokens"})
    return batch


def _steps_apart(got, want, gtol):
    """Two one-step results ``(parameters, AdamW's first moment)``: the
    largest parameter error, its ratio to the reference's bound (rtol
    MESH_RTOL, atol MESH_ATOL, plus 2 MESH_GATE_LR where the update's sign
    is free: the two gradients differ by more than half ``want``'s, or
    ``want``'s is under 100 eps), the largest gradient error over its
    leaf's largest and ``gtol(name)``, and how many parameters only the
    sign-free rule holds."""
    import torch
    from repro_torch.checkpoint.checkpoint import _flatten
    pieces = lambda t: t.reshape(-1).split(CMP_PIECE)   # bounded temporaries
    worst_abs, worst_ratio, worst_grad, sign_free = 0.0, 0.0, 0.0, 0
    for (k, a), (_, b), (_, ga), (_, gb) in zip(
            _flatten(got[0]), _flatten(want[0]), _flatten(got[1]),
            _flatten(want[1])):
        top = max(float(p.abs().max()) for p in pieces(gb))
        for a, b, ga, gb in zip(pieces(a), pieces(b), pieces(ga), pieces(gb)):
            b, gb = b.float().to(a.device), gb.to(a.device)
            worst_grad = max(worst_grad, float((ga - gb).abs().max())
                             / max(top, 1e-30) / gtol(k))
            free = ((ga - gb).abs() > 0.5 * gb.abs()) | (gb.abs() <= 1e-7)
            d = (a.float() - b).abs()
            bound = MESH_ATOL + MESH_RTOL * b.abs()
            worst_abs = max(worst_abs, float(d.max()))
            worst_ratio = max(worst_ratio, float((d / (
                bound + torch.where(free, 2 * MESH_GATE_LR, 0.0))).max()))
            sign_free += int(((d > bound) & free).sum())
    return worst_abs, worst_ratio, worst_grad, sign_free


def mesh_step_gate(seed, arch, mesh, device, smi, layers=None,
                   S=MESH_GATE_S, width="published"):
    """``arch`` in fp32 at its ``width`` (`_gate_config`; depth
    ``layers``, by default the family's smallest unit): one
    AdamW step of the same state and batch sharded on ``mesh``, then
    unsharded on ``device``; loss (and MTP cross-entropy) and every
    parameter within the reference's bounds; the MoE aux against the
    per-shard estimate.  The sharded step's parameters and first moment
    are gathered and its state dropped before the unsharded step, whose
    parameters are drawn again from the seed."""
    import torch
    from repro_torch.models import model, moe
    from repro_torch.optim import adam
    from repro_torch.parallel import param_specs
    from repro_torch.train import train_step as ts
    if layers is None:
        layers = 1 if arch == "qwen3-4b" else 2
    cfg = _gate_config(arch, layers, width)
    where = f"lm_mesh gate {arch}"
    gc.collect()
    torch.cuda.empty_cache()
    t_gate = time.perf_counter()
    draw = lambda: model.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed + 80), device)
    batch = _gate_batch(cfg, MESH_GATE_B, S, seed + 81, device)
    opt = adam.adamw(lr=MESH_GATE_LR, warmup=1)
    mstep, _ = ts.make_train_step(cfg, opt, mesh)
    sharded = param_specs.shard_params(draw(), mesh)
    mstate = ts.TrainState(params=sharded,
                           opt_state=adam.init_on_mesh(opt, sharded),
                           step=torch.zeros((), dtype=torch.int32,
                                            device=mesh.devices[0]))
    del sharded
    gc.collect()
    torch.cuda.empty_cache()
    inputs, orig, capture = _route_capture()
    moe.moe_ranks = capture
    try:
        sync_all()
        t0 = time.perf_counter()
        mstate, mm = mstep(mstate, batch)
        sync_all()
        mesh_ms = (time.perf_counter() - t0) * 1e3
    finally:
        moe.moe_ranks = orig
    got = param_specs.gather_params(mstate.params)
    got_m = param_specs.gather_params(mstate.opt_state.m)
    del mstate
    gc.collect()
    torch.cuda.empty_cache()
    params = draw()
    want_aux = (_per_shard_aux(cfg, params, inputs,
                               cfg.n_layers - cfg.n_dense_layers)
                if cfg.family == "moe" else 0.0)
    del inputs
    step, _ = ts.make_train_step(cfg, opt)
    state = ts.TrainState(params=params, opt_state=opt.init(params),
                          step=torch.zeros((), dtype=torch.int32, device=device))
    del params
    sync(device)
    t0 = time.perf_counter()
    state, m = step(state, {k: v.to(device) for k, v in batch.items()})
    sync(device)
    single_ms = (time.perf_counter() - t0) * 1e3
    want = (state.params, state.opt_state.m)
    del state                   # AdamW's second moment, not compared
    gc.collect()
    torch.cuda.empty_cache()
    gtol = lambda k: MESH_GRAD_TOL["router" if k.endswith("router")
                                   else cfg.family]
    worst_abs, worst_ratio, worst_grad, sign_free = _steps_apart(
        (got, got_m), want, gtol)
    gn_err = abs(float(mm["grad_norm"]) / float(m["grad_norm"]) - 1)
    gn_tol = MESH_GRAD_TOL[cfg.family]
    key = "ce" if cfg.family == "moe" else "loss"
    loss_err = abs(float(mm[key]) - float(m[key]))
    mtp_err = abs(float(mm["mtp_ce"]) - float(m["mtp_ce"])) \
        if "mtp_ce" in m else 0.0
    aux_err = (abs(float(mm["moe_aux"]) - want_aux) / max(abs(want_aux), 1e-30)
               if cfg.family == "moe" else 0.0)
    row = {"phase": "lm_mesh", "part": "fp32_gate", "arch": arch,
           "nvidia_smi": smi, "mesh": dict(mesh.shape),
           "cards": _mesh_cards(mesh), "layers_run": cfg.n_layers,
           "width": width, "B": MESH_GATE_B, "S": S,
           "inputs": {k: list(v.shape) for k, v in batch.items()},
           "capacity_factor": cfg.capacity_factor if cfg.family == "moe" else None,
           "loss_single": float(m["loss"]), "loss_sharded": float(mm["loss"]),
           f"{key}_abs_err": loss_err, "param_max_abs_err": worst_abs,
           "param_err_over_bound": worst_ratio,
           "params_free_sign_over_strict_bound": sign_free,
           "grad_err_over_bound": worst_grad, "grad_tol": MESH_GRAD_TOL,
           "grad_norm_rel_err": gn_err, "lr": MESH_GATE_LR,
           "moe_aux_sharded": float(mm["moe_aux"]),
           "moe_aux_per_shard_estimate": want_aux,
           "moe_aux_single": float(m["moe_aux"]), "moe_aux_rel_err": aux_err,
           "grad_norm_single": float(m["grad_norm"]),
           "grad_norm_sharded": float(mm["grad_norm"]),
           "single_step_ms": single_ms, "sharded_step_ms": mesh_ms}
    if "mtp_ce" in m:
        row.update(mtp_ce_single=float(m["mtp_ce"]),
                   mtp_ce_sharded=float(mm["mtp_ce"]), mtp_ce_abs_err=mtp_err)
    del got, got_m, want
    gc.collect()
    torch.cuda.empty_cache()
    row["gate_s"] = time.perf_counter() - t_gate
    emit(row)
    if loss_err > MESH_LOSS_TOL or mtp_err > MESH_LOSS_TOL \
            or worst_ratio > 1.0 or aux_err > 1e-5 \
            or worst_grad > 1.0 or gn_err > gn_tol:
        fail(f"{where}: {key} err {loss_err}, mtp err {mtp_err}, parameters "
             f"at {worst_ratio} of the bound, gradients at {worst_grad}, grad "
             f"norm err {gn_err}, aux err {aux_err}")
    return row


def mesh_moe_ep_gate(seed, mesh, device, smi):
    """`moe_ep` against `moe_dense` at deepseek-moe-16b's published width
    (d 2048, 64 experts top-6, 2 shared), one layer in bf16."""
    import torch
    from repro_torch.models import moe
    from repro_torch.parallel import param_specs
    from repro_torch.parallel.sharding import make_ctx
    cfg = family_config("deepseek-moe-16b")
    gen = torch.Generator(device=device).manual_seed(seed + 82)
    p = moe.init_moe(gen, cfg.d_model, cfg.n_experts, cfg.n_shared_experts,
                     cfg.d_ff_expert, torch.bfloat16, device)
    x = torch.randn((MESH_EP_B, MESH_EP_S, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16)
    ctx = make_ctx(mesh)
    sh = param_specs.shard_params({"moe": p}, mesh)["moe"]
    xs = ctx.constrain(x, "batch", None, None)
    k = cfg.moe_topk
    with torch.no_grad():
        want, aux_d = moe.moe_dense(p, x, topk=k, capacity_factor=64.0)
        sync_all()
        t0 = time.perf_counter()
        got, aux = moe.moe(sh, xs, topk=k, capacity_factor=64.0, ctx=ctx)
        sync_all()
        ep_ms = (time.perf_counter() - t0) * 1e3
        got = got.full(device)
        est = [float(moe._route(p["router"].to(t.device),
                                t.reshape(-1, cfg.d_model), k)[2])
               for t in xs.shards]
    est = sum(est) / len(est)
    d = (got.float() - want.float()).abs()
    ratio = float((d / (2e-2 + 2e-2 * want.float().abs())).max())
    mean = float(d.mean())
    aux_err = abs(float(aux) - est) / abs(est)
    row = {"phase": "lm_mesh", "part": "moe_ep_gate", "nvidia_smi": smi,
           "mesh": dict(mesh.shape), "d_model": cfg.d_model,
           "experts": [cfg.n_experts, k, cfg.n_shared_experts],
           "tokens": MESH_EP_B * MESH_EP_S, "capacity_factor": 64.0,
           "max_abs_err": float(d.max()), "mean_abs_err": mean,
           "err_over_bound": ratio, "aux_ep": float(aux),
           "aux_per_shard_estimate": est, "aux_dense": float(aux_d),
           "aux_rel_err": aux_err, "ep_ms": ep_ms}
    emit(row)
    if ratio > 1.0 or mean >= 5e-3 or aux_err > 1e-5:
        fail(f"lm_mesh: moe_ep against moe_dense at {ratio} of the bound, "
             f"mean error {mean}, aux err {aux_err}")
    del p, sh, x, xs, got, want
    torch.cuda.empty_cache()
    return row


def mesh_compress_gate(seed, device, smi):
    """The int8 compressed all-reduce with error feedback over an 8-rank
    ``data`` axis (one device repeated): 20 steps within 2% of the exact
    running sum, under 30% of the bytes (the reference's bounds)."""
    import torch
    from repro_torch.optim import compress
    from repro_torch.parallel.sharding import Mesh
    mesh = Mesh((device,) * 8, axis_names=("data",))
    gen = torch.Generator(device=device).manual_seed(seed + 83)
    g = torch.randn((8, 4, 130), generator=gen, device=device)
    err = compress.init_error_state([{"w": g[r]} for r in range(8)])
    tot, exact = torch.zeros_like(g[0]), torch.zeros_like(g[0])
    for i in range(20):
        gi = g * (1 + 0.01 * i)
        red, err = compress.compressed_pmean([{"w": gi[r]} for r in range(8)],
                                             err, mesh, "data")
        tot += red[0]["w"]
        exact += gi.mean(0)
    rel = float((tot - exact).abs().max() / exact.abs().max())
    exact_b, comp_b = compress.bytes_saved_per_step({"w": g[0]})
    row = {"phase": "lm_mesh", "part": "compress_gate", "nvidia_smi": smi,
           "ranks": 8, "steps": 20, "accum_rel_err": rel,
           "bytes_exact": exact_b, "bytes_compressed": comp_b}
    emit(row)
    if rel >= 0.02 or comp_b >= 0.3 * exact_b:
        fail(f"lm_mesh: compressed all-reduce {rel} off, {comp_b}/{exact_b} "
             "bytes")
    return row


def _host_waits_of(prof):
    """The host's waits on the device in a profile (its synchronize calls,
    `SYNC_EVENTS`, from the raw runtime events), or None where the profile
    recorded no runtime call at all (the window's closing synchronize is
    one)."""
    n = sum(1 for e in prof.profiler.kineto_results.events()
            if e.name() in SYNC_EVENTS)
    return n or None


def _busy_by_card(prof) -> dict:
    """Device busy ms of a profile, by card."""
    busy = {}
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        dur = (e.duration_ns() if hasattr(e, "duration_ns")
               else e.duration_us() * 1000)
        i = e.device_index()
        busy[i] = busy.get(i, 0) + dur / 1e6
    return busy


def mesh_train_run(seed, mesh, run, device, smi):
    """``run`` = (arch, depth, B, S, optimizer, steps): ``arch`` in bf16 at
    its published width (``depth`` layers, or all), random weights from the
    seed, on ``mesh`` through the `Trainer` (``optimizer``, the model's
    published microbatches, the token stream and its drift monitor checked
    at every batch, no checkpoint), ``steps`` steps and one profiled.
    Gates: finite loss and gradient norm, no kernel launched by a step,
    the monitor's one `srp_hash` and one `swakde_segment_pass` a step.
    Each card's peak against `_reckon_mesh_bytes`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.train import trainer
    arch, n_layers, B, S, optimizer, n_steps = run
    cfg = family_config(arch, n_layers)
    steps = n_steps + 1
    where = f"lm_mesh run {arch} {cfg.n_layers} layers"
    cards = _mesh_cards(mesh)
    reckoned = _reckon_mesh_bytes(cfg, mesh, optimizer)
    gc.collect()
    torch.cuda.empty_cache()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    rows, prof_box = [], {}

    def run_step(fn):
        last = len(rows) + 1 == steps
        before = dict(ops.LAUNCHES)
        sync_all()
        with (profile(activities=[ProfilerActivity.CUDA]) if last
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            out = fn()
            m = out[-1]
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            sync_all()
            wall = time.perf_counter() - t0
        if last:
            prof_box["prof"] = prof
        if dict(ops.LAUNCHES) != before:
            fail(f"{where}: step {len(rows) + 1} launched a kernel")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"{where}: step {len(rows) + 1} loss {loss} grad norm {gnorm}")
        rows.append({"step": len(rows) + 1, "ms": wall * 1e3, "loss": loss,
                     "grad_norm": gnorm, "moe_aux": float(m["moe_aux"]),
                     **({"mtp_ce": float(m["mtp_ce"])} if "mtp_ce" in m
                        else {}),
                     "profiled": last})
        return out

    ckpt_dir = ROOT / "build" / "lm_mesh"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, batch=B, seq=S,
                               seed=seed + 84)
    tcfg = trainer.TrainerConfig(steps=steps, ckpt_every=0,
                                 ckpt_dir=str(ckpt_dir), optimizer=optimizer,
                                 lr=TRAIN_LR, log_every=10**9)
    t0 = time.perf_counter()
    tr = trainer.Trainer(cfg, dcfg, tcfg, mesh=mesh, log_fn=lambda s: None)
    tr.monitor = monitor = _CheckedMonitor(tr.monitor, mesh.devices[0], where)
    step_fn = tr._step_fn
    tr._step_fn = lambda state, batch: run_step(lambda: step_fn(state, batch))
    state = tr.run(seed=seed + 85)["state"]
    total_s = time.perf_counter() - t0
    peaks = {c: torch.cuda.max_memory_allocated(c) for c in cards}
    busy = _busy_by_card(prof_box["prof"])
    waits = _host_waits_of(prof_box["prof"])
    _, n_ops, top = device_profile(prof_box.pop("prof"))
    steady = sorted(r["ms"] for r in rows[1:-1]) or [rows[-1]["ms"]]
    step_ms = steady[len(steady) // 2]
    tokens = B * S
    prof_ms = rows[-1]["ms"]
    row = {"phase": "lm_mesh", "part": "train_run", "arch": cfg.arch_id,
           "nvidia_smi": smi, "mesh": dict(mesh.shape), "cards": cards,
           "layers_run": [cfg.n_layers, family_config(cfg.arch_id).n_layers],
           "dtype": cfg.param_dtype, "B": B, "S": S,
           "rank_rows": B // mesh.shape["data"],
           "grad_microbatches": cfg.grad_microbatches,
           "grad_accum_dtype": cfg.grad_accum_dtype,
           "optimizer": optimizer, "remat": cfg.remat, "steps": rows,
           "step_ms_first": rows[0]["ms"], "step_ms_median": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "ms_per_layer": step_ms / cfg.n_layers,
           "reckoned_gb_by_card": {c: b / 1e9 for c, b in reckoned.items()},
           "peak_gb_by_card": {c: b / 1e9 for c, b in peaks.items()},
           "profiled_step_ms": prof_ms,
           "busy_ms_by_card": busy,
           "busy_share_by_card": {c: v / prof_ms for c, v in busy.items()},
           "device_ops": n_ops, "host_waits": waits, "top_device_ops": top,
           "run_s": total_s, "drift_ms": monitor.ms,
           "launches": monitor.launches,
           "monitor_code_flips": monitor.flips,
           "monitor_density_err_rel_max": monitor.density_err}
    emit(row)
    if monitor.launches["srp_hash"] != steps or \
            monitor.launches["swakde_segment_pass"] != steps:
        fail(f"{where}: the drift monitor ran {monitor.launches}")
    del state, tr
    gc.collect()
    torch.cuda.empty_cache()
    return row


def mesh_four_cards_gate(seed, smi):
    """deepseek-v3's smoke step in fp32 (`_gate_config`: MLA, the MoE
    expert-parallel, the MTP head; one AdamW step of MESH_FOUR_B x
    MESH_FOUR_S tokens) on cards 0..3 as data 2 x model 2, twice: bit for
    bit; and against the same mesh on card 0 repeated: metrics within 1e-6
    relative, gradients within 1e-4 of their largest, parameters at the
    reference's bounds (`_steps_apart`).  Only the order in which the
    cards' backward threads add a block's terms may differ."""
    import torch
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model
    from repro_torch.optim import adam
    from repro_torch.parallel import param_specs
    from repro_torch.train import train_step as ts
    cfg = _gate_config("deepseek-v3-671b", width="smoke")
    tree = model.init_params(cfg, torch.Generator().manual_seed(seed + 86),
                             "cpu")
    tokens = torch.from_numpy(_train_tokens(cfg, MESH_FOUR_B, MESH_FOUR_S,
                                            seed + 87))

    def run(mesh):
        opt = adam.adamw(lr=MESH_GATE_LR, warmup=1)
        step, _ = ts.make_train_step(cfg, opt, mesh)
        params = param_specs.shard_params(tree, mesh)
        state = ts.TrainState(params, adam.init_on_mesh(opt, params),
                              torch.zeros((), dtype=torch.int32,
                                          device=mesh.devices[0]))
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": tokens})
        sync_all()
        ms = (time.perf_counter() - t0) * 1e3
        return (param_specs.gather_params(state.params, "cpu"),
                param_specs.gather_params(state.opt_state.m, "cpu"),
                {k: float(v) for k, v in m.items()}, ms)

    four = make_test_mesh(*MESH_SHAPE, "cuda")
    a, b = run(four), run(four)
    repeats = a[2] == b[2] and all(
        torch.equal(x, y) for t, u in zip(a[:2], b[:2])
        for (_, x), (_, y) in zip(_flatten(t), _flatten(u)))
    one = run(make_test_mesh(*MESH_SHAPE, torch.device("cuda", 0)))
    metric_err = max(abs(a[2][k] - v) / max(abs(v), 1e-30)
                     for k, v in one[2].items())
    worst_abs, worst_ratio, worst_grad, sign_free = _steps_apart(
        a[:2], one[:2], lambda k: 1e-4)
    row = {"phase": "lm_mesh", "part": "four_cards_gate",
           "arch": cfg.arch_id, "width": "smoke", "nvidia_smi": smi,
           "mesh": dict(four.shape), "cards": _mesh_cards(four),
           "B": MESH_FOUR_B, "S": MESH_FOUR_S,
           "repeats_bit_for_bit": repeats, "metrics_four": a[2],
           "metrics_one_card": one[2], "metric_rel_err": metric_err,
           "param_max_abs_err": worst_abs, "param_err_over_bound": worst_ratio,
           "params_free_sign_over_strict_bound": sign_free,
           "grad_err_over_bound": worst_grad, "step_ms_four": a[3],
           "step_ms_one_card": one[3]}
    emit(row)
    if not repeats or metric_err > 1e-6 or worst_ratio > 1.0 \
            or worst_grad > 1.0:
        fail(f"lm_mesh four cards: repeats {repeats}, metrics {metric_err}, "
             f"parameters at {worst_ratio} of the bound, gradients at "
             f"{worst_grad}")
    return row


def phase_lm_mesh(seed, device, cards=1):
    """LM training on a (data, model) mesh: one card repeated as a 2 x 2
    mesh (``cards`` 1), or cards 0..3 as data 2 x model 2 (``cards`` 4).
    Returns the drift monitor's launch counts over the Trainer runs."""
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    if cards == 1:
        mesh = make_test_mesh(*MESH_SHAPE, torch.device(
            "cuda", torch.cuda.current_device()))
    else:
        mesh = make_test_mesh(*MESH_SHAPE, "cuda")
    mesh_step_gate(seed, "qwen3-4b", mesh, device, smi)
    mesh_step_gate(seed, "deepseek-moe-16b", mesh, device, smi)
    for arch, layers, S, width in MESH_FAMILY_GATES:
        mesh_step_gate(seed, arch, mesh, device, smi, layers, S, width)
    mesh_moe_ep_gate(seed, mesh, device, smi)
    if cards == 1:
        mesh_compress_gate(seed, device, smi)
    else:
        mesh_four_cards_gate(seed, smi)
    launches = {}
    for run in MESH_RUNS if cards == 1 else MESH_RUNS_4:
        row = mesh_train_run(seed, mesh, run, device, smi)
        launches = {k: launches.get(k, 0) + v
                    for k, v in row["launches"].items()}
    return {"launches": launches}


# --------------------------------------------------------------------------
# lm_mesh_decode: batched decode on a (data, model) mesh
# --------------------------------------------------------------------------

def _shard_consuming(tree, mesh):
    """`param_specs.shard_params` of ``tree`` leaf by leaf, each leaf of
    the one-device tree dropped once placed (no second whole copy)."""
    from repro_torch.parallel import param_specs
    from repro_torch.parallel.sharding import shard_tensor
    specs = param_specs.param_shardings(tree, mesh)

    def walk(t, s):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], s[k])
            else:
                t[k] = shard_tensor(t[k], s[k], mesh)
    walk(tree, specs)
    return tree


def _inject_prefix(cache, start, gen):
    """A one-device cache with a random prefix of ``start`` tokens: random
    k / v / latents below ``start`` and block signatures up to its block,
    random Mamba2 states and conv tails."""
    import torch
    for name, v in cache.items():
        if name in ("k", "v", "dk", "dv", "c", "kr") and start:
            v[:, :, :start] = torch.randn(v[:, :, :start].shape, generator=gen,
                                          device=v.device).to(v.dtype)
        elif name == "block_sigs":
            nb = start // LM_BLOCK + 1
            v[:, :, :nb] = torch.rand(v[:, :, :nb].shape, generator=gen,
                                      device=v.device) < 0.5
        elif name in ("ssm_state", "conv_buf") and start:
            v.copy_(torch.randn(v.shape, generator=gen, device=v.device))
    cache["length"] = start
    return cache


def _dropless(cfg):
    """A MoE config at capacity factor n_experts / topk (C = T): the mesh's
    ranks size their capacity by their own rows, as the reference's
    ``moe_ep`` does, so only where nothing drops does a token's output not
    depend on how the batch is split."""
    import dataclasses
    if cfg.family != "moe":
        return cfg
    return dataclasses.replace(cfg, capacity_factor=max(
        cfg.capacity_factor, cfg.n_experts / cfg.moe_topk))


def _gathered_cache(cache, device):
    from repro_torch.parallel.sharding import Sharded
    return {k: v.full(device) if isinstance(v, Sharded) else v
            for k, v in cache.items()}


def mesh_decode_gate(seed, arch, layers, B, s_max, start, sketch, mesh,
                     device, smi):
    """``arch`` in fp32 (TF32 off) at its published width (deepseek-v3 at
    its smoke width), depth cut to ``layers``: MDEC_GATE_STEPS decode steps
    from one cache with a random prefix of ``start`` tokens, on one device
    and on ``mesh`` (weights by `param_specs`, the cache by `cache_specs`),
    the same tokens: logits within MDEC_LOGIT_TOL of their largest, the
    written k / v and latents within MDEC_KV_TOL of their largest, the
    recurrent states within MDEC_STATE_TOL, block signatures equal (but at
    the new keys' sign boundaries) and the live lists equal."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.parallel import param_specs
    from repro_torch.serve import kv_cache, serve_step
    if layers == "smoke":
        cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                  param_dtype="float32")
    else:
        cfg = family_config(arch, layers, "float32")
    cfg = _dropless(cfg)
    steps = MDEC_GATE_STEPS
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(seed + 90)
    params = model.init_params(cfg, gen, device)
    cache1 = _inject_prefix(kv_cache.init_cache(cfg, B, s_max, sketch=sketch,
                                                device=device), start, gen)
    cachem = kv_cache.shard_cache(cache1, cfg, mesh)
    pm = param_specs.shard_params(params, mesh)
    if cfg.family == "encdec":
        frames = _frames(cfg, B, gen, device)
        cache1 = serve_step.encode_cross_cache(params, cfg, frames, cache1)
        cachem = serve_step.encode_cross_cache(pm, cfg, frames, cachem)
    step1 = serve_step.make_serve_step(cfg, sketch=sketch)
    stepm = serve_step.make_serve_step(cfg, sketch=sketch, mesh=mesh)
    tokens = torch.from_numpy(np.random.default_rng(seed + 91).integers(
        0, cfg.vocab, (B, steps))).to(device)
    logit_err, live_equal, live_lists = 0.0, True, 0
    ops.reset_launches()
    for t in range(steps):
        l1, cache1 = step1(params, cache1, tokens[:, t:t + 1])
        lm, cachem = stepm(pm, cachem, tokens[:, t:t + 1])
        if lm.shape != l1.shape or lm.dtype != l1.dtype \
                or lm.device != mesh.devices[0]:
            fail(f"lm_mesh_decode gate {arch}: logits {lm.shape} {lm.dtype} "
                 f"on {lm.device}")
        logit_err = max(logit_err, _leaf_rel(lm, l1))
        live_lists += len(stepm.last_live)
        live_equal &= live_sets(stepm.last_live) == live_sets(step1.last_live)
    launches = ops.LAUNCHES["sketch_decode_attn"]
    full = _gathered_cache(cachem, device)
    errs, sig_equal, flips = {}, True, None
    for name, want in cache1.items():
        if name == "length":
            continue
        got = full[name]
        if want.dtype == torch.bool:
            sig_equal = bool(torch.equal(got, want))
            continue
        fin = torch.isfinite(want)
        if not torch.equal(torch.isfinite(got), fin):
            fail(f"lm_mesh_decode gate {arch}: {name} finite elsewhere")
        errs[name] = _leaf_rel(got[fin], want[fin])
    if not sig_equal:
        flips = _sig_flips({"block_sigs": full["block_sigs"].cpu()},
                           {k: cache1[k].cpu() for k in ("k", "block_sigs")},
                           start, steps)
    kv_err = max((v for k, v in errs.items()
                  if k in ("k", "v", "dk", "dv", "c", "kr")), default=0.0)
    state_err = max((v for k, v in errs.items()
                     if k not in ("k", "v", "dk", "dv", "c", "kr", "xk",
                                  "xv")), default=0.0)
    ba, sa = kv_cache.cache_axes(cfg, B, mesh)
    row = {"phase": "lm_mesh_decode", "part": "fp32_gate", "arch": arch,
           "family": cfg.family, "nvidia_smi": smi, "mesh": dict(mesh.shape),
           "cards": _mesh_cards(mesh), "layers": cfg.n_layers,
           "width": "smoke" if layers == "smoke" else "published",
           "B": B, "s_max": s_max, "start_length": start, "steps": steps,
           "batch_axes": ba, "seq_axes": sa, "sketch": sketch,
           "max_logit_err_rel": logit_err, "cache_err_rel": errs,
           "kv_err_rel": kv_err, "state_err_rel": state_err,
           "tolerance": {"logits": MDEC_LOGIT_TOL, "kv": MDEC_KV_TOL,
                         "states": MDEC_STATE_TOL},
           "block_sigs_equal": sig_equal, "sig_flips": flips,
           "live_lists": live_lists, "live_lists_equal": live_equal,
           "sketch_decode_attn_launches": launches}
    emit(row)
    if logit_err > MDEC_LOGIT_TOL or kv_err > MDEC_KV_TOL \
            or state_err > MDEC_STATE_TOL:
        fail(f"lm_mesh_decode gate {arch}: logits {logit_err}, kv {kv_err}, "
             f"states {state_err}")
    if (flips is not None and flips[1]) or (not live_equal and flips is None):
        fail(f"lm_mesh_decode gate {arch}: signatures {flips}, live lists "
             f"equal {live_equal}")
    if sketch and not launches:
        fail(f"lm_mesh_decode gate {arch}: sketch_decode_attn not launched")
    del params, pm, cache1, cachem, full
    gc.collect()
    torch.cuda.empty_cache()
    return row


def sda_partial_row(name, q, k, v, live, kv_len, shards, device):
    """`sketch_decode_attn_partial` on each of ``shards`` blocks of the
    sequence of ``k`` / ``v`` against its plain version (o and lse within
    SDA_ATOL + SDA_RTOL * |plain|), the blocks' partials merged
    (`merge_partials`) against the one-device kernel over the whole
    cache within the same bound; each block's call timed beside its plain
    version and SDPA over the block, with its byte and operation bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, sketch_decode_attn as sda
    from repro_torch.parallel import sharding
    B, S, Hkv, dh = k.shape
    G = q.shape[2]
    size = S // shards
    nbl = size // LM_BLOCK
    parts, err, calls = [], 0.0, []
    for r in range(shards):
        s0 = r * size
        kr, vr = k[:, s0:s0 + size].contiguous(), v[:, s0:s0 + size].contiguous()
        lv = live[:, r * nbl:(r + 1) * nbl]
        ids, n = sda.compact_live(lv)
        kl = min(max(kv_len - s0, 0), size)
        o, lse = sda.sketch_decode_attn_partial(q, kr, vr, ids, n, kl, LM_BLOCK)
        wo, wl = ref.sketch_decode_attn_partial_ref(q, kr, vr, lv, kl, LM_BLOCK)
        fin = torch.isfinite(wl)
        if not torch.equal(torch.isfinite(lse), fin) or not torch.allclose(
                o, wo, rtol=SDA_RTOL, atol=SDA_ATOL) or not torch.allclose(
                lse[fin], wl[fin], rtol=SDA_RTOL, atol=SDA_ATOL):
            fail(f"sketch_decode_attn partial differs from its plain version "
                 f"({name}, block {r})")
        err = max(err, float((o - wo).abs().max()),
                  float((lse[fin] - wl[fin]).abs().max()) if fin.any() else 0.0)
        parts.append((o, lse))
        calls.append((kr, vr, ids, n, kl, lv))
    mesh = sharding.Mesh((device,) * shards, ("model",))
    merged = sharding.merge_partials(parts, mesh, "model")[0]
    ids, n = sda.compact_live(live)
    whole = sda.sketch_decode_attn(q, k, v, ids, n, kv_len, LM_BLOCK)
    merge_err = float((merged - whole).abs().max())
    if not torch.allclose(merged, whole, rtol=SDA_RTOL, atol=SDA_ATOL):
        fail(f"sketch_decode_attn: {shards} merged partials differ from the "
             f"whole kernel ({name})")
    # one block's call timed: the block holding the most live rows
    kr, vr, ids, n, kl, lv = calls[-1] if kv_len > S - size else calls[0]
    pos = torch.arange(size, device=device)
    pos_live = lv[:, pos // LM_BLOCK] & (pos < kl)[None]
    n_pos = int(pos_live.sum())
    nbytes = (n_pos * Hkv * dh * 2 * k.element_size() + q.numel() * q.element_size()
              + B * Hkv * G * (dh + 1) * 4 + ids.numel() * 4 + n.numel() * 4)
    b_ms, b_by = bound(nbytes, 4.0 * n_pos * Hkv * G * dh)
    call = lambda: sda.sketch_decode_attn_partial(q, kr, vr, ids, n, kl,
                                                  LM_BLOCK)
    library_ms = None
    if n_pos:
        ql = q.reshape(B, Hkv * G, 1, dh)
        sdpa = lambda: F.scaled_dot_product_attention(
            ql, kr.transpose(1, 2), vr.transpose(1, 2),
            attn_mask=pos_live[:, None, None, :], enable_gqa=True)
        library_ms = time_ms(sdpa, 10, device)
    return {
        "name": "sketch_decode_attn", "entry": "partial", "case": name,
        "shape": [B, size, Hkv, G, dh], "blocks_of_sequence": shards,
        "kv_len": kv_len, "live_positions_timed_block": n_pos,
        "max_abs_err": err, "merged_vs_whole_max_abs_err": merge_err,
        "tolerance": [SDA_RTOL, SDA_ATOL],
        "ms": time_ms(call, 20, device), "graph_ms": graph_ms(call, device),
        "plain_ms": time_ms(lambda: ref.sketch_decode_attn_partial_ref(
            q, kr, vr, lv, kl, LM_BLOCK), 3, device),
        "library_ms": library_ms,
        "library": "F.scaled_dot_product_attention(attn_mask, enable_gqa) "
                   "over the block",
        "bound_ms": b_ms, "bound_by": b_by}


def check_sda_partial(device):
    """The partial entry against its plain version at the lm_long shape
    split in four (B = 1, 32 768 rows a block) and at the lm_serve shape
    (B = 4, 4096 rows in four blocks of 1024), half the sketch blocks live,
    gemma3-4b's heads; the four partials merged against the whole-cache
    kernel."""
    import torch
    cfg = lm_config()
    Hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_heads // Hkv
    gen = torch.Generator(device=device).manual_seed(19)
    rows = []
    for name, B, S, kv_len in (("lm_long", 1, LM_LONG_S, LM_LONG_LEN),
                               ("lm_serve", LM_B, LM_S, LM_S - 100)):
        k = torch.randn((B, S, Hkv, dh), generator=gen, device=device).to(torch.bfloat16)
        v = torch.randn((B, S, Hkv, dh), generator=gen, device=device).to(torch.bfloat16)
        q = torch.randn((B, Hkv, G, dh), generator=gen, device=device).to(torch.bfloat16)
        live = torch.rand((B, S // LM_BLOCK), generator=gen, device=device) < 0.5
        live[:, (kv_len - 1) // LM_BLOCK] = True
        rows.append(sda_partial_row(name, q, k, v, live, kv_len, 4, device))
        del k, v
    torch.cuda.empty_cache()
    return rows


def _reckon_decode_bytes(cfg, mesh, B, s_max, sketch) -> dict:
    """Each card's bytes of the weights by `param_specs` and of the cache by
    `cache_specs` (meta tensors): a rank holds its block of every leaf."""
    import torch
    from repro_torch.models import layers, model
    from repro_torch.parallel import param_specs, sharding
    from repro_torch.serve import kv_cache
    normal = layers._normal
    layers._normal = lambda gen, shape, scale, dtype, device: torch.empty(
        shape, dtype=dtype, device=device)
    try:
        tree = model.init_params(cfg, torch.Generator(), "meta")
    finally:
        layers._normal = normal
    leaves = [(x, spec) for _, x, spec in param_specs.leaves_with_paths(
        tree, param_specs.param_shardings(tree, mesh))]
    cache = kv_cache.init_cache(cfg, B, s_max, sketch=sketch, device="meta")
    specs = kv_cache.cache_specs(cache, cfg, B, mesh)
    leaves += [(x, specs[k]) for k, x in cache.items() if k != "length"]
    cards = {}
    for r, d in enumerate(mesh.devices):
        n = sum(math.prod(sz for _, sz in sharding._blocks(
            tuple(x.shape), spec, mesh, r)) * x.element_size()
            for x, spec in leaves)
        cards[d.index] = cards.get(d.index, 0) + n
    return cards


def long_cache_mesh(cfg, mesh, length, s_max, seed):
    """`long_cache`'s state made directly on ``mesh`` (a cache one card
    cannot hold): each layer drawn on the mesh's first card and each rank's
    block copied from it."""
    from repro_torch.serve import kv_cache
    cache = kv_cache.init_cache(cfg, 1, s_max, sketch=True, mesh=mesh)
    cache["length"] = length
    for layer, (k, v, sigs) in enumerate(_long_layers(
            cfg, mesh.devices[0], length, s_max, seed)):
        cache["k"][layer].read_from(k)
        cache["v"][layer].read_from(v)
        cache["block_sigs"][layer].read_from(sigs[None])
    return cache


class _FollowMesh:
    """While installed around a one-device decode step, its discrete
    choices are the mesh step's of the same token: each global layer's
    live list (`serve_step._live_blocks`) and each MoE layer's expert ids
    (`models.moe._route`, the weights and aux recomputed from its own
    probabilities at those ids).  Where its own choice differs it counts
    the layers whose live set differs, the blocks they differ by, and the
    expert ids that differ, so the comparison's cosine measures rounding
    and the counts say how often a choice flipped."""

    def __init__(self, lists, routes):
        self.lists, self.routes = list(lists), list(routes)
        self.live_layers = self.live_blocks = self.expert_ids = 0

    def __enter__(self):
        import torch
        from repro_torch.core.util import fp32_reciprocal
        from repro_torch.models import moe
        from repro_torch.serve import serve_step
        self._orig = (serve_step._live_blocks, moe._route)
        live_orig, route_orig = self._orig

        def live(q, sigs, length):
            ids, n = live_orig(q, sigs, length)
            want = self.lists.pop(0)
            a, b = live_sets([(ids, n)])[0], live_sets([want])[0]
            diff = sum(len(x ^ y) for x, y in zip(a, b))
            self.live_layers += int(diff > 0)
            self.live_blocks += diff
            return want

        def route(router_w, x_flat, topk):
            w, idx, aux = route_orig(router_w, x_flat, topk)
            want = self.routes.pop(0).to(idx.device)
            self.expert_ids += int((want.sort(-1)[0] != idx.sort(-1)[0]).sum())
            probs = torch.softmax(x_flat.float() @ router_w, dim=-1)
            w = probs.gather(1, want)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
            E = router_w.shape[1]
            f = torch.zeros((E,), dtype=torch.float32, device=idx.device)
            f.index_add_(0, want.reshape(-1),
                         torch.ones((want.numel(),), dtype=torch.float32,
                                    device=idx.device))
            f = f * fp32_reciprocal(want.numel())
            pbar = probs.sum(0) * fp32_reciprocal(probs.shape[0])
            return w, want, E * torch.sum(f * pbar)

        serve_step._live_blocks, moe._route = live, route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        from repro_torch.serve import serve_step
        serve_step._live_blocks, moe._route = self._orig


def _batch_firsts(cfg, B, mesh) -> list:
    """The first rank of each distinct batch block of the mesh decode, in
    batch order (`serve_step._Ranks.firsts`)."""
    from repro_torch.parallel import sharding
    from repro_torch.serve import kv_cache
    ba, _ = kv_cache.cache_axes(cfg, B, mesh)
    spec = (sharding.canonical(ba or ()),)
    rows = [sharding._blocks((B,), spec, mesh, r)[0] for r in range(mesh.size)]
    return [rows.index(x) for x in sorted(set(rows))]


def _sync_row(cache1, cachem, length):
    """Copy the mesh cache's row ``length`` (each leaf's owner block: k / v,
    and the block signatures of each batch block) into the one-device
    cache, so that both step on from one state."""
    from repro_torch.parallel import sharding
    for name, leaf in cachem.items():
        if name == "length":
            continue
        for r, block in leaf.distinct():
            (b0, nb), = sharding._blocks((leaf.shape[1],), (leaf.spec[1],),
                                         leaf.mesh, r)
            if name == "block_sigs":
                cache1[name][:, b0:b0 + nb].copy_(block)
                continue
            s0, size = _seq_start(leaf, r), block.shape[2]
            if s0 <= length < s0 + size:
                cache1[name][:, b0:b0 + nb, length].copy_(
                    block[:, :, length - s0])


def _mesh_weights(tree, mesh):
    """``tree`` placed on ``mesh`` by `param_specs`: on one card repeated,
    each rank's block a view of the tree's tensor (one copy of the weights
    on the card, which the one-device step also reads); across cards,
    `param_specs.shard_params`'s copies."""
    from repro_torch.parallel import param_specs, sharding
    dev = next(iter(param_specs.leaves_with_paths(tree)))[1].device
    if any(d != dev for d in mesh.devices):
        return param_specs.shard_params(tree, mesh)
    specs = param_specs.param_shardings(tree, mesh)

    def place(_, x, spec):
        views = []
        for r in range(mesh.size):
            v = x
            for d, (s0, n) in enumerate(sharding._blocks(tuple(x.shape), spec,
                                                         mesh, r)):
                v = v.narrow(d, s0, n)
            views.append(v)
        return sharding.Sharded(views, spec, mesh, tuple(x.shape))
    return param_specs.map_with_path(place, tree, specs)


def mesh_decode_run(seed, arch, mesh, B, s_max, start, steps, device, smi,
                    single=True, sum_dtype="float32"):
    """``arch`` in bf16 at its published width and depth, random weights
    from the seed, decoding teacher-forced tokens from a cache with a
    ``start``-token prompt injected (gemma3-4b: `long_cache`'s sparse block
    signatures, sketch on; deepseek-moe-16b: random k / v) on ``mesh``.
    With ``single``, each of ``steps`` mesh steps is held against the
    one-device step on the same weights from the same state (the mesh's
    new row copied into the one-device cache after each step), following
    the mesh step's live lists and expert ids (`_FollowMesh`, their flips
    counted): each step's logit cosine at least MDEC_BF16_COSINE; then, the
    one-device cache freed, MDEC_TAIL_STEPS more mesh steps.  Reported: the
    mesh step's median time over all its steps, tokens/s, peak memory a
    card over the last MDEC_TAIL_STEPS steps against the reckoning, busy
    share and device ops of the last step (profiled), and the kernel
    launches of every mesh step (gemma3-4b: every global layer on every
    rank whose block starts at or below the token).  ``sum_dtype`` is the
    mesh step's `serve_step.SUM_DTYPE`; with "bfloat16" (the reference's
    sums, a reading of what the port's float32 sums cost and buy) the
    cosine is reported and not gated."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models import model, moe
    from repro_torch.serve import kv_cache, serve_step
    cfg = _dropless(family_config(arch))
    sketch = arch == "gemma3-4b"
    cards = _mesh_cards(mesh)
    where = f"lm_mesh_decode run {arch} S={s_max} cards {cards}"
    gc.collect()
    torch.cuda.empty_cache()
    params1 = model.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed + 92), device)
    total = steps + (MDEC_TAIL_STEPS if single else 0)
    tokens = torch.from_numpy(np.random.default_rng(seed + 93).integers(
        0, cfg.vocab, (B, total))).to(device)
    cache1 = step1 = None
    if single:
        if sketch:
            cache1 = long_cache(cfg, device, start, s_max, seed + 94)
        else:
            gen = torch.Generator(device=device).manual_seed(seed + 95)
            cache1 = _inject_prefix(kv_cache.init_cache(
                cfg, B, s_max, device=device), start, gen)
        cachem = kv_cache.shard_cache(cache1, cfg, mesh)
        pm = _mesh_weights(params1, mesh)
        step1 = serve_step.make_serve_step(cfg, sketch=sketch)
    else:
        cachem = long_cache_mesh(cfg, mesh, start, s_max, seed + 94)
        pm = _shard_consuming(params1, mesh)
        params1 = None
    gc.collect()
    torch.cuda.empty_cache()
    reckoned = _reckon_decode_bytes(cfg, mesh, B, s_max, sketch)
    stepm = serve_step.make_serve_step(cfg, sketch=sketch, mesh=mesh)
    firsts = _batch_firsts(cfg, B, mesh)
    times, per_step, cosines, single_ms, got = [], [], [], [], []
    flips = {"live_layers": 0, "live_blocks": 0, "expert_ids": 0}
    route_orig = moe._route
    routes = []

    def route(router_w, x_flat, topk):
        out = route_orig(router_w, x_flat, topk)
        routes.append(out[1])
        return out
    prof = peaks = None
    sum_orig = serve_step.SUM_DTYPE
    for t in range(total):
        last = t == total - 1
        if t == steps and single:      # the tail: the mesh alone
            cache1 = step1 = None
            if any(d != device for d in mesh.devices):
                params1 = None         # not the mesh's weights
            gc.collect()
            torch.cuda.empty_cache()
        if t == (steps if single else 0):
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
        compare = single and t < steps
        routes.clear()
        moe._route = route
        serve_step.SUM_DTYPE = getattr(torch, sum_dtype)
        ops.reset_launches()
        try:
            sync_all()
            with (profile(activities=[ProfilerActivity.CUDA]) if last
                  else contextlib.nullcontext()) as p:
                t0 = time.perf_counter()
                lg, cachem = stepm(pm, cachem, tokens[:, t:t + 1])
                sync_all()
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            moe._route = route_orig
            serve_step.SUM_DTYPE = sum_orig
        per_step.append(ops.LAUNCHES["sketch_decode_attn"])
        if last:
            prof = p
            peaks = {c: torch.cuda.max_memory_allocated(c) for c in cards}
        if not torch.isfinite(lg).all():
            fail(f"{where}: logits not finite at step {t}")
        got.append(lg.cpu())
        if not compare:
            continue
        # the mesh's expert ids of each MoE layer, its batch blocks in order
        n = mesh.size
        layer_ids = [torch.cat([routes[i * n + r] for r in firsts])
                     for i in range(len(routes) // n)]
        length = cache1["length"]
        sync_all()
        t0 = time.perf_counter()
        with _FollowMesh(list(stepm.last_live), layer_ids) as follow:
            lg1, cache1 = step1(params1, cache1, tokens[:, t:t + 1])
        sync_all()
        single_ms.append((time.perf_counter() - t0) * 1e3)
        for key in flips:
            flips[key] += getattr(follow, key)
        cosines.append(float(torch.nn.functional.cosine_similarity(
            lg1.reshape(B, -1).double(), lg.reshape(B, -1).double().to(
                lg1.device), dim=-1).min()))
        _sync_row(cache1, cachem, length)
    busy = _busy_by_card(prof)
    _, n_ops, top = device_profile(prof)
    k = cachem["k"]
    glob = global_layers(cfg) if sketch else []
    want_launches = [len(glob) * sum(_seq_start(k, r) <= start + t
                                     for r in range(mesh.size))
                     for t in range(total)]
    steady = sorted(times[1:-1]) or times
    step_ms = steady[len(steady) // 2]
    row = {"phase": "lm_mesh_decode", "part": "run", "arch": arch,
           "nvidia_smi": smi, "mesh": dict(mesh.shape), "cards": cards,
           "dtype": cfg.param_dtype, "layers": cfg.n_layers, "B": B,
           "s_max": s_max, "start_length": start, "steps": total,
           "compared_steps": steps if single else 0,
           "seq_block_rows": k.shards[0].shape[2],
           "cache_axes": kv_cache.cache_axes(cfg, B, mesh),
           "cache_gb": kv_cache.cache_bytes(cachem) / 1e9,
           "step_ms_first": times[0], "step_ms_median": step_ms,
           "tokens_per_s": B / (step_ms / 1e3),
           "single_step_ms_median": (sorted(single_ms)[len(single_ms) // 2]
                                     if single_ms else None),
           "reckoned_gb_by_card": {c: b / 1e9 for c, b in reckoned.items()},
           "peak_gb_by_card": {c: b / 1e9 for c, b in peaks.items()},
           "profiled_step_ms": times[-1], "busy_ms_by_card": busy,
           "busy_share_by_card": {c: b / times[-1] for c, b in busy.items()},
           "device_ops_per_step": n_ops, "top_device_ops": top,
           "sketch_decode_attn_per_step": per_step[-1],
           "sketch_decode_attn_launches": sum(per_step),
           "logit_cosine_by_step": cosines,
           "logit_cosine_min": min(cosines) if cosines else None,
           "logit_cosine_worst_step": (int(np.argmin(cosines))
                                       if cosines else None),
           "choices_that_flipped": flips if single else None,
           "sum_dtype": sum_dtype,
           "cosine_bound": MDEC_BF16_COSINE if sum_dtype == "float32"
           else None}
    emit(row)
    if per_step != want_launches:
        fail(f"{where}: sketch_decode_attn launches a step {per_step}, "
             f"expected {want_launches}")
    if sum_dtype == "float32" and cosines and min(cosines) < MDEC_BF16_COSINE:
        fail(f"{where}: logit cosine {min(cosines)} < {MDEC_BF16_COSINE}")
    del pm, cachem, stepm, params1
    gc.collect()
    torch.cuda.empty_cache()
    return row, got


def _seq_start(leaf, r) -> int:
    from repro_torch.parallel import sharding
    return sharding.axis_index(leaf.mesh, r, leaf.spec[2]) * leaf.shards[r].shape[2]


def phase_lm_mesh_decode(seed, device, cards=1):
    """Batched decode on a (data, model) mesh.  One card (``cards`` 1): the
    fp32 gates of every family on a 2 x 2 mesh of the card repeated, the
    partial entry against its plain version, then gemma3-4b (sketch on, B
    = 1, four blocks of 32 768) and deepseek-moe-16b (whole, B = 4) in
    bf16 against one device.  Cards 0..3 (``cards`` 4): gemma3-4b at
    131 072 on one card repeated and on the four cards (logits compared),
    then at the reference's long_500k, B = 1 x 524 288.  Returns the
    launch counts of the gemma3-4b mesh run and the kernel rows."""
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    one = make_test_mesh(*MESH_SHAPE, torch.device(
        "cuda", torch.cuda.current_device()))
    if cards == 1:
        for gate in MDEC_GATES:
            mesh_decode_gate(seed, *gate, one, device, smi)
        rows = check_sda_partial(device)
        run, _ = mesh_decode_run(seed, "gemma3-4b", one, 1, LM_LONG_S,
                                 LM_LONG_LEN, MDEC_LONG_STEPS, device, smi)
        moe = {dt: mesh_decode_run(seed, "deepseek-moe-16b", one, MDEC_MOE_B,
                                   MDEC_MOE_S, MDEC_MOE_START, MDEC_MOE_STEPS,
                                   device, smi, sum_dtype=dt)[0]
               for dt in ("float32", "bfloat16")}
        emit({"phase": "lm_mesh_decode", "part": "sum_dtype",
              "nvidia_smi": smi, "arch": "deepseek-moe-16b",
              **{f"{k}_{dt}": moe[dt][k] for dt in moe
                 for k in ("step_ms_median", "logit_cosine_min",
                           "device_ops_per_step")}})
        return {"launches": {"sketch_decode_attn":
                             run["sketch_decode_attn_launches"]},
                "kernel_rows": rows}
    four = make_test_mesh(*MESH_SHAPE, "cuda")
    _, want = mesh_decode_run(seed, "gemma3-4b", one, 1, LM_LONG_S,
                              LM_LONG_LEN, MDEC_LONG_STEPS, device, smi)
    run, got = mesh_decode_run(seed, "gemma3-4b", four, 1, LM_LONG_S,
                               LM_LONG_LEN, MDEC_LONG_STEPS, device, smi)
    errs = [_leaf_rel(a, b) for a, b in zip(got, want)]
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    emit({"phase": "lm_mesh_decode", "part": "four_cards_vs_one",
          "nvidia_smi": smi, "s_max": LM_LONG_S, "steps": len(got),
          "max_logit_err_rel": max(errs), "bit_equal": equal,
          "tolerance": MDEC_LOGIT_TOL})
    if max(errs) > MDEC_LOGIT_TOL:
        fail(f"lm_mesh_decode: four cards against one card repeated {max(errs)}")
    mesh_decode_run(seed, "gemma3-4b", four, 1, MDEC_500K_S, MDEC_500K_LEN,
                    MDEC_500K_STEPS, device, smi, single=False)
    return {"launches": {"sketch_decode_attn":
                         run["sketch_decode_attn_launches"]},
            "kernel_rows": []}


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
    from repro_torch.kernels import sketch_decode_attn as sda
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
        q = torch.randn((k.shape[0], Hkv, G, dh), generator=gen,
                        device=device).to(k.dtype)
        rows.append(sda_row(name, q, k, v, ids, n_live, kv_len, softcap, device))
    return rows


def sda_row(name, q, k, v, ids, n_live, kv_len, softcap, device):
    """One `sketch_decode_attn` case against its plain version on the card
    (within SDA_ATOL + SDA_RTOL * |plain|), timed beside its plain version
    and SDPA over the whole cache, with its byte and operation bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, sketch_decode_attn as sda
    B, S, Hkv, dh = k.shape
    G = q.shape[2]
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
    return {
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
        "bound_ms": b_ms, "bound_by": b_by}


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
    * each kind at T = 8 (cross-checked on the CPU): one launch of the
      commit kernel an operation, every tenant's row its single-sketch
      loop's (the T = 256 gates are cut for time);
    * a profile window of 4 RACE and of 4 SW-AKDE fleet chunks."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import race, sann, swakde
    from repro_torch.kernels import ops
    from repro_torch.serve import tenant_fleet

    out = {"phase": "fleet", "zipf_s": FLEET_ZIPF_S, "chunk": CHUNK}
    secs_of, clock = {}, [time.perf_counter()]

    def lap():
        """Seconds since the last lap (each part's, for the time budget)."""
        now = time.perf_counter()
        dt, clock[0] = now - clock[0], now
        return dt
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

    secs_of["race"] = lap()
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

    secs_of["race_durable"] = lap()
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

    secs_of["swakde"] = lap()
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

    secs_of["sann"] = lap()
    # --- profile windows of 4 fleet chunks (RACE and SW-AKDE; S-ANN's, ~20
    # s of its 32 095 device ops, is cut for time) --------------------------
    profile = {}
    n4 = 4 * CHUNK
    for name, f, host, tt in (
            ("race", race_fleet, khost, zipf_tids(n4, FLEET_TENANTS, seed + 11)),
            ("swakde", sw_fleet, khost, zipf_tids(n4, FLEET_SW_TENANTS, seed + 12))):
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

    secs_of["profile"] = lap()
    # --- one launch an operation at T = 8 --------------------------------
    gates = {}
    for kind, make, host, data in (("race", make_race, khost, kdata),
                                   ("swakde", make_sw, khost, kdata),
                                   ("sann", make_sann, shost, sdata)):
        gates[kind] = []
        for T in FLEET_SANN_GATE_T if kind == "sann" else FLEET_GATE_T:
            line, got = _fleet_gate(kind, T, make, host, data, seed, device)
            for k in launches:
                launches[k] += got[k]
            gates[kind].append(line)
            torch.cuda.empty_cache()
    out["per_T"] = gates
    secs_of["gates"] = lap()
    emit({**out, "launches": launches, "part_seconds": secs_of})
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


def phase_cluster(seed, sann_run, kde_run, device, n_sann=CLUSTER_SANN_N,
                  n_race=CLUSTER_RACE_N, n_kde=CLUSTER_KDE_N,
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
        # past a worker's window: the state the RPC cluster is held to
        ops.reset_launches()
        _cluster_feed(cl, khost[n_kde:n_kde + CLUSTER_KDE_TAIL], device)
        _add_launches(launches)
        if max(w.steps for w in cl.workers) < CLUSTER_KDE_WINDOW // K:
            fail(f"cluster kde K={K}: no worker's window expired in the tail")
        kept_kde[K]["expired"] = (cl.merged_state(), cl.query(kqs))
        # the ingest rate over the rest of the news stream (no gate), the
        # short gate stream's being too short
        n_rest = n_kde + CLUSTER_KDE_TAIL
        ops.reset_launches()
        secs_long = _cluster_feed(cl, khost[n_rest:n_long], device)
        _add_launches(launches)
        rows.append({"K": K, "points": n_kde, "worker_window":
                     CLUSTER_KDE_WINDOW // K, "eh_eps": 0.01,
                     "ingest_s_gate_stream": secs,
                     "points_per_s_gate_stream": n_kde / secs,
                     "points_long": n_long - n_rest, "ingest_s_long": secs_long,
                     "points_per_s": (n_long - n_rest) / secs_long,
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


def phase_rpc_cluster(cluster_run, device, K=RPC_K, sann_nmax=RPC_SANN_NMAX):
    """The multi-process cluster (`repro_torch.net`): every worker a
    spawned process with its own CUDA context on the one card, the
    coordinator the in-process cluster's with `RemoteEngine` proxies,
    each chunk one RPC, each merge every worker's snapshot over TCP.  On
    the `cluster` phase's streams and configurations, fed the same way:

    * `RPCClusterRACEService` at K = 4 (news shape, SRP): merged counters
      and answers equal the in-process cluster's at the same K;
    * `RPCClusterKDEService` at K = 4 (eps 0.01, worker windows 65 536 /
      K): the gate stream, then CLUSTER_KDE_TAIL points past a worker's
      window (the rest of the news stream cut for time), each equal to
      the in-process cluster's state and answers;
    * `RPCClusterRetrievalService` at K = 4, SIFT shape, n_max 250 000 a
      worker (a snapshot must fit the protocol's 256 MiB frame): state,
      (c, r) and top-50 ids equal the in-process cluster's at the same
      configuration, distances within the scorer's tolerance;
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
    out = {"phase": "rpc_cluster", "workers": K,
           "call_rows": SERVICE_CALL_ROWS, "rpc_timeout_s": RPC_TIMEOUT_S,
           "max_body": protocol.MAX_BODY}
    coord = {k: 0 for k in ops.LAUNCHES}        # the coordinator's launches
    in_workers = {k: 0 for k in ops.LAUNCHES}   # the worker processes'

    # --- RACE at the news shape, K = 4 ------------------------------------
    with _rpc_open(lambda: rpc.RPCClusterRACEService(
            ccfg, num_workers=K, merge_every=8, rpc=rc,
            device=device)) as (cl, start_s):
        ops.reset_launches()
        secs = _cluster_feed(cl, khost[:n_race], device)
        pull_ms, fold_ms = _timed_rpc_merge(cl, device)
        got = cl.query(kqs)
        q_rate = _timed_queries(cl.query, kqs, device)
        _add_launches(coord)
        _worker_launches(cl, in_workers, ("srp_hash", "race_hist"), device)
        want_state, want = cluster_run["race"][K]
        _same_state(f"rpc race K={K}", inprocess=want_state,
                    rpc=cl.merged_state())
        _same_answers(f"rpc race K={K}", got, want)
    out["race"] = {"K": K, "points": n_race, "start_s": start_s,
                   "ingest_s": secs, "points_per_s": n_race / secs,
                   "snapshot_pull_ms": pull_ms, "merge_fold_ms": fold_ms,
                   "queries_per_s": q_rate, "equals_inprocess_cluster": True}

    # --- SW-AKDE at the news shape, eps 0.01, K = 4 -----------------------
    n_kde = cluster_run["n_kde"]
    kcfg = dataclasses.replace(cluster_run["kcfg"],
                               window=CLUSTER_KDE_WINDOW // K)
    # the gate stream, then a tail past a worker's window; the rest of the
    # news stream is cut for time (the in-process cluster phase measures
    # its ingest rate)
    tail = khost[n_kde:n_kde + CLUSTER_KDE_TAIL]
    with _rpc_open(lambda: rpc.RPCClusterKDEService(
            kcfg, num_workers=K, merge_every=RPC_MERGE_EVERY, rpc=rc,
            device=device)) as (cl, start_s):
        ops.reset_launches()
        secs = _cluster_feed(cl, khost[:n_kde], device)
        pull_ms, fold_ms = _timed_rpc_merge(cl, device)
        got = cl.query(kqs)
        q_rate = _timed_queries(cl.query, kqs, device)
        want_state, want = cluster_run["kde"][K]["gate"]
        _same_state(f"rpc kde K={K} gate stream", inprocess=want_state,
                    rpc=cl.merged_state())
        _same_answers(f"rpc kde K={K} gate stream", got, want)
        secs_tail = _cluster_feed(cl, tail, device)
        _add_launches(coord)
        _worker_launches(cl, in_workers, ("srp_hash", "swakde_segment_pass"),
                         device)
        want_state, want = cluster_run["kde"][K]["expired"]
        _same_state(f"rpc kde K={K} expired", inprocess=want_state,
                    rpc=cl.merged_state())
        _same_answers(f"rpc kde K={K} expired", cl.query(kqs), want)
        snap_mb = _state_bytes(cl._template.state) / 1e6
    out["kde"] = {"K": K, "worker_window": CLUSTER_KDE_WINDOW // K,
                  "eh_eps": kcfg.eh_eps, "start_s": start_s,
                  "points_gate": n_kde, "ingest_s_gate": secs,
                  "points_per_s_gate_stream": n_kde / secs,
                  "points_tail": len(tail), "ingest_s_tail": secs_tail,
                  "points_per_s_tail": len(tail) / secs_tail,
                  "snapshot_mb_per_worker": snap_mb,
                  "snapshot_pull_ms": pull_ms, "merge_fold_ms": fold_ms,
                  "queries_per_s": q_rate, "equals_inprocess_cluster": True}

    # --- S-ANN at the SIFT shape, n_max 250 000 a worker, K = 4 -----------
    shost = shost[:RPC_SANN_N]
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
# phase 4e: sketch sharding (parallel/sketch_sharding.py) on a mesh
# --------------------------------------------------------------------------

def _timed(fn, devices):
    """``fn()`` once to warm up, then once timed (every card synchronized);
    returns (result, seconds)."""
    import torch
    fn()
    for d in devices:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    out = fn()
    for d in devices:
        torch.cuda.synchronize(d)
    return out, time.perf_counter() - t0


def _same_ids_and_distances(name, got, want):
    """Equal ids (and found flags, counts) and distances within the
    scorer's tolerance; returns whether the distances are bit-identical."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    exact = True
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"sharding {name}: answer shapes differ")
        if g.dtype.is_floating_point:
            if not torch.allclose(g, w, rtol=RTOL, atol=ATOL, equal_nan=True):
                fail(f"sharding {name}: distances beyond the tolerance")
            exact &= torch.equal(g, w)
        elif not torch.equal(g, w):
            fail(f"sharding {name}: ids differ from one device's")
    return exact


def phase_sharding(seed, sann_run, kde_run, srp_run, device, mesh_devices):
    """The sketches split across a mesh of K devices (one card repeated,
    or K cards) against one device, at full width: RACE and SW-AKDE split
    by rows (p-stable eps 0.1 and SRP eps 0.01, news shape), S-ANN by
    tables (SIFT shape, the point store replicated), merged; the three
    services on the mesh, durable; fleets split by tenant (RACE's and
    SW-AKDE's each tenant's row also against its single-sketch loop).
    Every state equals one device's bit for bit, every answer one device's, snapshots
    byte for byte, and each commit kernel launches once a shard a chunk."""
    import dataclasses
    import tempfile
    import types
    import numpy as np
    import torch
    from repro_torch.core import fleet, lsh, prng, race, sann, swakde
    from repro_torch.kernels import ops
    from repro_torch.parallel import sketch_sharding as ss
    from repro_torch.parallel.sharding import Mesh
    from repro_torch.persist import snapshot
    from repro_torch.serve import kde_service, race_service, retrieval

    t_phase = time.perf_counter()
    mesh = Mesh(mesh_devices)
    ctx = ss.make_sketch_ctx(mesh)
    K = mesh.size
    cards = list(dict.fromkeys(mesh.devices))
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    launches = {k: 0 for k in ops.LAUNCHES}
    out = {"phase": "sharding", "shards": K,
           "mesh": [str(d) for d in mesh.devices]}

    def own_cards(name, st):
        for i, (sh, d) in enumerate(zip(st, mesh.devices)):
            bad = [f for f, x in zip(sh._fields, sh)
                   if isinstance(x, torch.Tensor) and x.device != d]
            if bad:
                fail(f"sharding {name}: shard {i}'s {bad} not on {d}")

    def same(name, a, b):
        bad = {f: int((getattr(a, f) != getattr(b, f).to(
                   getattr(a, f).device)).sum())
               for f in a._fields if not torch.equal(
                   getattr(a, f), getattr(b, f).to(getattr(a, f).device))}
        if bad:
            fail(f"sharding {name}: state differs from one device's in "
                 f"{bad} elements")

    def stream(name, st, chunks, step, kernels):
        """``step(st, i, chunk)`` over the chunks, timed; each kernel of
        ``kernels`` must launch once a shard a chunk."""
        ops.reset_launches()
        for d in cards:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        for i, x in enumerate(chunks):
            st = step(st, i, x)
        for d in cards:
            torch.cuda.synchronize(d)
        secs = time.perf_counter() - t0
        got = {k: ops.LAUNCHES[k] for k in kernels}
        _add_launches(launches)
        if any(v != K * len(chunks) for v in got.values()):
            fail(f"sharding {name}: {got} launches over {len(chunks)} chunks; "
                 f"expected one a shard a chunk")
        own_cards(name, st)
        return st, secs, got

    def one_card(fn):
        ops.reset_launches()
        res = _timed(fn, [device])
        _add_launches(launches)
        return res

    def other_batches(name, sharded, single, queries, exact=True):
        """The answers at SHARD_OTHER_BATCHES queries too: a GEMM of
        another shape may sum in another order, and a code would move."""
        ops.reset_launches()
        for b in SHARD_OTHER_BATCHES:
            a4, a1 = sharded(queries[:b]), single(queries[:b])
            if not exact:
                _same_ids_and_distances(f"{name} at {b} queries", a4, a1)
            elif not torch.equal(a4.cpu(), a1.cpu()):
                fail(f"sharding {name}: estimates at {b} queries differ")
        _add_launches(launches)
        return list(SHARD_OTHER_BATCHES)

    # --- RACE and SW-AKDE at the news shape, split by rows --------------
    data = kde_run["data"]
    n = data.shape[0]
    chunks = [data[i:i + CHUNK] for i in range(0, n, CHUNK)]
    qs = kde_run["queries"][:QUERY_BLOCK]
    for family, run, eps in (("pstable", kde_run, 0.1),
                             ("srp", srp_run, SHARD_SRP_EPS)):
        p1 = run["params"]
        kernels = ("srp_hash",) if family == "srp" else ()
        st, p = ss.shard_race(race.race_init(96, 96, device), p1, ctx)
        st, secs, got = stream(
            f"race {family}", st, chunks,
            lambda s, i, x: ss.sharded_race_commit_chunk(
                s, ss.sharded_race_prepare_chunk(p, x, 96, ctx), ctx),
            kernels + ("race_hist",))
        same(f"race {family}", ss.gather_state(st, ctx), run["race"])
        q4, tq4 = _timed(lambda: ss.sharded_race_query_batch(st, p, qs, ctx),
                         cards)
        q1, tq1 = one_card(lambda: race.race_query_batch(run["race"], p1, qs))
        if not torch.equal(q4.cpu(), q1.cpu()):
            fail(f"sharding race {family}: estimates differ")
        batches = other_batches(
            f"race {family}",
            lambda q: ss.sharded_race_query_batch(st, p, q, ctx),
            lambda q: race.race_query_batch(run["race"], p1, q), qs)
        out[f"race_{family}"] = {
            "points": n, "rows_a_shard": 96 // K, "launches": got,
            "k1_points_per_s": run["rates"]["race_points_per_s"],
            "k_points_per_s": n / secs, "k1_queries_per_s": QUERY_BLOCK / tq1,
            "k_queries_per_s": QUERY_BLOCK / tq4, "state_bit_identical": True,
            "queries_bit_identical": QUERY_BLOCK,
            "other_batches_bit_identical": batches}
        del st

        cfg = swakde.SWAKDEConfig(L=96, W=96, window=65_536, eh_eps=eps)
        if family == "pstable":
            one, k1_rate = run["state"], run["rates"]["swakde_points_per_s"]
        else:
            ops.reset_launches()
            sync(device)
            t0 = time.perf_counter()
            one = swakde.swakde_init(cfg, device)
            for x in chunks:
                one = swakde.swakde_update_chunk(one, p1, x, cfg)
            sync(device)
            k1_rate = n / (time.perf_counter() - t0)
            _add_launches(launches)
        st, p = ss.shard_swakde(swakde.swakde_init(cfg, device), p1, ctx)
        st, secs, got = stream(
            f"swakde {family}", st, chunks,
            lambda s, i, x: ss.sharded_swakde_commit_chunk(
                s, ss.sharded_swakde_prepare_chunk(p, x, cfg, ctx), cfg, ctx),
            kernels + ("swakde_segment_pass",))
        same(f"swakde {family}", ss.gather_state(st, ctx), one)
        q1, tq1 = one_card(lambda: swakde.swakde_query_batch(one, p1, qs, cfg))
        q4, tq4 = _timed(lambda: ss.sharded_swakde_query_batch(st, p, qs, cfg,
                                                               ctx), cards)
        grid = ss.sharded_swakde_grid_estimates(st, cfg, ctx)
        qg, tqg = _timed(lambda: ss.sharded_swakde_query_from_grid(
            grid, p, qs, cfg, ctx), cards)
        if not (torch.equal(q4.cpu(), q1.cpu())
                and torch.equal(qg.cpu(), q1.cpu())):
            fail(f"sharding swakde {family}: estimates differ")
        batches = other_batches(
            f"swakde {family}",
            lambda q: torch.stack([
                ss.sharded_swakde_query_batch(st, p, q, cfg, ctx),
                ss.sharded_swakde_query_from_grid(grid, p, q, cfg, ctx)]),
            lambda q: swakde.swakde_query_batch(one, p1, q, cfg).expand(2, -1),
            qs)
        out[f"swakde_{family}"] = {
            "points": n, "eh_eps": eps, "eh_slots": cfg.eh_config().slots,
            "rows_a_shard": 96 // K, "launches": got,
            "k1_points_per_s": k1_rate, "k_points_per_s": n / secs,
            "k1_queries_per_s": QUERY_BLOCK / tq1,
            "k_queries_per_s": QUERY_BLOCK / tq4,
            "k_grid_queries_per_s": QUERY_BLOCK / tqg,
            "state_bit_identical": True,
            "queries_bit_identical": 2 * QUERY_BLOCK,
            "other_batches_bit_identical": batches}
        del st, grid, one

    # --- S-ANN at the SIFT shape, split by tables ------------------------
    scfg, sp1, sdata = sann_run["cfg"], sann_run["params"], sann_run["data"]
    schunks = [sdata[i:i + CHUNK] for i in range(0, sdata.shape[0], CHUNK)]
    ckeys = prng.split(sann_run["key"], len(schunks))
    empty, sp = ss.shard_sann(sann.sann_empty_state(scfg, device), sp1, ctx)
    st, secs, got = stream(
        "sann", empty, schunks,
        lambda s, i, x: ss.sharded_sann_commit_chunk(
            s, ss.sharded_sann_prepare_chunk(sp, x, ckeys[i], scfg, ctx),
            scfg, ctx),
        ("sann_table_scatter",))
    one = sann_run["state"]
    same("sann", ss.gather_state(st, ctx), one)
    sq = sann_run["queries"][:QUERY_BLOCK]
    cr1, tcr1 = one_card(lambda: sann.sann_query_batch(one, sp1, sq, scfg))
    tk1, ttk1 = one_card(lambda: sann.sann_query_topk_batch(one, sp1, sq, scfg,
                                                            TOPK))
    ops.reset_launches()
    cr4, tcr4 = _timed(lambda: ss.sharded_sann_query_batch(st, sp, sq, scfg,
                                                           ctx), cards)
    tk4, ttk4 = _timed(lambda: ss.sharded_sann_query_topk_batch(
        st, sp, sq, scfg, ctx, TOPK), cards)
    _add_launches(launches)
    exact = (_same_ids_and_distances("sann (c, r)", cr4, cr1)
             & _same_ids_and_distances("sann top-50", tk4, tk1))
    batches = other_batches(
        "sann", lambda q: (*ss.sharded_sann_query_batch(st, sp, q, scfg, ctx),
                           *ss.sharded_sann_query_topk_batch(st, sp, q, scfg,
                                                             ctx, TOPK)),
        lambda q: (*sann.sann_query_batch(one, sp1, q, scfg),
                   *sann.sann_query_topk_batch(one, sp1, q, scfg, TOPK)),
        sq, exact=False)
    # the merge of two halves, against sann_merge
    mkeys = prng.split(prng.PRNGKey(seed + 5, device), 2 * SHARD_MERGE_CHUNKS)
    halves1, halves4 = [], []
    for h in range(2):
        part = range(h * SHARD_MERGE_CHUNKS, (h + 1) * SHARD_MERGE_CHUNKS)
        a1, a4 = sann.sann_empty_state(scfg, device), empty
        for j in part:
            a1 = sann.sann_insert_batch(a1, sp1, schunks[j], mkeys[j], scfg)
            a4 = ss.sharded_sann_insert_batch(a4, sp, schunks[j], mkeys[j],
                                              scfg, ctx)
        halves1.append(a1)
        halves4.append(a4)
    m1, tm1 = one_card(lambda: sann.sann_merge(*halves1, sp1, scfg))
    ops.reset_launches()
    m4, tm4 = _timed(lambda: ss.sharded_sann_merge(*halves4, sp, scfg, ctx),
                     cards)
    merge_launches = ops.LAUNCHES["sann_table_scatter"]
    _add_launches(launches)
    own_cards("sann merge", m4)
    same("sann merge", ss.gather_state(m4, ctx), m1)
    out["sann"] = {
        "points": int(sdata.shape[0]), "tables_a_shard": scfg.L // K,
        "table_mb_a_shard": st[0].tables.numel() * 4 / 1e6,
        "point_store_mb_a_shard": st[0].points.numel() * 4 / 1e6,
        "launches": got, "k1_points_per_s": sann_run["rates"]["points_per_s"],
        "k_points_per_s": sdata.shape[0] / secs,
        "k1_queries_per_s": QUERY_BLOCK / tcr1,
        "k_queries_per_s": QUERY_BLOCK / tcr4,
        "k1_topk_queries_per_s": QUERY_BLOCK / ttk1,
        "k_topk_queries_per_s": QUERY_BLOCK / ttk4,
        "state_bit_identical": True, "ids_equal": 2 * QUERY_BLOCK,
        "distances_bit_identical": exact, "other_batches_ids_equal": batches,
        "merge_points": 2 * SHARD_MERGE_CHUNKS * CHUNK, "k1_merge_ms": tm1 * 1e3,
        "k_merge_ms": tm4 * 1e3, "merge_launches": merge_launches,
        "merge_bit_identical": True}
    del st, m4, m1, halves1, halves4, empty

    # --- the three services on the mesh, durable -------------------------
    host_s = sdata[:SHARD_SERVICE_ROWS].cpu().numpy()
    host_k = data[:SHARD_SERVICE_ROWS].cpu().numpy()
    common = dict(seed=seed, ingest_chunk=CHUNK, query_block=QUERY_BLOCK,
                  snapshot_every=SHARD_SNAPSHOT_EVERY,
                  max_pending=SERVICE_CALL_ROWS)
    specs = {
        "retrieval": (retrieval.RetrievalService, retrieval.RetrievalConfig(
            dim=SANN_DIM, n_max=SHARD_SERVICE_SANN_NMAX, eta=0.3,
            r=sann_run["r"],
            c=sann_run["c"], w=2.0 * sann_run["r"], L=12, k=6, bucket_cap=32,
            topk=TOPK, **common), host_s, sann_run["queries"],
            lambda s: s.delete(host_s[10]), "sann_table_scatter"),
        "kde_srp": (kde_service.KDEService, kde_service.KDEServiceConfig(
            dim=KDE_DIM, L=96, W=96, window=65_536, eh_eps=0.1,
            hash_family="srp", k=2, **common), host_k, qs,
            lambda s: s.advance_clock(SHARD_SERVICE_ROWS + SERVICE_CLOCK_STEPS),
            "swakde_segment_pass"),
        "race": (race_service.RACEService, race_service.RACEServiceConfig(
            dim=KDE_DIM, L=96, W=96, hash_family="pstable", k=2, w=4.0,
            **common), host_k, qs,
            lambda s: s.delete(host_k[:SERVICE_DELETE_ROWS]), "race_hist"),
    }
    with tempfile.TemporaryDirectory() as tmp:
        for name, (cls, cfg, host, squeries, mutate, kernel) in specs.items():
            def make(sharded, d):
                return cls(dataclasses.replace(
                    cfg, snapshot_dir=str(d), mesh=mesh if sharded else None),
                    device=device)

            line, svcs, dirs = {}, {}, {}
            for sharded in (False, True):
                tag = f"k{K}" if sharded else "k1"
                dirs[tag] = Path(tmp) / name / tag
                svc = make(sharded, dirs[tag])
                ops.reset_launches()
                secs, _ = _feed(svc, host, device)
                if mutate is not None:
                    mutate(svc)
                svc.flush()
                n_commit = ops.LAUNCHES[kernel]
                _add_launches(launches)
                # (the RACE delete is one more prepare and commit)
                chunks_in = -(-host.shape[0] // CHUNK) + (name == "race")
                if sharded and n_commit != K * chunks_in:
                    fail(f"sharding service {name}: {n_commit} {kernel} "
                         f"launches for {chunks_in} chunks on {K} shards")
                hq = squeries[:QUERY_BLOCK].cpu().numpy()
                kind = svc._default_query_kind
                ans, tq = _timed(lambda: svc._serve_query(kind, hq), cards)
                line[f"{tag}_points_per_s_durable"] = host.shape[0] / secs
                line[f"{tag}_queries_per_s"] = QUERY_BLOCK / tq
                line[f"{tag}_{kernel}_launches"] = n_commit
                svcs[tag] = (svc, ans)
            (s1, a1), (s4, a4) = svcs["k1"], svcs[f"k{K}"]
            own_cards(f"service {name}", s4.state)
            same(f"service {name}", s4.gather_state(s4.state), s1.state)
            if name == "retrieval":
                line["ring_wrapped"] = bool(s1.state.write_ptr
                                            != s1.state.n_stored)
            elif name == "kde_srp":
                line["window_expired"] = bool(s1.steps > cfg.window)
            if False in (line.get("ring_wrapped"), line.get("window_expired")):
                fail(f"sharding service {name}: the stream did not wrap the "
                     f"ring or expire the window")
            line["answers_bit_identical"] = _same_ids_and_distances(
                f"service {name}", tuple(map(torch.from_numpy, a4)
                                         if isinstance(a4, tuple)
                                         else (torch.from_numpy(a4),)),
                tuple(map(torch.from_numpy, a1) if isinstance(a1, tuple)
                      else (torch.from_numpy(a1),)))
            ref_state = s1.state
            s1.close()
            s4.close()
            seqs = {t: snapshot.latest_seq(d) for t, d in dirs.items()}
            if len(set(seqs.values())) != 1:
                fail(f"sharding service {name}: newest snapshots {seqs}")
            seq = seqs["k1"]
            files = sorted(p.name for p in
                           snapshot.snapshot_path(dirs["k1"], seq).iterdir())
            for f in files:
                a = (snapshot.snapshot_path(dirs["k1"], seq) / f).read_bytes()
                b = (snapshot.snapshot_path(dirs[f"k{K}"], seq) / f
                     ).read_bytes()
                if a != b:
                    fail(f"sharding service {name}: snapshot file {f} differs")
            line["snapshot_seq"] = seq
            line["snapshot_bytes"] = _dir_bytes(
                snapshot.snapshot_path(dirs["k1"], seq))
            line["snapshot_files_byte_identical"] = files
            for src, sharded in (("k1", True), (f"k{K}", False)):
                rec = make(sharded, dirs[src])
                t0 = time.perf_counter()
                replayed = rec.recover()
                sync(device)
                line[f"recover_{src}_dir_on_{'k' + str(K) if sharded else 'k1'}_s"] = (
                    time.perf_counter() - t0)
                if replayed < 1:
                    fail(f"sharding service {name}: nothing replayed")
                same(f"service {name} recovered from {src}",
                     rec.gather_state(rec.state), ref_state)
                rec.close()
            line["recovered_both_ways"] = True
            out[f"service_{name}"] = {"points": int(host.shape[0]), **line}
            del ref_state

    # --- fleets split by tenant ------------------------------------------
    nf = SHARD_FLEET_CHUNKS * CHUNK
    gen = torch.Generator(device=device).manual_seed(seed + 60)
    acfg = sann.SANNConfig(dim=SANN_DIM, n_max=SHARD_FLEET_SANN_NMAX, eta=0.3,
                           r=sann_run["r"], c=sann_run["c"],
                           w=2.0 * sann_run["r"], L=12, k=6,
                           bucket_cap=32).resolved()
    fleets = {
        "race": (SHARD_FLEET_T["race"], srp_run["params"], data,
                 race.race_init(96, 96, device), ("srp_hash", "race_hist")),
        "swakde": (SHARD_FLEET_T["swakde"], kde_run["params"], data,
                   swakde.swakde_init(swakde.SWAKDEConfig(
                       L=96, W=96, window=FLEET_SW_WINDOW, eh_eps=0.1), device),
                   ("swakde_segment_pass",)),
        "sann": (SHARD_FLEET_T["sann"], lsh.init_pstable(
            gen, SANN_DIM, acfg.L, acfg.k, acfg.w, acfg.n_buckets,
            device=device), sdata, sann.sann_empty_state(acfg, device),
            ("sann_table_scatter",)),
    }
    fcfg = swakde.SWAKDEConfig(L=96, W=96, window=FLEET_SW_WINDOW, eh_eps=0.1)
    for kind, (T, p1, fdata, empty1, kernels) in fleets.items():
        tids_h = zipf_tids(nf, T, seed + T)
        tids = torch.from_numpy(tids_h).to(device)
        caps = [int(np.bincount(tids_h[i:i + CHUNK], minlength=T).max())
                for i in range(0, nf, CHUNK)]
        fchunks = [fdata[i:i + CHUNK] for i in range(0, nf, CHUNK)]

        def keys(i, T=T):
            return fleet.sann_fleet_keys(prng.fold_in(
                prng.PRNGKey(seed + 61, device), i),
                torch.arange(T, device=device))

        def step(st, i, x, p, sharded, kind=kind):
            t = tids[i * CHUNK:(i + 1) * CHUNK]
            if kind == "race":
                return (ss.sharded_race_fleet_ingest(st, p, x, t, ctx)
                        if sharded else fleet.race_fleet_ingest(st, p, x, t))
            if kind == "swakde":
                return (ss.sharded_swakde_fleet_ingest(st, p, x, t, fcfg,
                                                       caps[i], ctx)
                        if sharded else fleet.swakde_fleet_ingest(
                            st, p, x, t, fcfg, caps[i]))
            return (ss.sharded_sann_fleet_ingest(st, p, x, t, keys(i), acfg,
                                                 caps[i], ctx)
                    if sharded else fleet.sann_fleet_ingest(
                        st, p, x, t, keys(i), acfg, caps[i]))

        one = fleet.fleet_broadcast(empty1, T)
        st, p = ss.shard_fleet(one, p1, ctx)
        st, secs, got = stream(f"fleet {kind}", st, fchunks,
                               lambda s, i, x: step(s, i, x, p, True),
                               kernels)
        ops.reset_launches()
        sync(device)
        t0 = time.perf_counter()
        for i, x in enumerate(fchunks):
            one = step(one, i, x, p1, False)
        sync(device)
        secs1 = time.perf_counter() - t0
        _add_launches(launches)
        same(f"fleet {kind}", ss.gather_fleet(st, ctx), one)
        if kind != "sann":
            # every tenant's row against its single-sketch loop at this T
            blocks = [(i, i + CHUNK) for i in range(0, nf, CHUNK)]
            oracle = _fleet_oracle(
                kind, types.SimpleNamespace(empty_state=empty1,
                                            sketch_cfg=fcfg),
                fdata, _fleet_codes(p1, fdata, blocks), tids_h, blocks,
                device)
            _oracle_check(f"{kind} T={T} (sharding)", types.SimpleNamespace(
                peek_state=lambda t: fleet.fleet_row(one, t)), T, oracle)
            ops.reset_launches()
        edge = {}
        if kind == "swakde":
            edge["tenants_expired"] = int((one.t > fcfg.window).sum())
        elif kind == "sann":
            edge["tenants_wrapped"] = int((one.write_ptr != one.n_stored)
                                          .sum())
        if 0 in edge.values():
            fail(f"sharding fleet {kind}: no tenant reached the edge {edge}")
        fq = (sann_run["queries"] if kind == "sann" else qs)[:QUERY_BLOCK]
        qt = torch.from_numpy(zipf_tids(QUERY_BLOCK, T, seed + T + 1)).to(
            device)
        if kind == "race":
            pairs = [(lambda: fleet.race_fleet_query(one, p1, fq, qt),
                      lambda: ss.sharded_race_fleet_query(st, p, fq, qt, ctx))]
        elif kind == "swakde":
            pairs = [(lambda: fleet.swakde_fleet_query(one, p1, fq, qt, fcfg),
                      lambda: ss.sharded_swakde_fleet_query(st, p, fq, qt,
                                                            fcfg, ctx))]
        else:
            pairs = [(lambda: fleet.sann_fleet_query_topk(one, p1, fq, qt,
                                                          acfg, TOPK),
                      lambda: ss.sharded_sann_fleet_query_topk(
                          st, p, fq, qt, acfg, ctx, TOPK)),
                     (lambda: fleet.sann_fleet_query(one, p1, fq, qt, acfg),
                      lambda: ss.sharded_sann_fleet_query(st, p, fq, qt, acfg,
                                                          ctx))]
        tq1 = tq4 = 0.0
        for f1, f4 in pairs:
            a1, t1 = one_card(f1)
            ops.reset_launches()
            a4, t4 = _timed(f4, cards)
            _add_launches(launches)
            _same_ids_and_distances(f"fleet {kind} queries", a4, a1)
            tq1, tq4 = tq1 + t1, tq4 + t4
        out[f"fleet_{kind}"] = {
            "T": T, "tenants_a_shard": T // K, "points": nf,
            "chunks": len(fchunks), **edge, "launches": got,
            "k1_points_per_s": nf / secs1, "k_points_per_s": nf / secs,
            "k1_queries_per_s": len(pairs) * QUERY_BLOCK / tq1,
            "k_queries_per_s": len(pairs) * QUERY_BLOCK / tq4,
            "device_bytes": _state_bytes(one), "state_bit_identical": True,
            "queries_equal": len(pairs) * QUERY_BLOCK}
        del st, one

    out["peak_mb_by_card"] = {str(d): torch.cuda.max_memory_allocated(d) / 1e6
                              for d in cards}
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = {k: v for k, v in launches.items() if v}
    for k in SERVICE_KERNELS:
        if launches[k] <= 0:
            fail(f"the sharding phase launched no {k}")
    emit(out)
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


def timed(phase, *args):
    """``phase(*args)``, then its seconds on a line of their own."""
    t0 = time.perf_counter()
    out = phase(*args)
    emit({"phase_seconds": phase.__name__, "s": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1,
                    help="1 (default): every phase, the sharding and lm_mesh "
                    "phases on one card repeated; N > 1: only the sharding "
                    "phase (and the phases it reads) on cards 0..N-1, and "
                    "at N = 4 the lm_mesh phase on cards 0..3")
    ap.add_argument("--only", choices=["train", "lm_serve", "lm_families",
                                       "train_families", "lm_mesh",
                                       "lm_mesh_decode"],
                    help="run only this phase (after the device phase); "
                    "lm_mesh with --cards 4 trains on cards 0..3, "
                    "lm_mesh_decode with --cards 4 decodes on them")
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
    if torch.cuda.device_count() < args.cards:
        print(f"chip_smoke: --cards {args.cards} but "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2

    ok_line = {"ok": True, "device": {"platform": "gpu",
                                      "kind": torch.cuda.get_device_name(0),
                                      "count": torch.cuda.device_count()}}
    timed(phase_device)
    if args.only == "train":
        timed(phase_train, args.seed, device)
        emit(ok_line)
        return 0
    if args.only == "lm_serve":
        serve_run = timed(phase_lm_serve, args.seed, device)
        timed(phase_lm_long, args.seed, serve_run, device)
        emit(ok_line)
        return 0
    if args.only == "lm_families":
        for row in timed(phase_lm_families, args.seed, device)["kernel_rows"]:
            emit({"phase": "kernel_check", **row})
        emit(ok_line)
        return 0
    if args.only == "train_families":
        timed(phase_train_families, args.seed, device)
        emit(ok_line)
        return 0
    if args.only == "lm_mesh":
        timed(phase_lm_mesh, args.seed, device, args.cards)
        emit(ok_line)
        return 0
    if args.only == "lm_mesh_decode":
        run = timed(phase_lm_mesh_decode, args.seed, device, args.cards)
        for row in run["kernel_rows"]:
            emit({"phase": "kernel_check", **row})
        emit(ok_line)
        return 0
    if args.cards == 1:
        train_run = timed(phase_train, args.seed, device)
        families_run = timed(phase_lm_families, args.seed, device)
        train_families_run = timed(phase_train_families, args.seed, device)
        mesh_run = timed(phase_lm_mesh, args.seed, device)
        mesh_decode_run = timed(phase_lm_mesh_decode, args.seed, device)
    sann_run = timed(phase_sann, args.seed, device)
    kde_run = timed(phase_kde, args.seed, device)
    srp_run = timed(phase_srp_kde, args.seed, kde_run, device)
    if args.cards > 1:
        timed(phase_sharding, args.seed, sann_run, kde_run, srp_run, device,
              tuple(torch.device("cuda", i) for i in range(args.cards)))
        if args.cards == 4:
            timed(phase_lm_mesh, args.seed, device, args.cards)
            timed(phase_lm_mesh_decode, args.seed, device, args.cards)
        emit(ok_line)
        return 0
    oracle_launches = timed(phase_sann_oracles, sann_run, device)
    timed(phase_kde_oracles, srp_run, device)
    timed(phase_lm_cross_check, args.seed, device)
    serve_run = timed(phase_lm_serve, args.seed, device)
    timed(phase_lm_long, args.seed, serve_run, device)
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
    t0 = time.perf_counter()
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
            *check_sketch_decode_attn(serve_run, device),
            *families_run["kernel_rows"],
            *mesh_decode_run["kernel_rows"]]
    for row in rows:
        emit({"phase": "kernel_check", **row})
    emit({"phase_seconds": "kernel_check", "s": time.perf_counter() - t0})
    sharding_run = timed(
        phase_sharding, args.seed, sann_run, kde_run, srp_run, device,
        (torch.device("cuda", torch.cuda.current_device()),) * SHARD_K)
    services_run = timed(phase_services, args.seed, sann_run, kde_run, device)
    fleet_run = timed(phase_fleet, args.seed, sann_run, kde_run, device)
    cluster_run = timed(phase_cluster, args.seed, sann_run, kde_run, device)
    rpc_run = timed(phase_rpc_cluster, cluster_run, device)
    fleet_cluster = {k: fleet_run["launches"][k] + cluster_run["launches"][k]
                     for k in launches}
    del cluster_run
    timed(phase_profile, sann_run, kde_run, srp_run, serve_run, services_run,
          device)
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
            continue        # the long-context and internvl2 shapes; in their
                            # kernel_check lines
        if row.get("entry") == "sann_table_scatter":
            continue        # the in-place append alone; the main path's entry
                            # is the commit (`sann_table_commit`)
        if row.get("entry") == "partial":
            continue        # the mesh decode's entry; added to the
                            # kernel's row below
        summary.append({
            "name": row["name"], "route": "cuda", "source": SOURCES[row["name"]],
            "replaces": REPLACES[row["name"]], "launches": launches[row["name"]],
            "services_launches": services_run["launches"].get(row["name"], 0),
            "fleet_cluster_launches": fleet_cluster[row["name"]],
            "rpc_cluster_launches": rpc_run["launches"][row["name"]],
            "sharding_launches": sharding_run["launches"][row["name"]],
            "train_launches": train_run["launches"][row["name"]],
            "families_launches": families_run["launches"].get(row["name"], 0),
            "train_families_launches": train_families_run["launches"].get(
                row["name"], 0),
            "lm_mesh_launches": mesh_run["launches"].get(row["name"], 0),
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
    partial = next(r for r in mesh_decode_run["kernel_rows"]
                   if r["case"] == "lm_long")
    for row in summary:
        if row["name"] == "sketch_decode_attn":
            row.update({f"partial_{k}": partial[k] for k in (
                "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "shape")},
                lm_mesh_decode_launches=mesh_decode_run["launches"][
                    "sketch_decode_attn"])
    emit({"kernels": summary})
    emit(ok_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
