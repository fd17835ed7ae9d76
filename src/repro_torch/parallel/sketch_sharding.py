"""Multi-device sharded ingest and queries for the three sketches.

The port of the reference's ``parallel/sketch_sharding.py``.  All three
sketches are mergeable histograms, which is what makes them shardable:

  * **RACE** — ``counts (L, W)`` split along the **L (rows)** axis.  Each
    shard hashes the chunk with its own row block of the LSH params (a
    p-stable block takes its columns of the whole projection's product,
    `_param_specs`) and updates its rows; a query gathers the per-row
    counter reads in row order and applies `core.race.estimate_from_vals`
    once.
  * **SW-AKDE** — the EH grid ``(L, W, levels, slots)`` split along L, the
    same scheme; every shard advances the clock ``t`` identically.
  * **S-ANN** — split **by table**: ``tables (L, n_buckets, cap)`` and
    ``table_ptr`` along L; the point store, valid mask, counters and stamps
    are replicated (every shard draws the same keep decisions from the same
    key, so the replicas stay bit-identical by construction).  (c, r)
    queries gather the candidate blocks in shard order, which is the
    single-device row-major order, and score once with the global 3L
    budget; top-k queries merge the per-shard top-ks.
  * **Tenant fleets** — a stacked fleet splits its leading ``[T]`` tenant
    axis instead and replicates the params; each shard routes the mixed
    chunk against its own tenant block, and a query takes each request's
    values from the one shard owning its tenant (an owner-masked sum).

One process holds the whole sharded sketch, as the reference's single
controller does.  A mesh (`parallel.sharding.Mesh`) is a tuple of
devices; a sharded state or prep is the tuple of per-shard core states,
shard i on ``mesh.devices[i]``, and each body below is the core call on
one shard.  The reference's collectives are exact whatever carries the
bytes: its ``all_gather`` is ``Tensor.to(first device)`` + ``torch.cat``
(peer to peer between cards), its owner-masked ``psum`` a sum on the
first device in which one shard contributes non-zeros.  No process group
is used.  So a mesh may repeat a device: ``("cpu",) * 8`` in the tests,
``("cuda:0",) * 4`` on one card, ``cuda:0..3`` on four.  Answers come back
on the mesh's first device.

`shard_race` / `shard_swakde` / `shard_sann` / `shard_fleet` place a
single-device state and params onto the mesh (each block contiguous on its
device, made once); `gather_state` / `gather_fleet` are their inverse, the
single-device state on the first device (split leaves concatenated in
shard order, shard 0's copy of each replicated leaf), which snapshots and
the tests read.  ``ctx.mesh is None`` short-circuits every function to the
plain single-device call, so services hold one code path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core import fleet, lsh, race, sann, swakde
from ..core.util import mean_last
from .sharding import Mesh, ShardingCtx, make_ctx

SHARD_AXIS = "shard"


# ---------------------------------------------------------------------------
# Mesh / ctx / placement helpers
# ---------------------------------------------------------------------------

def make_sketch_mesh(num_shards: int, device="cuda") -> Mesh:
    """1-D ``("shard",)`` mesh: on CUDA the first ``num_shards`` cards, on
    the CPU ``num_shards`` entries of the CPU device.  (One card runs a
    larger mesh when given one that repeats it, ``Mesh(("cuda:0",) * n)``.)"""
    device = torch.device(device)
    if device.type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < num_shards:
            raise ValueError(
                f"num_shards={num_shards} but only {visible} devices visible "
                "(on one card pass mesh=Mesh(('cuda:0',) * n))")
        return Mesh(tuple(torch.device("cuda", i) for i in range(num_shards)))
    return Mesh((device,) * num_shards)


def make_sketch_ctx(mesh: Optional[Mesh]) -> ShardingCtx:
    """ShardingCtx over ``mesh`` with the sketch logical-axis rules.  A mesh
    without a "shard" axis would replicate everything; it is refused."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"expected a parallel.sharding.Mesh, got "
                        f"{type(mesh).__name__} (build one with "
                        "make_sketch_mesh)")
    if mesh is not None and SHARD_AXIS not in mesh.axis_names:
        raise ValueError(
            f"sketch sharding needs a ('{SHARD_AXIS}',) mesh axis, got "
            f"{mesh.axis_names} (build one with make_sketch_mesh)")
    return make_ctx(mesh)


def make_service_ctx(mesh: Optional[Mesh], num_shards: int,
                     device="cuda") -> ShardingCtx:
    """The services' config contract: an explicit ``mesh`` wins, else
    ``num_shards > 1`` builds one on ``device``'s type, else single-device
    (``ctx.mesh = None``)."""
    if mesh is None and num_shards > 1:
        mesh = make_sketch_mesh(num_shards, device)
    return make_sketch_ctx(mesh)


def ctx_num_shards(ctx: ShardingCtx) -> int:
    """Shard count of a sketch ctx (1 for the single-device path)."""
    return 1 if ctx.mesh is None else ctx.mesh.shape[SHARD_AXIS]


def _split_size(size: int, n: int, what: str) -> int:
    if size % n:
        raise ValueError(f"{what}={size} not divisible by num_shards={n}")
    return size // n


def _check_rows(L: int, n: int, what: str) -> int:
    return _split_size(L, n, f"{what}: L")


def _local_params(params, L_local: int, shard: int):
    """Shard ``shard``'s parameter block: its static row count, and for a
    p-stable block its first row in the whole projection it holds."""
    params = params._replace(L=L_local)
    if isinstance(params, lsh.PStableParams):
        params = params._replace(row0=shard * L_local)
    return params


def _param_specs(params, ctx: ShardingCtx):
    """Specs for LSH params, row-sharded: ``bias (L*k,)`` and ``mix (L, k)``
    split their L axis.  An SRP ``proj (d, L*k)`` splits its column axis
    (L-major, so contiguous blocks are whole rows): `srp_hash` sums each
    column in one order whatever the width.  A p-stable ``proj`` is
    replicated and each block hashes with its own columns of the whole
    product (``PStableParams.row0``): a GEMM of another width may sum a
    column in another order, and a code would move at a bucket boundary."""
    rowk = ctx.spec("sketch_rows", None)
    if isinstance(params, lsh.SRPParams):
        return params._replace(proj=ctx.spec(None, "sketch_rows"), mix=rowk)
    return params._replace(proj=ctx.spec(), bias=ctx.spec("sketch_rows"),
                           mix=rowk)


def _own(block: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``block`` of its own on ``device`` (never a
    view: the table commit needs 16-byte-aligned tables)."""
    out = torch.empty(block.shape, dtype=block.dtype, device=device)
    return out.copy_(block)


def _put(tree, specs, mesh: Mesh, what: str):
    """Place a NamedTuple ``tree`` onto ``mesh`` → one tree a shard.  A
    tensor leaf whose spec names the shard axis splits into contiguous
    blocks along that axis; any other is replicated (one copy a distinct
    device); non-tensor fields are kept."""
    n = mesh.size
    shards = [[] for _ in range(n)]
    for x, spec in zip(tree, specs):
        if not isinstance(x, torch.Tensor):
            parts = [x] * n
        elif SHARD_AXIS in spec:
            dim = spec.index(SHARD_AXIS)
            size = _split_size(x.shape[dim], n, what)
            parts = [_own(x.narrow(dim, i * size, size), d)
                     for i, d in enumerate(mesh.devices)]
        else:
            parts = [x.to(d) for d in mesh.devices]
        for sh, part in zip(shards, parts):
            sh.append(part)
    return tuple(type(tree)(*sh) for sh in shards)


def _gather(shards, specs, mesh: Mesh):
    """Inverse of `_put`: one tree on the mesh's first device."""
    first = mesh.devices[0]
    out = []
    for i, spec in enumerate(specs):
        leaves = [sh[i] for sh in shards]
        if isinstance(leaves[0], torch.Tensor) and SHARD_AXIS in spec:
            out.append(torch.cat([x.to(first) for x in leaves],
                                 dim=spec.index(SHARD_AXIS)))
        elif isinstance(leaves[0], torch.Tensor):
            out.append(leaves[0].to(first))
        else:
            out.append(leaves[0])
    return type(shards[0])(*out)


def _race_state_specs(ctx: ShardingCtx):
    return race.RACEState(counts=ctx.spec("sketch_rows", None), n=ctx.spec())


def _swakde_state_specs(ctx: ShardingCtx):
    return swakde.SWAKDEState(
        ts=ctx.spec("sketch_rows", None, None, None),
        num=ctx.spec("sketch_rows", None, None),
        t=ctx.spec())


def _sann_state_specs(ctx: ShardingCtx):
    r = ctx.spec()
    return sann.SANNState(
        points=r, valid=r, write_ptr=r, n_seen=r, n_stored=r,
        tables=ctx.spec("sketch_tables", None, None),
        table_ptr=ctx.spec("sketch_tables", None),
        stamps=r)


_STATE_SPECS = {race.RACEState: (_race_state_specs, "RACE: L"),
                swakde.SWAKDEState: (_swakde_state_specs, "SW-AKDE: L"),
                sann.SANNState: (_sann_state_specs, "S-ANN: L")}


def shard_state(state, ctx: ShardingCtx):
    """Place a single-device RACE, SW-AKDE or S-ANN state onto the mesh
    (identity without a mesh)."""
    if ctx.mesh is None:
        return state
    specs, what = _STATE_SPECS[type(state)]
    return _put(state, specs(ctx), ctx.mesh, what)


def shard_params(params, ctx: ShardingCtx):
    """Split LSH params into per-shard row blocks (identity without a
    mesh); each block's ``L`` is the shard's row count (`_param_specs`)."""
    if ctx.mesh is None:
        return params
    L_local = _check_rows(params.L, ctx.mesh.size, "LSH params")
    blocks = _put(params, _param_specs(params, ctx), ctx.mesh,
                  "LSH params: L * k")
    return tuple(_local_params(p, L_local, i) for i, p in enumerate(blocks))


def gather_params(params, ctx: ShardingCtx):
    """The whole sketch's LSH params on the mesh's first device, from the
    per-shard row blocks `shard_params` gives (the params themselves
    without a mesh)."""
    if ctx.mesh is None:
        return params
    whole = _gather(params, _param_specs(params[0], ctx), ctx.mesh)
    whole = whole._replace(L=sum(p.L for p in params))
    if isinstance(whole, lsh.PStableParams):
        whole = whole._replace(row0=None)
    return whole


def gather_state(state, ctx: ShardingCtx):
    """The single-device form of a sharded state, on the mesh's first
    device (the state itself without a mesh)."""
    if ctx.mesh is None:
        return state
    specs, _ = _STATE_SPECS[type(state[0])]
    return _gather(state, specs(ctx), ctx.mesh)


def shard_race(state: race.RACEState, params, ctx: ShardingCtx):
    """Place a RACE sketch onto the mesh (rows split, ``n`` replicated)."""
    return shard_state(state, ctx), shard_params(params, ctx)


def shard_swakde(state: swakde.SWAKDEState, params, ctx: ShardingCtx):
    """Place an SW-AKDE sketch onto the mesh (rows split, ``t`` replicated)."""
    return shard_state(state, ctx), shard_params(params, ctx)


def shard_sann(state: sann.SANNState, params, ctx: ShardingCtx):
    """Place an S-ANN sketch onto the mesh (tables split, points/counters
    replicated)."""
    return shard_state(state, ctx), shard_params(params, ctx)


def first_shard(state, ctx: ShardingCtx):
    """Shard 0's state, on the mesh's first device: its replicated leaves
    (``n``, ``t``, the S-ANN counters) are the whole sketch's.  The state
    itself without a mesh."""
    return state if ctx.mesh is None else state[0]


def map_shards(fn: Callable, state, ctx: ShardingCtx):
    """``fn`` on every shard's state (on the state without a mesh); for
    updates of replicated leaves, such as a clock advance."""
    return fn(state) if ctx.mesh is None else tuple(fn(s) for s in state)


def _replicate(x: torch.Tensor, ctx: ShardingCtx) -> list:
    """``x`` on every shard's device (no copy where it already lies)."""
    return [x.to(d) for d in ctx.mesh.devices]


def _cat(parts, ctx: ShardingCtx, dim: int) -> torch.Tensor:
    """The all-gather: per-shard blocks concatenated in shard order on the
    mesh's first device."""
    first = ctx.mesh.devices[0]
    return torch.cat([p.to(first) for p in parts], dim=dim)


def _local_cfg(cfg, ctx: ShardingCtx, what: str):
    return dataclasses.replace(
        cfg, L=_check_rows(cfg.L, ctx_num_shards(ctx), what))


# ---------------------------------------------------------------------------
# RACE
# ---------------------------------------------------------------------------

def sharded_race_update_batch(state, params, xs: torch.Tensor,
                              ctx: ShardingCtx, sign: int = 1):
    """Sharded turnstile batch update: ``xs (B, d)`` replicated to every
    shard, each running `race_update_batch` on its row block.  Counters
    are bit-identical to the single-device call."""
    if ctx.mesh is None:
        return race.race_update_batch(state, params, xs, sign)
    return tuple(race.race_update_batch(st, p, x, sign) for st, p, x in
                 zip(state, params, _replicate(xs, ctx)))


def sharded_race_prepare_chunk(params, xs: torch.Tensor, n_buckets: int,
                               ctx: ShardingCtx):
    """Sharded prepare: each shard hashes the (replicated) chunk with its
    row block and histograms its own rows; pure, no state input."""
    if ctx.mesh is None:
        return race.race_prepare_chunk(params, xs, n_buckets)
    return tuple(race.race_prepare_chunk(p, x, n_buckets)
                 for p, x in zip(params, _replicate(xs, ctx)))


def sharded_race_commit_chunk(state, prep, ctx: ShardingCtx, sign: int = 1):
    """Sharded commit: fold each shard's prep into its counters;
    ``sharded_commit(sharded_prepare(...))`` equals
    `sharded_race_update_batch`."""
    if ctx.mesh is None:
        return race.race_commit_chunk(state, prep, sign)
    return tuple(race.race_commit_chunk(st, pr, sign)
                 for st, pr in zip(state, prep))


def sharded_race_query_batch(state, params, qs: torch.Tensor,
                             ctx: ShardingCtx,
                             median_of_means: int = 0) -> torch.Tensor:
    """Sharded batched query ``qs (B, d)`` → (B,) float32: each shard reads
    its rows (`race.race_row_reads`), the (B, L_local) blocks are gathered
    into (B, L) in row order and `estimate_from_vals` runs once —
    bit-identical to `race_query_batch`."""
    if ctx.mesh is None:
        return race.race_query_batch(state, params, qs, median_of_means)
    vals = [race.race_row_reads(st, p, q) for st, p, q in
            zip(state, params, _replicate(qs, ctx))]
    return race.estimate_from_vals(_cat(vals, ctx, 1), median_of_means)


# ---------------------------------------------------------------------------
# SW-AKDE
# ---------------------------------------------------------------------------

def sharded_swakde_update_chunk(state, params, xs: torch.Tensor,
                                cfg: swakde.SWAKDEConfig, ctx: ShardingCtx):
    """Sharded exact chunk ingest: each shard replays the chunk into its
    row block (rows are independent given the shared clock, which every
    shard advances identically).  Bit-identical to the single-device call."""
    if ctx.mesh is None:
        return swakde.swakde_update_chunk(state, params, xs, cfg)
    cl = _local_cfg(cfg, ctx, "SW-AKDE")
    return tuple(swakde.swakde_update_chunk(st, p, x, cl) for st, p, x in
                 zip(state, params, _replicate(xs, ctx)))


def sharded_swakde_prepare_chunk(params, xs: torch.Tensor,
                                 cfg: swakde.SWAKDEConfig, ctx: ShardingCtx):
    """Sharded prepare: each shard hashes the (replicated) chunk with its
    row block and sorts its rows' codes into segments; pure."""
    if ctx.mesh is None:
        return swakde.swakde_prepare_chunk(params, xs, cfg)
    cl = _local_cfg(cfg, ctx, "SW-AKDE")
    return tuple(swakde.swakde_prepare_chunk(p, x, cl)
                 for p, x in zip(params, _replicate(xs, ctx)))


def sharded_swakde_commit_chunk(state, prep, cfg: swakde.SWAKDEConfig,
                                ctx: ShardingCtx):
    """Sharded commit: each shard drains its row block's segments into its
    EH rows (one `swakde_segment_pass` launch a shard, on its device)."""
    if ctx.mesh is None:
        return swakde.swakde_commit_chunk(state, prep, cfg)
    cl = _local_cfg(cfg, ctx, "SW-AKDE")
    return tuple(swakde.swakde_commit_chunk(st, pr, cl)
                 for st, pr in zip(state, prep))


def sharded_swakde_grid_estimates(state, cfg: swakde.SWAKDEConfig,
                                  ctx: ShardingCtx):
    """Sharded full-grid EH window counts: one ``(L_local, W)`` float32
    block a shard, on its device; concatenated in shard order they are the
    single-device table.  The KDE service's query-side cache."""
    if ctx.mesh is None:
        return swakde.swakde_grid_estimates(state, cfg)
    cl = _local_cfg(cfg, ctx, "SW-AKDE")
    return tuple(swakde.swakde_grid_estimates(st, cl) for st in state)


def sharded_swakde_query_from_grid(grid, params, qs: torch.Tensor,
                                   cfg: swakde.SWAKDEConfig,
                                   ctx: ShardingCtx) -> torch.Tensor:
    """Cached-grid queries on the row-sharded grid of
    `sharded_swakde_grid_estimates`: each shard hashes with its row block
    and reads its grid rows, the blocks are gathered to (B, L) in row order
    and averaged — bit-identical to `swakde.swakde_query_from_grid`."""
    if ctx.mesh is None:
        return swakde.swakde_query_from_grid(grid, params, qs, cfg)
    cl = _local_cfg(cfg, ctx, "SW-AKDE")
    vals = [swakde.swakde_row_estimates_from_grid(g, p, q, cl) for g, p, q in
            zip(grid, params, _replicate(qs, ctx))]
    return mean_last(_cat(vals, ctx, 1))


def sharded_swakde_query_batch(state, params, qs: torch.Tensor,
                               cfg: swakde.SWAKDEConfig,
                               ctx: ShardingCtx) -> torch.Tensor:
    """Sharded batched query ``qs (B, d)`` → (B,) float32 (unnormalised Ŷ):
    per-shard row estimates gathered to (B, L) in row order, then the
    single-device mean.  Bit-identical to `swakde_query_batch`."""
    if ctx.mesh is None:
        return swakde.swakde_query_batch(state, params, qs, cfg)
    cl = _local_cfg(cfg, ctx, "SW-AKDE")
    vals = [swakde.swakde_row_estimates_batch(st, p, q, cl) for st, p, q in
            zip(state, params, _replicate(qs, ctx))]
    return mean_last(_cat(vals, ctx, 1))


# ---------------------------------------------------------------------------
# S-ANN
# ---------------------------------------------------------------------------

def sharded_sann_insert_batch(state, params, xs: torch.Tensor,
                              key: torch.Tensor, cfg: sann.SANNConfig,
                              ctx: ShardingCtx):
    """Sharded batched ingest of ``xs (B, d)``: every shard runs
    `sann_insert_batch` over its table block with the *same* key, so the
    replicated store, keep decisions and counters agree everywhere and the
    table blocks line up with the single-device tables row for row."""
    if ctx.mesh is None:
        return sann.sann_insert_batch(state, params, xs, key, cfg)
    cl = _local_cfg(cfg, ctx, "S-ANN")
    return tuple(sann.sann_insert_batch(st, p, x, k, cl) for st, p, x, k in
                 zip(state, params, _replicate(xs, ctx),
                     _replicate(key, ctx)))


def sharded_sann_prepare_chunk(params, xs: torch.Tensor, key: torch.Tensor,
                               cfg: sann.SANNConfig, ctx: ShardingCtx):
    """Sharded prepare: every shard draws the same keep decisions from the
    same key and builds the append structure of its own table block."""
    if ctx.mesh is None:
        return sann.sann_prepare_chunk(params, xs, key, cfg)
    cl = _local_cfg(cfg, ctx, "S-ANN")
    return tuple(sann.sann_prepare_chunk(p, x, k, cl) for p, x, k in
                 zip(params, _replicate(xs, ctx), _replicate(key, ctx)))


def sharded_sann_commit_chunk(state, prep, cfg: sann.SANNConfig,
                              ctx: ShardingCtx):
    """Sharded commit: every shard rebases the replicated ranks on the
    replicated pointers and commits its own table block (one
    `sann_table_scatter` launch a shard)."""
    if ctx.mesh is None:
        return sann.sann_commit_chunk(state, prep, cfg)
    cl = _local_cfg(cfg, ctx, "S-ANN")
    return tuple(sann.sann_commit_chunk(st, pr, cl)
                 for st, pr in zip(state, prep))


def sharded_sann_merge(a, b, params, cfg: sann.SANNConfig, ctx: ShardingCtx):
    """Disjoint-stream union (`core.sann.sann_merge`): each shard takes the
    stamp-interleaved union of the replicated stores and re-derives its own
    table block, so the result equals the single-device merge block for
    block."""
    if ctx.mesh is None:
        return sann.sann_merge(a, b, params, cfg)
    cl = _local_cfg(cfg, ctx, "S-ANN")
    return tuple(sann.sann_merge(sa, sb, p, cl)
                 for sa, sb, p in zip(a, b, params))


def sharded_sann_delete(state, params, x: torch.Tensor, cfg: sann.SANNConfig,
                        ctx: ShardingCtx, tol: float = 1e-5):
    """Turnstile delete-by-value (§3.4): each shard computes the hit mask
    over its replica of the store and tombstones its own table block."""
    if ctx.mesh is None:
        return sann.sann_delete(state, params, x, cfg, tol)
    cl = _local_cfg(cfg, ctx, "S-ANN")
    return tuple(sann.sann_delete(st, None, xi, cl, tol)
                 for st, xi in zip(state, _replicate(x, ctx)))


def sharded_sann_query_batch(state, params, qs: torch.Tensor,
                             cfg: sann.SANNConfig,
                             ctx: ShardingCtx) -> sann.SANNResult:
    """Sharded (c, r)-queries ``qs (B, d)`` → `SANNResult` of (B,) fields:
    each shard gathers its tables' buckets, the (B, L_local·cap) blocks are
    concatenated in shard order (the single-device row-major order) and
    scored once with the global 3L budget.  Bit-identical to
    `sann_query_batch`."""
    if ctx.mesh is None:
        return sann.sann_query_batch(state, params, qs, cfg)
    cl = _local_cfg(cfg, ctx, "S-ANN")
    parts = [sann.sann_bucket_candidates_batch(st, p, q, cl) for st, p, q in
             zip(state, params, _replicate(qs, ctx))]
    cand = _cat([c for c, _ in parts], ctx, 1)
    ok = _cat([o for _, o in parts], ctx, 1)
    return sann.sann_score_candidates_batch(state[0].points, cand, ok, qs,
                                            3 * cfg.L, cfg)


def _topk_merge(ids: torch.Tensor, dists: torch.Tensor, k_out: int):
    """The cross-shard top-k combine of ``ids/dists (B, n * k_local)``:
    duplicate slot ids (a point in tables of two shards, at the same
    distance on both) keep their first entry, padding scores inf, and the
    k_out smallest distances win, the lowest column on ties (a stable
    sort, as ``lax.top_k`` breaks ties)."""
    order = torch.sort(ids, dim=1, stable=True).indices
    sid = torch.gather(ids, 1, order)
    dup = torch.zeros_like(sid, dtype=torch.bool)
    dup[:, 1:] = (sid[:, 1:] == sid[:, :-1]) & (sid[:, 1:] >= 0)
    dup = torch.zeros_like(dup).scatter_(1, order, dup)
    d = torch.where(dup | (ids < 0), float("inf"), dists)
    d, sel = torch.sort(d, dim=1, stable=True)
    d, sel = d[:, :k_out], sel[:, :k_out]
    return torch.where(torch.isfinite(d), torch.gather(ids, 1, sel), -1), d


def sharded_sann_query_topk_batch(state, params, qs: torch.Tensor,
                                  cfg: sann.SANNConfig, ctx: ShardingCtx,
                                  topk: int = 50):
    """Sharded top-k ``qs (B, d)`` → ``(ids (B, k), dists (B, k))`` with
    ``k = min(topk, L * bucket_cap)``: per-shard `sann_query_topk_batch`
    results gathered and merged (`_topk_merge`).  Exact: every global
    top-k entry is in its own shard's local top-k, and distances agree
    everywhere (replicated store)."""
    if ctx.mesh is None:
        return sann.sann_query_topk_batch(state, params, qs, cfg, topk)
    cl = _local_cfg(cfg, ctx, "S-ANN")
    parts = [sann.sann_query_topk_batch(st, p, q, cl, topk) for st, p, q in
             zip(state, params, _replicate(qs, ctx))]
    return _topk_merge(_cat([i for i, _ in parts], ctx, 1),
                       _cat([d for _, d in parts], ctx, 1),
                       min(topk, cfg.L * cfg.bucket_cap))


# ---------------------------------------------------------------------------
# Tenant fleets (core.fleet): shard the leading [T] tenant axis
# ---------------------------------------------------------------------------
#
# Each shard owns T/num_shards complete sketches and a replica of the
# fleet's params, hashes the whole mixed chunk and commits its own tenants
# (one commit launch a shard); slots owned elsewhere become -1, which the
# fleet ingest drops.  Queries read each request's row on the shard owning
# its tenant; the other shards contribute exact zeros (`torch.where`, never
# a multiply, so inf and -1 padding survive), summed on the first device.

def _fleet_state_specs(ctx: ShardingCtx, state_like):
    """Every leaf of a stacked fleet splits its leading tenant axis."""
    return type(state_like)(*(ctx.spec("tenants", *([None] * (x.dim() - 1)))
                              for x in state_like))


def _param_replicated_specs(params, ctx: ShardingCtx):
    r = ctx.spec()
    if isinstance(params, lsh.SRPParams):
        return params._replace(proj=r, mix=r)
    return params._replace(proj=r, bias=r, mix=r)


def shard_fleet(stacked, params, ctx: ShardingCtx):
    """Place a stacked fleet onto the mesh (tenant axis split, params
    replicated)."""
    if ctx.mesh is None:
        return stacked, params
    return (_put(stacked, _fleet_state_specs(ctx, stacked), ctx.mesh,
                 "fleet: T"),
            _put(params, _param_replicated_specs(params, ctx), ctx.mesh, ""))


def gather_fleet(stacked, ctx: ShardingCtx):
    """The unsharded stacked fleet, on the mesh's first device."""
    if ctx.mesh is None:
        return stacked
    return _gather(stacked, _fleet_state_specs(ctx, stacked[0]), ctx.mesh)


def _local_tids(tids: torch.Tensor, shard: int, T_local: int):
    """Global tenant slots → this shard's block: slots outside
    ``[shard*T_local, (shard+1)*T_local)`` become -1 (dropped / zeroed)."""
    local = tids.long() - shard * T_local
    owned = (local >= 0) & (local < T_local)
    return torch.where(owned, local, -1), owned


def _owner_sum(parts, ctx: ShardingCtx) -> torch.Tensor:
    """The psum of owner-masked parts, on the first device."""
    first = ctx.mesh.devices[0]
    out = parts[0].to(first)
    for p in parts[1:]:
        out = out + p.to(first)
    return out


def _fleet_shards(stacked, params, qs, tids, ctx):
    """``(shard, state, params, rows, local tids, owned)`` a shard."""
    T_local = stacked[0][0].shape[0]
    for sh, (st, p, x, t) in enumerate(zip(stacked, params,
                                           _replicate(qs, ctx),
                                           _replicate(tids, ctx))):
        local, owned = _local_tids(t, sh, T_local)
        yield sh, st, p, x, local, owned


def _clip(local: torch.Tensor, stacked_shard) -> torch.Tensor:
    return local.clamp(0, stacked_shard[0].shape[0] - 1)


def sharded_race_fleet_ingest(stacked, params, xs: torch.Tensor,
                              tids: torch.Tensor, ctx: ShardingCtx):
    """Tenant-sharded fleet ingest: the mixed chunk is replicated, each
    shard counts only the points of tenants it owns.  Bit-identical to
    `fleet.race_fleet_ingest` block for block."""
    if ctx.mesh is None:
        return fleet.race_fleet_ingest(stacked, params, xs, tids)
    return tuple(fleet.race_fleet_ingest(st, p, x, local) for
                 _, st, p, x, local, _ in
                 _fleet_shards(stacked, params, xs, tids, ctx))


def sharded_race_fleet_query(stacked, params, qs: torch.Tensor,
                             tids: torch.Tensor, ctx: ShardingCtx,
                             median_of_means: int = 0) -> torch.Tensor:
    """Tenant-sharded fleet query: each request's (L,) counter reads come
    from the one shard owning its tenant (owner-masked sum), then the
    single-device estimator runs once."""
    if ctx.mesh is None:
        return fleet.race_fleet_query(stacked, params, qs, tids,
                                      median_of_means)
    parts = [torch.where(owned[:, None],
                         fleet.race_fleet_row_reads(st, p, q, _clip(loc, st)),
                         0.0)
             for _, st, p, q, loc, owned in
             _fleet_shards(stacked, params, qs, tids, ctx)]
    return race.estimate_from_vals(_owner_sum(parts, ctx), median_of_means)


def sharded_swakde_fleet_ingest(stacked, params, xs: torch.Tensor,
                                tids: torch.Tensor, cfg: swakde.SWAKDEConfig,
                                cap: int, ctx: ShardingCtx):
    """Tenant-sharded SW-AKDE fleet ingest: each shard routes the mixed
    chunk against its own tenant block (foreign tenants dropped) and
    commits it in one launch."""
    if ctx.mesh is None:
        return fleet.swakde_fleet_ingest(stacked, params, xs, tids, cfg, cap)
    return tuple(fleet.swakde_fleet_ingest(st, p, x, local, cfg, cap) for
                 _, st, p, x, local, _ in
                 _fleet_shards(stacked, params, xs, tids, ctx))


def sharded_swakde_fleet_query(stacked, params, qs: torch.Tensor,
                               tids: torch.Tensor, cfg: swakde.SWAKDEConfig,
                               ctx: ShardingCtx) -> torch.Tensor:
    """Tenant-sharded SW-AKDE fleet query: per-request EH row estimates
    from the owning shard, zero elsewhere, summed, averaged —
    bit-identical to `fleet.swakde_fleet_query`."""
    if ctx.mesh is None:
        return fleet.swakde_fleet_query(stacked, params, qs, tids, cfg)
    parts = [torch.where(owned[:, None], fleet.swakde_fleet_row_estimates(
                 st, p, q, _clip(loc, st), cfg), 0.0)
             for _, st, p, q, loc, owned in
             _fleet_shards(stacked, params, qs, tids, ctx)]
    return mean_last(_owner_sum(parts, ctx))


def sharded_sann_fleet_ingest(stacked, params, xs: torch.Tensor,
                              tids: torch.Tensor, keys: torch.Tensor,
                              cfg: sann.SANNConfig, cap: int,
                              ctx: ShardingCtx):
    """Tenant-sharded S-ANN fleet ingest: the mixed chunk is replicated,
    the per-tenant keys ``keys (T, 2)`` split with the tenant axis, and
    foreign tenants drop to -1.  Bit-identical to `fleet.sann_fleet_ingest`
    block for block."""
    if ctx.mesh is None:
        return fleet.sann_fleet_ingest(stacked, params, xs, tids, keys, cfg,
                                       cap)
    out = []
    for sh, st, p, x, local, _ in _fleet_shards(stacked, params, xs, tids,
                                                ctx):
        T_local = st[0].shape[0]
        k = keys[sh * T_local:(sh + 1) * T_local].to(x.device)
        out.append(fleet.sann_fleet_ingest(st, p, x, local, k, cfg, cap))
    return tuple(out)


def sharded_sann_fleet_query_topk(stacked, params, qs: torch.Tensor,
                                  tids: torch.Tensor, cfg: sann.SANNConfig,
                                  ctx: ShardingCtx, topk: int = 50):
    """Tenant-sharded per-tenant top-k: each request's ids and distances
    come from the one shard owning its tenant row (owner-masked sums keep
    the -1 / inf padding exact).  Slot ids index the request's own tenant
    row, so no cross-shard offset is needed."""
    if ctx.mesh is None:
        return fleet.sann_fleet_query_topk(stacked, params, qs, tids, cfg,
                                           topk)
    ids, dists = [], []
    for _, st, p, q, loc, owned in _fleet_shards(stacked, params, qs, tids,
                                                 ctx):
        i, d = fleet.sann_fleet_query_topk(st, p, q, _clip(loc, st), cfg,
                                           topk)
        ids.append(torch.where(owned[:, None], i, 0))
        dists.append(torch.where(owned[:, None], d, 0.0))
    return _owner_sum(ids, ctx), _owner_sum(dists, ctx)


def sharded_sann_fleet_query(stacked, params, qs: torch.Tensor,
                             tids: torch.Tensor, cfg: sann.SANNConfig,
                             ctx: ShardingCtx) -> sann.SANNResult:
    """Tenant-sharded per-tenant (c, r)-NN queries → `SANNResult` of (B,)
    fields, with the top-k path's owner-masked sums; ``found`` rides as
    int32 and casts back."""
    if ctx.mesh is None:
        return fleet.sann_fleet_query(stacked, params, qs, tids, cfg)
    parts = []
    for _, st, p, q, loc, owned in _fleet_shards(stacked, params, qs, tids,
                                                 ctx):
        res = fleet.sann_fleet_query(st, p, q, _clip(loc, st), cfg)
        parts.append(sann.SANNResult(
            index=torch.where(owned, res.index, 0),
            distance=torch.where(owned, res.distance, 0.0),
            found=torch.where(owned, res.found.to(torch.int32), 0),
            n_candidates=torch.where(owned, res.n_candidates, 0)))
    res = sann.SANNResult(*(_owner_sum(list(f), ctx) for f in zip(*parts)))
    return res._replace(found=res.found.to(torch.bool))
