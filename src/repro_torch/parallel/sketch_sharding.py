"""Sketch sharding contexts, single-device branch only.

The reference's ``parallel/sketch_sharding.py`` splits RACE and SW-AKDE
rows and S-ANN tables across a 1-D ``("shard",)`` device mesh, and every
``sharded_*`` function short-circuits to the plain core call when the
context has no mesh.  The services call it through such a context, so the
port keeps the same entry points with that single-device branch: each
``sharded_*`` function here is the core call of `core.race`, `core.swakde`
or `core.sann`.

Meshes are not ported yet: a context asking for more than one shard (or
carrying a mesh) raises `NotImplementedError`.  The multi-GPU bodies come
with ROADMAP.md queue 1, item 3 (sharding).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import race, sann, swakde


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """A sketch context; ``mesh`` is None (one device) in this port."""
    mesh: Optional[object] = None


def _no_mesh(what: str):
    return NotImplementedError(
        f"{what}: sketch sharding across devices is not ported yet (ROADMAP.md "
        "queue 1, item 3); use num_shards <= 1 and mesh=None")


def make_service_ctx(mesh: Optional[object], num_shards: int) -> ShardingCtx:
    """The services' config contract: single-device (``ctx.mesh = None``)
    when neither a mesh nor more than one shard is asked for."""
    if mesh is not None or num_shards > 1:
        raise _no_mesh(f"make_service_ctx(mesh={mesh!r}, num_shards={num_shards})")
    return ShardingCtx()


def ctx_num_shards(ctx: ShardingCtx) -> int:
    """Shard count of a sketch ctx (1 for the single-device path)."""
    if ctx.mesh is not None:
        raise _no_mesh("ctx_num_shards")
    return 1


def _single(ctx: ShardingCtx, what: str) -> None:
    if ctx.mesh is not None:
        raise _no_mesh(what)


# --- RACE -------------------------------------------------------------------

def sharded_race_prepare_chunk(params, xs, n_buckets: int,
                               ctx: ShardingCtx) -> race.RACEPrep:
    _single(ctx, "sharded_race_prepare_chunk")
    return race.race_prepare_chunk(params, xs, n_buckets)


def sharded_race_commit_chunk(state: race.RACEState, prep: race.RACEPrep,
                              ctx: ShardingCtx, sign: int = 1) -> race.RACEState:
    _single(ctx, "sharded_race_commit_chunk")
    return race.race_commit_chunk(state, prep, sign)


def sharded_race_query_batch(state: race.RACEState, params, qs,
                             ctx: ShardingCtx, median_of_means: int = 0):
    _single(ctx, "sharded_race_query_batch")
    return race.race_query_batch(state, params, qs, median_of_means)


# --- SW-AKDE ----------------------------------------------------------------

def sharded_swakde_prepare_chunk(params, xs, cfg: swakde.SWAKDEConfig,
                                 ctx: ShardingCtx) -> swakde.SWAKDEPrep:
    _single(ctx, "sharded_swakde_prepare_chunk")
    return swakde.swakde_prepare_chunk(params, xs, cfg)


def sharded_swakde_commit_chunk(state: swakde.SWAKDEState,
                                prep: swakde.SWAKDEPrep,
                                cfg: swakde.SWAKDEConfig,
                                ctx: ShardingCtx) -> swakde.SWAKDEState:
    _single(ctx, "sharded_swakde_commit_chunk")
    return swakde.swakde_commit_chunk(state, prep, cfg)


def sharded_swakde_grid_estimates(state: swakde.SWAKDEState,
                                  cfg: swakde.SWAKDEConfig, ctx: ShardingCtx):
    _single(ctx, "sharded_swakde_grid_estimates")
    return swakde.swakde_grid_estimates(state, cfg)


def sharded_swakde_query_from_grid(grid, params, qs, cfg: swakde.SWAKDEConfig,
                                   ctx: ShardingCtx):
    _single(ctx, "sharded_swakde_query_from_grid")
    return swakde.swakde_query_from_grid(grid, params, qs, cfg)


def sharded_swakde_query_batch(state: swakde.SWAKDEState, params, qs,
                               cfg: swakde.SWAKDEConfig, ctx: ShardingCtx):
    _single(ctx, "sharded_swakde_query_batch")
    return swakde.swakde_query_batch(state, params, qs, cfg)


# --- S-ANN ------------------------------------------------------------------

def sharded_sann_prepare_chunk(params, xs, key, cfg: sann.SANNConfig,
                               ctx: ShardingCtx) -> sann.SANNPrep:
    _single(ctx, "sharded_sann_prepare_chunk")
    return sann.sann_prepare_chunk(params, xs, key, cfg)


def sharded_sann_commit_chunk(state: sann.SANNState, prep: sann.SANNPrep,
                              cfg: sann.SANNConfig,
                              ctx: ShardingCtx) -> sann.SANNState:
    _single(ctx, "sharded_sann_commit_chunk")
    return sann.sann_commit_chunk(state, prep, cfg)


def sharded_sann_merge(a: sann.SANNState, b: sann.SANNState, params,
                       cfg: sann.SANNConfig, ctx: ShardingCtx) -> sann.SANNState:
    """Disjoint-stream union (`core.sann.sann_merge`), the cluster
    coordinator's S-ANN merge."""
    _single(ctx, "sharded_sann_merge")
    return sann.sann_merge(a, b, params, cfg)


def sharded_sann_delete(state: sann.SANNState, params, x,
                        cfg: sann.SANNConfig, ctx: ShardingCtx,
                        tol: float = 1e-5) -> sann.SANNState:
    _single(ctx, "sharded_sann_delete")
    return sann.sann_delete(state, params, x, cfg, tol)


def sharded_sann_query_batch(state: sann.SANNState, params, qs,
                             cfg: sann.SANNConfig,
                             ctx: ShardingCtx) -> sann.SANNResult:
    _single(ctx, "sharded_sann_query_batch")
    return sann.sann_query_batch(state, params, qs, cfg)


def sharded_sann_query_topk_batch(state: sann.SANNState, params, qs,
                                  cfg: sann.SANNConfig, ctx: ShardingCtx,
                                  topk: int = 50):
    _single(ctx, "sharded_sann_query_topk_batch")
    return sann.sann_query_topk_batch(state, params, qs, cfg, topk)
