"""Johnson–Lindenstrauss baseline for streaming (c,r)-ANN (paper §5.1).

The paper's comparison point, as the reference's ``core/jl.py`` has it:
project every stream point to ``k`` dims with a Gaussian JL map and store
*all* projected points; a query is a brute-force scan in the projected
space.  The map is drawn from a ``torch.Generator`` (the reference draws
threefry normals; parity tests carry its map across).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .util import resolve_device


@dataclasses.dataclass(frozen=True)
class JLConfig:
    dim: int
    k: int          # projected dimension
    capacity: int   # max stream points stored


class JLState(NamedTuple):
    proj: torch.Tensor    # (dim, k) float32 scaled Gaussian map
    store: torch.Tensor   # (capacity, k) float32 projected points
    n: torch.Tensor       # () int32 points inserted


def jl_init(cfg: JLConfig, generator: torch.Generator, device="cuda") -> JLState:
    """Draw the map N(0, 1/k) from ``generator`` (on its own device), then
    place an empty store on ``device``."""
    device = resolve_device(device)
    proj = torch.randn((cfg.dim, cfg.k), generator=generator,
                       device=generator.device) / math.sqrt(cfg.k)
    return JLState(proj=proj.to(device),
                   store=torch.zeros((cfg.capacity, cfg.k), dtype=torch.float32,
                                     device=device),
                   n=torch.zeros((), dtype=torch.int32, device=device))


def jl_insert(state: JLState, x: torch.Tensor, cfg: JLConfig) -> JLState:
    """Store the projection of ``x (d,)`` at slot ``n mod capacity``."""
    store = state.store.clone()
    store[(state.n % cfg.capacity).long()] = x @ state.proj
    return state._replace(store=store, n=state.n + 1)


def jl_insert_stream(state: JLState, xs: torch.Tensor, cfg: JLConfig) -> JLState:
    """`jl_insert` each row of ``xs (T, d)`` in order."""
    for x in xs:
        state = jl_insert(state, x, cfg)
    return state


def jl_query(state: JLState, q: torch.Tensor, cfg: JLConfig, topk: int = 1):
    """Brute scan in projected space for ``q (d,)`` → ``(indices (topk,),
    projected distances (topk,))``, ascending, lowest index on ties; empty
    slots score inf."""
    qp = q @ state.proj
    d2 = ((state.store - qp) ** 2).sum(-1)
    live = torch.arange(cfg.capacity, device=d2.device) < state.n
    d2 = torch.where(live, d2, float("inf"))
    vals, idx = torch.sort(d2, stable=True)
    return idx[:topk], torch.sqrt(vals[:topk])


def jl_query_batch(state: JLState, qs: torch.Tensor, cfg: JLConfig,
                   topk: int = 1):
    """`jl_query` for each row of ``qs (B, d)`` → ``((B, topk), (B, topk))``."""
    out = [jl_query(state, q, cfg, topk) for q in qs]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def jl_bytes(cfg: JLConfig) -> int:
    return cfg.capacity * cfg.k * 4 + cfg.dim * cfg.k * 4
