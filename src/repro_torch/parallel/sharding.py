"""Logical-axis sharding rules for the sketch mesh.

The port of the reference's ``parallel/sharding.py`` for the sketches: code
names a tensor's axes *logically* (``"sketch_rows"``, ``"sketch_tables"``,
``"tenants"``) and `ShardingCtx.spec` maps each name onto an axis of the
mesh, or to None (replicated) when the mesh lacks that axis or there is no
mesh at all.  So the same code runs on one device and on a mesh.

A `Mesh` here is a 1-D tuple of ``torch.device``s in one process: shard i
lives on ``devices[i]``.  A device may appear more than once (several
shards on one card, or on the CPU), which is how a one-card machine and
the CPU tests run a mesh of any size.  The LM's logical axes (batch,
heads, ...) and the reference's ``constrain`` / ``named`` serve its
tensor parallelism and are not ported with the sketches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# logical name → mesh axis: RACE / SW-AKDE rows, S-ANN tables and the
# stacked fleets' tenant axis split across the 1-D "shard" axis.
DEFAULT_RULES = {
    "sketch_rows": "shard",
    "sketch_tables": "shard",
    "tenants": "shard",
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of devices in one process.  ``shape`` maps the axis name
    to the device count, as ``jax.sharding.Mesh.shape`` does."""
    devices: tuple
    axis_names: tuple = ("shard",)

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices are of one type, got {devs}")
        if devs[0].type == "cuda":      # a launch needs the card's index
            devs = tuple(torch.device("cuda", torch.cuda.current_device())
                         if d.index is None else d for d in devs)
        if len(tuple(self.axis_names)) != 1:
            raise ValueError(f"a mesh here is 1-D, got axes {self.axis_names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: Optional[Mesh]
    rules: dict

    def spec(self, *names: Optional[str]) -> tuple:
        """Per-axis mesh axis (or None: replicated) for logical ``names``."""
        axes = []
        for n in names:
            ax = self.rules.get(n) if n else None
            if ax is not None and (self.mesh is None
                                   or ax not in self.mesh.axis_names):
                ax = None
            axes.append(ax)
        return tuple(axes)


def make_ctx(mesh: Optional[Mesh], rules: Optional[dict] = None) -> ShardingCtx:
    return ShardingCtx(mesh=mesh, rules=dict(DEFAULT_RULES, **(rules or {})))


NULL_CTX = ShardingCtx(mesh=None, rules=DEFAULT_RULES)
