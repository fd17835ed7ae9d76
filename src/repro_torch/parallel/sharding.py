"""Logical-axis sharding rules, the mesh, sharded leaves and the collectives.

The port of the reference's ``parallel/sharding.py``.  Code names a
tensor's axes *logically* (``"batch"``, ``"heads"``, ``"sketch_rows"``,
...) and `ShardingCtx.spec` maps each name onto an axis of the mesh (or a
tuple of axes), or to None (replicated) when the mesh lacks that axis or
there is no mesh at all.  So the same code runs on one device and on a
mesh.

A `Mesh` is a grid of ``torch.device``s in one process, with named axes:
the 1-D ``("shard",)`` mesh of the sketches, or the LM's ``(data, model)``
(and ``(pod, data, model)``) meshes.  Rank r (row-major over the axes)
lives on ``devices[r]``.  A device may appear more than once (several
ranks on one card, or on the CPU), which is how a one-card machine and the
CPU tests run a mesh of any size.  One controller issues every rank's work
from one thread, as the reference's single controller does; no process
group is used.

A leaf placed on a mesh is a `Sharded`: one block a rank, split per its
spec.  The collectives (`psum`, `pmean`, `all_gather`, `axis_index`) take
one tensor a rank and give one a rank.  They move blocks with
``Tensor.to`` (peer to peer between cards) and add them in axis order, so
every rank of a group gets the same bits, and they are differentiable: the
backward of an all-gather is the reduce-scatter, the backward of a sum
over an axis the broadcast.  Ranks that share a device share one result
tensor.  `ShardingCtx.constrain` places a tensor, or re-lays a `Sharded`
one, per the spec of logical names; ``named`` gives the placement (a
`NamedSharding`) such a spec stands for.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence

import torch

# logical name → mesh axis (or tuple of axes)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "embed": None,          # d_model stays replicated (activations)
    "seq": None,
    "seq_sp": "model",      # Megatron-SP residual stream between layers
    "kv_seq": "data",       # sequence parallelism for long-context decode
    "conv": None,
    "state": None,
    # sketch-state axes (parallel.sketch_sharding): RACE / SW-AKDE rows and
    # S-ANN tables live on the 1-D "shard" mesh axis; on meshes without
    # that axis (the training meshes above) they stay replicated.
    "sketch_rows": "shard",
    "sketch_tables": "shard",
    # stacked tenant-fleet states (core.fleet): the leading [T] tenant axis
    # splits across the same 1-D "shard" mesh.
    "tenants": "shard",
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices in one process.  ``devices`` is flat, row-major
    over ``axis_names``; ``axis_sizes`` defaults to one axis of every
    device.  ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does."""
    devices: tuple
    axis_names: tuple = ("shard",)
    axis_sizes: Optional[tuple] = None

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices are of one type, got {devs}")
        if devs[0].type == "cuda":      # a launch needs the card's index
            devs = tuple(torch.device("cuda", torch.cuda.current_device())
                         if d.index is None else d for d in devs)
        names = tuple(self.axis_names)
        sizes = (len(devs),) if self.axis_sizes is None \
            else tuple(int(s) for s in self.axis_sizes)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} with sizes {sizes}")
        if math.prod(sizes) != len(devs):
            raise ValueError(f"a {sizes} mesh needs {math.prod(sizes)} "
                             f"devices, got {len(devs)}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, rank: int) -> tuple:
        """Rank ``rank``'s index along each axis."""
        out = []
        for s in reversed(self.axis_sizes):
            out.append(rank % s)
            rank //= s
        return tuple(reversed(out))

    def rank_of(self, coords: Sequence[int]) -> int:
        r = 0
        for c, s in zip(coords, self.axis_sizes):
            r = r * s + c
        return r

    def group(self, rank: int, axes: Sequence[str]) -> list:
        """The ranks that differ from ``rank`` only along ``axes``, in the
        row-major order of ``axes`` (as named)."""
        c = list(self.coords(rank))
        pos = [self.axis_names.index(a) for a in axes]
        out = []
        for idx in itertools.product(*(range(self.axis_sizes[p]) for p in pos)):
            for p, i in zip(pos, idx):
                c[p] = i
            out.append(self.rank_of(c))
        return out


def _axes(ax) -> tuple:
    """A spec entry (None, an axis name or a tuple of them) as a tuple."""
    if ax is None:
        return ()
    return tuple(ax) if isinstance(ax, tuple) else (ax,)


def canonical(ax):
    """A spec entry as ``PartitionSpec`` holds it: an empty tuple is None,
    a tuple of one axis that axis's name."""
    if isinstance(ax, tuple) and len(ax) <= 1:
        return ax[0] if ax else None
    return ax


def _on_mesh(mesh: Mesh, axes) -> tuple:
    """The named axes (a name or a tuple of names) that ``mesh`` has."""
    return tuple(a for a in _axes(axes) if a in mesh.axis_names)


def axis_index(mesh: Mesh, rank: int, axis) -> int:
    """Rank ``rank``'s index along ``axis`` (a tuple of axes: their joint
    row-major index), as ``lax.axis_index``."""
    idx = 0
    c = mesh.coords(rank)
    for a in _on_mesh(mesh, axis):
        p = mesh.axis_names.index(a)
        idx = idx * mesh.axis_sizes[p] + c[p]
    return idx


def axis_size(mesh: Mesh, axis) -> int:
    return math.prod(mesh.shape[a] for a in _on_mesh(mesh, axis))


def _group_key(mesh: Mesh, rank: int, axes: tuple) -> tuple:
    """What identifies ``rank``'s group along ``axes``: its coordinates on
    every other axis."""
    c = mesh.coords(rank)
    return tuple(ci for a, ci in zip(mesh.axis_names, c) if a not in axes)


def psum(xs: Sequence[torch.Tensor], mesh: Mesh, axis) -> list:
    """Per-rank sums over each rank's group along ``axis`` (a name or a
    tuple of names): the group's terms added in axis order on each rank's
    device, in the terms' dtype."""
    axes = _on_mesh(mesh, axis)
    if not axes:
        return list(xs)
    done: dict = {}
    out = []
    for r in range(mesh.size):
        dev = mesh.devices[r]
        key = (_group_key(mesh, r, axes), dev)
        if key not in done:
            terms = [xs[q].to(dev) for q in mesh.group(r, axes)]
            acc = terms[0]
            for t in terms[1:]:
                acc = acc + t
            done[key] = acc
        out.append(done[key])
    return out


def pmean(xs: Sequence[torch.Tensor], mesh: Mesh, axis) -> list:
    """`psum` divided by the group's size."""
    n = axis_size(mesh, axis)
    return [s / n for s in psum(xs, mesh, axis)] if n > 1 else list(xs)


def merge_partials(parts: Sequence[tuple], mesh: Mesh, axis) -> list:
    """Flash-decode partials merged over each rank's group along ``axis``
    (the ranks that hold the other blocks of a sequence), in rank order:
    ``parts[r]`` is ``(o, m, l)`` (``o`` normalised by ``l``; ``m``, ``l``
    shaped as ``o`` without its last dim) or ``(o, lse)``.  Each rank gets
    ``sum_q w_q o_q / sum_q w_q`` with ``w_q = l_q exp(m_q - max m)``, on its
    device; a rank with nothing live (``m = -inf``, ``l = 0``, or ``lse =
    -inf``) weighs 0, and a group with nothing live gives zeros."""
    axes = _on_mesh(mesh, axis)
    done: dict = {}
    out = []
    for r in range(mesh.size):
        dev = mesh.devices[r]
        group = mesh.group(r, axes) if axes else [r]
        key = (_group_key(mesh, r, axes), dev)
        if key not in done:
            ms, ls, os_ = [], [], []
            for q in group:
                o, *ml = parts[q]
                if len(ml) == 1:
                    m, l = ml[0], (ml[0] > float("-inf")).to(o.dtype)
                else:
                    m, l = ml
                os_.append(o.to(dev))
                ms.append(m.to(dev))
                ls.append(l.to(dev))
            top = ms[0]
            for m in ms[1:]:
                top = torch.maximum(top, m)
            top = torch.clamp(top, min=-1e30)
            num = den = None
            for o, m, l in zip(os_, ms, ls):
                w = l * torch.exp(m - top)
                num = o * w[..., None] if num is None else num + o * w[..., None]
                den = w if den is None else den + w
            done[key] = num / torch.clamp(den, min=1e-30)[..., None]
        out.append(done[key])
    return out


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh, axis,
               dim: int) -> list:
    """Per-rank concatenations along ``dim`` of the blocks of each rank's
    group along ``axis``, in axis order (``lax.all_gather(tiled=True)``):
    `Sharded.gather_dims`, one autograd node (`_AllGather`)."""
    axes = _on_mesh(mesh, axis)
    if not axes:
        return list(xs)
    shape = list(xs[0].shape)
    shape[dim] *= axis_size(mesh, axes)
    spec = [None] * len(shape)
    spec[dim] = canonical(axes)
    return Sharded(list(xs), tuple(spec), mesh, tuple(shape)).gather_dims([dim])


# ---------------------------------------------------------------------------
# Sharded leaves
# ---------------------------------------------------------------------------

def _blocks(shape: tuple, spec: tuple, mesh: Mesh, rank: int) -> list:
    """Rank ``rank``'s block of a ``shape`` tensor split per ``spec``: one
    ``(start, length)`` a dim.  A dim split over several axes splits
    row-major over them (the first named is the major one)."""
    out = []
    for n, ax in zip(shape, spec):
        k = axis_size(mesh, ax)
        if n % k:
            raise ValueError(f"dim {n} of {shape} does not split {k} ways "
                             f"({spec})")
        size = n // k
        out.append((axis_index(mesh, rank, ax) * size, size))
    return out


def check_spec(shape: tuple, spec: tuple, mesh: Mesh) -> tuple:
    """``spec`` padded with None to ``shape``'s rank, checked against the
    mesh (axes it has, each once, each dim dividing)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for a tensor of shape {shape}")
    used = [a for ax in spec for a in _axes(ax)]
    if len(set(used)) != len(used) or any(a not in mesh.axis_names
                                          for a in used):
        raise ValueError(f"spec {spec} on a mesh of axes {mesh.axis_names}")
    _blocks(shape, spec, mesh, 0)
    return spec


@dataclasses.dataclass(eq=False)
class Sharded:
    """One leaf of a tree placed on a mesh: ``shards[r]`` is rank r's block
    (on ``mesh.devices[r]``) of the global tensor of ``shape``, split per
    ``spec`` (one entry a dim: None, an axis name, or a tuple of axis
    names).  Ranks that differ only along axes the spec does not name hold
    equal copies, each its own tensor."""
    shards: list
    spec: tuple
    mesh: Mesh
    shape: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def __getitem__(self, i: int) -> "Sharded":
        """Entry ``i`` of the leading axis (a layer of a stack), which no
        spec splits."""
        if self.spec[0] is not None:
            raise ValueError(f"the leading axis of {self.spec} is split")
        return Sharded([s[i] for s in self.shards], self.spec[1:], self.mesh,
                       self.shape[1:])

    def gathered(self, keep: Sequence[str] = ()) -> list:
        """One tensor a rank: its block with every split dim gathered
        whole, but a dim split only over axes in ``keep``, which stays the
        rank's block (differentiable; ranks on one device share one
        result)."""
        keep = set(keep)
        return self.gather_dims([i for i, ax in enumerate(self.spec)
                                 if _axes(ax) and not set(_axes(ax)) <= keep])

    def gather_dims(self, dims: Sequence[int]) -> list:
        """One tensor a rank: its block with the split ``dims`` gathered
        whole (the all-gather over their axes; `_AllGather`)."""
        dims = [i for i in dims if _axes(self.spec[i])]
        if not dims:
            return list(self.shards)
        mesh = self.mesh
        axes = tuple(a for i in dims for a in _axes(self.spec[i]))
        keys, plan, out = {}, [], []
        for r in range(mesh.size):
            dev = mesh.devices[r]
            key = (_group_key(mesh, r, axes), dev)
            if key not in keys:
                keys[key] = len(plan)
                shape = list(self.shards[r].shape)
                for i in dims:
                    shape[i] *= axis_size(mesh, self.spec[i])
                parts = [(q, tuple(axis_index(mesh, q, self.spec[i])
                                   * self.shards[q].shape[i] for i in dims))
                         for q in mesh.group(r, axes)]
                plan.append((dev, tuple(shape), tuple(dims), parts))
            out.append(keys[key])
        gathered = _AllGather.apply(plan, *self.shards)
        return [gathered[k] for k in out]

    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (the mesh's first by default),
        assembled from one copy of each block."""
        device = self.mesh.devices[0] if device is None else torch.device(device)
        t = torch.empty(self.shape, dtype=self.dtype, device=device)
        self.write_to(t)
        return t

    def write_to(self, t: torch.Tensor) -> None:
        for r, _ in self.distinct():
            view = t
            for d, (start, size) in enumerate(_blocks(self.shape, self.spec,
                                                      self.mesh, r)):
                view = view.narrow(d, start, size)
            view.copy_(self.shards[r])

    def read_from(self, t: torch.Tensor) -> None:
        """Every rank's block copied from the global tensor ``t``."""
        for r, s in enumerate(self.shards):
            view = t
            for d, (start, size) in enumerate(_blocks(self.shape, self.spec,
                                                      self.mesh, r)):
                view = view.narrow(d, start, size)
            s.copy_(view)

    def distinct(self) -> list:
        """``(rank, block)`` for one copy of each distinct block: the ranks
        at index 0 along every axis the spec does not name."""
        named = {a for ax in self.spec for a in _axes(ax)}
        out = []
        for r, s in enumerate(self.shards):
            c = self.mesh.coords(r)
            if all(ci == 0 for a, ci in zip(self.mesh.axis_names, c)
                   if a not in named):
                out.append((r, s))
        return out

    def replica_groups(self) -> list:
        """The groups of ranks that hold equal copies of one block."""
        named = {a for ax in self.spec for a in _axes(ax)}
        rep = tuple(a for a in self.mesh.axis_names if a not in named)
        return [self.mesh.group(r, rep) for r, _ in self.distinct()]


def _view(t: torch.Tensor, dims, starts, shape) -> torch.Tensor:
    for i, s0 in zip(dims, starts):
        t = t.narrow(i, s0, shape[i])
    return t


class _AllGather(torch.autograd.Function):
    """The all-gather of every block a `Sharded.gather_dims` call reads, as
    one autograd node: ``plan`` gives each output its device, shape, the
    gathered dims and the ranks whose blocks it holds (with their
    offsets).  Its backward, the reduce-scatter, adds each block's
    gradient slices from the outputs that read it in output order, on the
    block's device, whatever card's thread runs the node: a step on
    several cards repeats bit for bit."""

    @staticmethod
    def forward(ctx, plan, *shards):
        ctx.plan = plan
        ctx.shards = [(s.shape, s.device) for s in shards]
        outs = []
        for dev, shape, dims, parts in plan:
            t = torch.empty(shape, dtype=shards[0].dtype, device=dev)
            for q, starts in parts:
                _view(t, dims, starts, shards[q].shape).copy_(shards[q])
            outs.append(t)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        out = [None] * len(ctx.shards)
        for g, (_, _, dims, parts) in zip(grads, ctx.plan):
            if g is None:
                continue
            for q, starts in parts:
                shape, dev = ctx.shards[q]
                piece = _view(g, dims, starts, shape).to(dev)
                out[q] = piece.clone() if out[q] is None else out[q] + piece
        return (None, *out)


def shard_tensor(x: torch.Tensor, spec: tuple, mesh: Mesh) -> Sharded:
    """Place ``x`` onto ``mesh`` per ``spec``: each rank's block a
    contiguous tensor of its own on its device."""
    spec = check_spec(tuple(x.shape), spec, mesh)
    shards = []
    for r, dev in enumerate(mesh.devices):
        view = x
        for d, (start, size) in enumerate(_blocks(tuple(x.shape), spec, mesh, r)):
            view = view.narrow(d, start, size)
        out = torch.empty(view.shape, dtype=x.dtype, device=dev)
        shards.append(out.copy_(view))
    return Sharded(shards, spec, mesh, tuple(x.shape))


def zeros_sharded(shape: tuple, dtype, spec: tuple, mesh: Mesh) -> Sharded:
    """A `Sharded` of zeros, made on each rank's device."""
    spec = check_spec(tuple(shape), spec, mesh)
    shards = [torch.zeros(tuple(s for _, s in _blocks(tuple(shape), spec, mesh, r)),
                          dtype=dtype, device=dev)
              for r, dev in enumerate(mesh.devices)]
    return Sharded(shards, spec, mesh, tuple(shape))


def sharded_like(like: Sharded, shards: list) -> Sharded:
    return Sharded(list(shards), like.spec, like.mesh, like.shape)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a spec places a tensor on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Mesh
    spec: tuple


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: Optional[Mesh]
    rules: dict

    def spec(self, *names: Optional[str]) -> tuple:
        """Per-axis mesh axis (a name, a tuple of names, or None:
        replicated) for logical ``names``."""
        axes = []
        for n in names:
            ax = self.rules.get(n) if n else None
            if isinstance(ax, tuple):
                ax = canonical(tuple(a for a in ax if self.mesh
                                     and a in self.mesh.axis_names))
            elif ax is not None and (self.mesh is None
                                     or ax not in self.mesh.axis_names):
                ax = None
            axes.append(ax)
        return tuple(axes)

    def named(self, *names: Optional[str]) -> Optional[NamedSharding]:
        """The placement logical ``names`` give on the mesh (None without
        one)."""
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(*names))

    def constrain(self, x, *names: Optional[str]):
        """``x`` re-laid to the placement of logical ``names``: a global
        tensor is placed per that spec; a `Sharded` gathers the dims whose
        axes change and each rank narrows them to its block of the new
        spec (differentiable).  Without a mesh, ``x`` itself."""
        if self.mesh is None:
            return x
        target = check_spec(tuple(x.shape), self.spec(*names), self.mesh)
        if not isinstance(x, Sharded):
            return shard_tensor(x, target, self.mesh)
        if x.mesh is not self.mesh and x.mesh != self.mesh:
            raise ValueError("constrain: a value of another mesh")
        moved = [i for i, (a, b) in enumerate(zip(x.spec, target)) if a != b]
        if not moved:
            return x
        shards = []
        for r, t in enumerate(x.gather_dims(moved)):
            blocks = _blocks(x.shape, target, self.mesh, r)
            for d in moved:
                t = t.narrow(d, *blocks[d])
            shards.append(t)
        return Sharded(shards, target, self.mesh, x.shape)


def make_ctx(mesh: Optional[Mesh], rules: Optional[dict] = None) -> ShardingCtx:
    return ShardingCtx(mesh=mesh, rules=dict(DEFAULT_RULES, **(rules or {})))


NULL_CTX = ShardingCtx(mesh=None, rules=DEFAULT_RULES)
