"""Parameter sharding rules: path-aware TP/EP + FSDP spec assignment.

The port of the reference's ``parallel/param_specs.py``.  Every weight gets
(a) a tensor-parallel "model" axis on the dimension its product is split
over (column-parallel for up-projections, row-parallel for
down-projections, the expert dim for MoE, the vocab for embeddings), and
(b) an FSDP "data" axis on another dimension when divisible (ZeRO-3: the
train step gathers a layer's weights inside the layer, and the backward
of that gather reduce-scatters its gradients).

Layer-stacked leaves (under ``*blocks*``) never split their leading (layer)
dim: the forward takes one layer at a time.

A spec is a tuple with one entry a dim: None, an axis name, or a tuple of
axis names, as the reference's ``PartitionSpec`` holds them.  A tree's
specs come back as a tree of the same structure.  A leaf's path is the
names the reference's ``_path_names`` takes from a JAX key path: dict keys
and sequence indices; a NamedTuple's field names are not among them.
`shard_params` / `gather_params` place a single-device tree onto a mesh per
its specs (each leaf a `sharding.Sharded`) and take it back.
"""
from __future__ import annotations

from typing import Mapping

import torch

from .sharding import Mesh, Sharded, canonical, shard_tensor

# leaf-name → model-parallel dim (negative = from the end), None: FSDP only
_TP_RULES = {
    # attention
    "wq": -1, "wk": -1, "wv": -1, "wo": -2,
    # mlp
    "w_up": -1, "w_gate": -1, "w_down": -2,
    # embeddings
    "embed": 0, "unembed": -1,
    # mla
    "w_uk": -1, "w_uv": -1, "w_uq": -1, "w_q": -1, "w_o": -2,
    # ssm / xlstm projections: FSDP only (feature dims are split into
    # heterogeneous segments downstream)
    "w_in": None, "w_out": None, "w_x": None, "w_r": None,
    "w_if": None, "w_down_x": None, "w_dq": None, "w_dkv": None,
    "patch_proj": None, "proj": None, "router": None,
    "conv_w": None, "conv_b": None,
}

_MOE_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_with_path(fn, tree, *rest, prefix: tuple = ()):
    """``fn(names, leaf, *leaves of rest)`` on every leaf of ``tree`` and
    the matching entries of the trees in ``rest`` (the same structure), the
    structure kept; dicts walked in JAX's order (keys sorted).  A leaf's
    names are the reference's ``_path_names``: dict keys and list indices;
    a NamedTuple adds no name, as a JAX ``GetAttrKey`` adds none.  A plain
    tuple is a leaf (a spec)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                  prefix=prefix + (str(k),))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, f),
                                           *(getattr(r, f) for r in rest),
                                           prefix=prefix)
                            for f in tree._fields))
    if isinstance(tree, list):
        return [map_with_path(fn, v, *(r[i] for r in rest),
                               prefix=prefix + (str(i),))
                for i, v in enumerate(tree)]
    return fn(prefix, tree, *rest)


def leaves_with_paths(tree, *rest) -> list:
    """``[(names, leaf, *leaves of rest), ...]`` in JAX's flattening order
    (`_map_with_path`'s names)."""
    out: list = []
    map_with_path(lambda *a: out.append(a), tree, *rest)
    return out


def _fsdp(mesh: Mesh, fsdp_over_pod: bool):
    """The FSDP axis (``"data"``, or ``("data", "pod")`` with
    ``fsdp_over_pod`` on a mesh with pods) and its size."""
    shape = mesh.shape
    fsdp_ax = ("data", "pod") if (fsdp_over_pod and "pod" in mesh.axis_names) \
        else "data"
    dsize = shape.get("data", 1) * (
        shape.get("pod", 1) if isinstance(fsdp_ax, tuple) else 1)
    return fsdp_ax, dsize


def spec_for_param(names, shape, mesh: Mesh,
                   fsdp_over_pod: bool = False) -> tuple:
    """The spec of the parameter at path ``names`` (a sequence of str) of
    ``shape``."""
    names = [str(n) for n in names]
    shape = tuple(shape)
    leaf = names[-1] if names else ""
    msize = mesh.shape.get("model", 1)
    fsdp_ax, dsize = _fsdp(mesh, fsdp_over_pod)
    ndim = len(shape)
    axes: list = [None] * ndim

    stacked = any("blocks" in n for n in names)
    lo = 1 if (stacked and ndim >= 2) else 0   # never shard the layer dim

    in_moe = "moe" in names
    if in_moe and leaf in _MOE_EXPERT_LEAVES and ndim - lo >= 3:
        # (L?, E, d, f): EP — experts on "model" (moe_ep needs them there)
        if shape[lo] % msize == 0:
            axes[lo] = "model"
        # FSDP the largest remaining dim
        rest = sorted(range(lo + 1, ndim), key=lambda i: -shape[i])
        for i in rest:
            if shape[i] % dsize == 0:
                axes[i] = fsdp_ax
                break
        return tuple(axes)

    tp_dim = _TP_RULES.get(leaf, None)
    if leaf in ("unembed", "embed") and ndim - lo >= 2:
        # the vocab dim carries BOTH model and fsdp axes: gathering the
        # (small) weight beats summing fp32 (B, S, V) logits over the
        # contraction
        vdim = (0 if leaf == "embed" else ndim - 1)
        both = ("model",) + (fsdp_ax if isinstance(fsdp_ax, tuple) else (fsdp_ax,))
        if shape[vdim] % (msize * dsize) == 0:
            axes[vdim] = both
            return tuple(axes)
        if shape[vdim] % msize == 0:
            axes[vdim] = "model"
            return tuple(axes)
    if tp_dim is not None and ndim - lo >= 2:
        i = tp_dim % ndim
        if i >= lo and shape[i] % msize == 0:
            axes[i] = "model"
    # FSDP: largest unassigned dim divisible by the data axis
    rest = sorted(range(lo, ndim), key=lambda i: -shape[i])
    for i in rest:
        if axes[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize * 2:
            axes[i] = fsdp_ax
            break
    return tuple(axes)


def param_shardings(params, mesh: Mesh, fsdp_over_pod: bool = False):
    """A tree of parameters (anything with a ``shape``) → the tree of their
    specs."""
    return map_with_path(
        lambda names, leaf: spec_for_param(names, leaf.shape, mesh,
                                           fsdp_over_pod=fsdp_over_pod),
        params)


def batch_axes(mesh: Mesh) -> tuple:
    """The data-parallel axes the batch dim splits over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_shardings(batch, mesh: Mesh):
    """Inputs: the batch dim over all DP axes."""
    dp = canonical(batch_axes(mesh))
    return map_with_path(
        lambda names, leaf: (dp,) + (None,) * (len(leaf.shape) - 1), batch)


def opt_state_shardings(opt_state, params_specs, mesh: Mesh):
    """Optimizer moments inherit their parameter's spec when the ranks
    match (axes that no longer divide dropped: per-block scale dims);
    quantised / factored states fall back to a flat FSDP split of dim 0."""
    flat_params = dict(leaves_with_paths(params_specs))
    shape = mesh.shape

    def f(names, leaf):
        lshape = tuple(leaf.shape)
        # match on the param-path suffix inside the optimizer-state tree
        for pnames, spec in flat_params.items():
            if names[-len(pnames):] == pnames and len(spec) == len(lshape):
                fixed = []
                for dim, ax in zip(lshape, spec):
                    sz = 1
                    for a in (ax if isinstance(ax, tuple) else (ax,)):
                        if a is not None:
                            sz *= shape[a]
                    fixed.append(ax if ax is not None and dim % sz == 0 else None)
                return tuple(fixed)
        # fallback (8-bit codes / scales, factored stats): shard dim0 as
        # hard as divisibility allows — jointly over (data, model) if
        # possible.
        if len(lshape) >= 1:
            n0 = lshape[0]
            for ax in (("data", "model"), "data", "model"):
                sz = 1
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    sz *= shape.get(a, 1)
                if n0 % sz == 0 and n0 >= 2 * sz:
                    return (ax,) + (None,) * (len(lshape) - 1)
        return ()
    return map_with_path(f, opt_state)


def shard_params(tree, mesh: Mesh, specs=None, fsdp_over_pod: bool = False):
    """Place a single-device tree (of any device, the host's included) onto
    ``mesh``: every tensor leaf a `Sharded` per ``specs`` (default
    `param_shardings`); each rank's block a contiguous tensor of its own.
    A 0-d tensor (an optimizer's step counter) goes to the mesh's first
    device whole."""
    if specs is None:
        specs = param_shardings(tree, mesh, fsdp_over_pod=fsdp_over_pod)

    def place(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dim() == 0:
            return x.to(mesh.devices[0])
        return shard_tensor(x, spec, mesh)
    return map_with_path(lambda _, x, spec: place(x, spec), tree, specs)


def _map_leaves(fn, tree):
    return map_with_path(lambda _, x: fn(x), tree)


def gather_params(tree, device=None):
    """Inverse of `shard_params`: every `Sharded` leaf as the global tensor
    on ``device`` (default: the mesh's first device; ``"cpu"`` assembles
    the tree on the host without a whole copy on any card)."""
    return _map_leaves(lambda x: x.full(device) if isinstance(x, Sharded)
                       else x, tree)


def meta_like(tree):
    """The tree with every `Sharded` leaf a meta tensor of its global shape
    and dtype (a structure to restore a gathered checkpoint into)."""
    return _map_leaves(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                             device="meta")
                       if isinstance(x, Sharded) else x, tree)


def specs_of(tree):
    """The specs of a tree's `Sharded` leaves (``()`` for any other)."""
    return _map_leaves(lambda x: x.spec if isinstance(x, Sharded) else (),
                       tree)
