"""The port's parameter, optimizer-state and batch specs against the
reference's, on shapes alone.

Every configuration's full-size parameter tree (the port's ``init_params``
on the meta device: the reference's names, shapes and dtypes, which
``tests/test_torch_lm_families.py`` holds to ``jax.eval_shape`` of the
reference's ``init_model``), its AdamW and Adam8bit states (the
reference's state types, the port's shapes) and a batch go through the reference's ``param_shardings`` / ``opt_state_shardings`` /
``batch_shardings`` over a ``jax.sharding.AbstractMesh`` (no devices, no
compile) and through the port's over a `Mesh` of CPU entries of the same
shape.  Every leaf's spec must be equal, on meshes (2, 4), (1, 4) and
(pod 2, data 16, model 16) with ``fsdp_over_pod`` off and on.  Placement
(`param_specs.shard_params` / `gather_params`) is exact and follows the
specs: each rank holds its block, and gathering gives the tree back.  A
reference bfloat16 train state (AdamW) of each family that trains on a mesh
since the hybrid, ssm, encdec, vlm and MLA + MTP families joined the dense
and moe ones (`convert.train_state_from_numpy(mesh=)`) lands with every
leaf's spec the reference's ``param_shardings`` / ``opt_state_shardings``
and its dtype kept, and gathers back to the reference's values.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jregistry
from repro.optim import adam as jadam
from repro.parallel import param_specs as jspecs
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.optim import adam as tadam
from repro_torch.parallel import param_specs as tspecs
from repro_torch.parallel.sharding import Mesh, Sharded

from torch_parity import lm_tree_np

MESHES = {"2x4": ((2, 4), ("data", "model"), False),
          "1x4": ((1, 4), ("data", "model"), False),
          "pod": ((2, 16, 16), ("pod", "data", "model"), False),
          "pod_fsdp": ((2, 16, 16), ("pod", "data", "model"), True)}

_TREES: dict = {}


def _meta_trees():
    """Every configuration's parameter tree on the meta device, and the
    reference's ``ShapeDtypeStruct`` twin (drawn once a module)."""
    if not _TREES:
        normal = tlayers._normal       # shapes only: no draw
        tlayers._normal = lambda gen, shape, scale, dtype, device: \
            torch.empty(shape, dtype=dtype, device=device)
        try:
            for arch in registry.ARCH_IDS:
                t = tmodel.init_params(registry.get_config(arch),
                                       torch.Generator(), "meta")
                j = _sds(t)
                opts = []
                for opt, cls in ((tadam.adamw, jadam.AdamState),
                                 (tadam.adam8bit, jadam.Adam8bitState)):
                    st = opt().init(t)
                    opts.append((st, cls(**{f: _sds(getattr(st, f))
                                            for f in cls._fields})))
                _TREES[arch] = (t, j, opts)
        finally:
            tlayers._normal = normal
    return _TREES


def _sds(tree):
    dt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.int8: jnp.int8, torch.int32: jnp.int32}
    if isinstance(tree, dict):
        return {k: _sds(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), dt[tree.dtype])


# The optimizer states are the reference's NamedTuples (``AdamState``,
# ``Adam8bitState``) holding the port's state shapes, which
# tests/test_torch_train.py holds to the reference's leaf for leaf.


def _ref_specs(tree) -> list:
    return [tuple(s.spec) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: hasattr(x, "spec"))]


def _port_specs(tree) -> list:
    return [spec for _, spec in tspecs.leaves_with_paths(tree)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_specs_match_reference_on_every_config(mesh_name):
    sizes, names, over_pod = MESHES[mesh_name]
    jmesh = AbstractMesh(sizes, names)
    tmesh = Mesh(("cpu",) * int(np.prod(sizes)), axis_names=names,
                 axis_sizes=sizes)
    batch_t = {"tokens": torch.empty((256, 4096), dtype=torch.int32,
                                     device="meta")}
    batch_j = {"tokens": jax.ShapeDtypeStruct((256, 4096), jnp.int32)}
    assert _port_specs(tspecs.batch_shardings(batch_t, tmesh)) == \
        _ref_specs(jspecs.batch_shardings(batch_j, jmesh))
    split = 0
    for arch, (tree, sds, opts) in _meta_trees().items():
        pj = jspecs.param_shardings(sds, jmesh, fsdp_over_pod=over_pod)
        pt = tspecs.param_shardings(tree, tmesh, fsdp_over_pod=over_pod)
        got, want = _port_specs(pt), _ref_specs(pj)
        assert got == want, arch
        split += sum(any(a is not None for a in s) for s in want)
        for st_t, st_j in opts:         # AdamW, Adam8bit
            oj = jspecs.opt_state_shardings(st_j, pj, jmesh)
            ot = tspecs.opt_state_shardings(st_t, pt, tmesh)
            assert _port_specs(ot) == _ref_specs(oj), (arch, type(st_t))
    assert split > 0       # the meshes do split leaves


def test_shard_and_gather_params_round_trip():
    cfg = dataclasses.replace(registry.get_smoke_config("deepseek-moe-16b"),
                              param_dtype="float32")
    tree = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_test_mesh(2, 4, "cpu")
    sh = tspecs.shard_params(tree, mesh)
    specs = tspecs.param_shardings(tree, mesh)
    wg = sh["moe_blocks"]["moe"]["w_gate"]
    assert wg.spec == specs["moe_blocks"]["moe"]["w_gate"] == \
        (None, "model", "data", None)
    for r, block in enumerate(wg.shards):
        d, m = mesh.coords(r)
        E, dm = wg.shape[1] // 4, wg.shape[2] // 2
        assert torch.equal(block, tree["moe_blocks"]["moe"]["w_gate"][
            :, m * E:(m + 1) * E, d * dm:(d + 1) * dm])
    back = tspecs.gather_params(sh, "cpu")
    for _, a, b in tspecs.leaves_with_paths(tree, back):
        assert torch.equal(a, b)


def test_train_state_from_numpy_places_every_family():
    for arch in ("deepseek-v3-671b", "zamba2-2.7b", "xlstm-125m",
                 "whisper-large-v3", "internvl2-76b"):
        _check_placed_state(arch)


def _check_placed_state(arch):
    cfg = jregistry.get_smoke_config(arch)         # bfloat16, as published
    tree = lm_tree_np(cfg, 21)
    moments = jax.tree.map(lambda x: np.full(x.shape, 0.25, np.float32), tree)
    state = jts.TrainState(params=tree, opt_state=jadam.AdamState(
        step=np.int32(3), m=moments, v=moments), step=np.int32(3))
    mesh = make_test_mesh(2, 2, "cpu")
    got = convert.train_state_from_numpy(state, mesh=mesh)
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)
    pj = jspecs.param_shardings(sds, jmesh)
    oj = jspecs.opt_state_shardings(jadam.AdamState(
        step=jax.ShapeDtypeStruct((), jnp.int32), m=sds, v=sds), pj, jmesh)
    assert _port_specs(tspecs.specs_of(got.params)) == _ref_specs(pj)
    assert _port_specs(tspecs.specs_of(got.opt_state.m)) == _ref_specs(oj.m)
    assert _port_specs(tspecs.specs_of(got.opt_state.v)) == _ref_specs(oj.v)
    back = convert.train_state_to_numpy(got)
    for (k, x), (_, y), (_, b) in zip(tckpt._flatten(got.params),
                                      tckpt._flatten(tree),
                                      tckpt._flatten(back["params"])):
        assert isinstance(x, Sharded), k
        assert x.dtype == (torch.float32 if y.dtype == np.float32
                           else torch.bfloat16), k
        np.testing.assert_array_equal(b, np.asarray(y, np.float32), err_msg=k)
    assert int(back["step"]) == 3 and int(back["opt_state"]["step"]) == 3
