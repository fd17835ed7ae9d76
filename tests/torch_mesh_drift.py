"""How far a (data, model) mesh moves deepseek-v3's loss, in the reference
and in the port, on the CPU.

Not a test: a measurement.  deepseek-v3-671b's smoke config in float32,
dropless (capacity factor n_experts / topk), the tree drawn by
`torch_parity.lm_tree_np`, B 4 x S 256 tokens, at the smoke config's depth
(1 dense + 3 MoE layers) and cut to 1 dense + 1 MoE.  For each, the
reference's ``train_step.loss_fn`` on one device and on a 2 x 2 mesh of
host devices (its parameters and batch placed by its ``param_specs``, the
MoE expert-parallel through ``moe_ep``), and the port's ``loss_fn`` on one
device and on ``make_test_mesh(2, 2, "cpu")``.  Prints one JSON line a
depth: each package's ``ce`` and ``mtp_ce`` on one device and on the mesh,
and their differences.

    PYTHONPATH=src python tests/torch_mesh_drift.py
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses   # noqa: E402
import json          # noqa: E402

import jax           # noqa: E402
import numpy as np   # noqa: E402
import torch         # noqa: E402

from repro.configs import registry as jregistry           # noqa: E402
from repro.launch.mesh import make_test_mesh as jmesh      # noqa: E402
from repro.parallel import param_specs as jspecs          # noqa: E402
from repro.train import train_step as jts                 # noqa: E402
from repro_torch import convert                           # noqa: E402
from repro_torch.launch.mesh import make_test_mesh        # noqa: E402
from repro_torch.parallel import param_specs as tspecs    # noqa: E402
from repro_torch.parallel.sharding import make_ctx        # noqa: E402
from repro_torch.train import train_step as tts           # noqa: E402

from torch_parity import lm_tree_np, port_model_cfg       # noqa: E402

ARCH, B, S, SEED = "deepseek-v3-671b", 4, 256, 11
KEYS = ("ce", "mtp_ce")


def _ref(cfg, tree, batch, mesh):
    ctx = jts.make_ctx(mesh)
    fn = lambda p, b: jts.loss_fn(p, cfg, b, ctx)[1]
    if mesh is None:
        m = jax.jit(fn)(tree, batch)
    else:
        p_sh = jspecs.param_shardings(tree, mesh)
        b_sh = jspecs.batch_shardings(batch, mesh)
        m = jax.jit(fn, in_shardings=(p_sh, b_sh))(
            jax.device_put(tree, p_sh), jax.device_put(batch, b_sh))
    return {k: float(m[k]) for k in KEYS}


def _port(cfg, tree, batch, mesh):
    params = convert.train_params_from_numpy(tree, "cpu")
    if mesh is not None:
        params = tspecs.shard_params(params, mesh)
    with torch.no_grad():
        _, m = tts.loss_fn(params, port_model_cfg(cfg),
                           convert.train_params_from_numpy(batch, "cpu"),
                           make_ctx(mesh))
    return {k: float(m[k]) for k in KEYS}


def main():
    base = dataclasses.replace(jregistry.get_smoke_config(ARCH),
                               param_dtype="float32")
    base = dataclasses.replace(
        base, capacity_factor=base.n_experts / base.moe_topk)
    for layers in (base.n_layers, base.n_dense_layers + 1):
        cfg = dataclasses.replace(base, n_layers=layers)
        tree = lm_tree_np(cfg, SEED)
        tokens = np.random.default_rng(SEED + 1).integers(
            0, cfg.vocab, (B, S)).astype(np.int32)
        batch = {"tokens": tokens}
        row = {"arch": ARCH, "layers": layers,
               "moe_layers": layers - cfg.n_dense_layers, "B": B, "S": S}
        for name, run, mesh in (("reference", _ref, jmesh(2, 2)),
                                ("port", _port, make_test_mesh(2, 2, "cpu"))):
            one, on_mesh = run(cfg, tree, batch, None), run(cfg, tree, batch,
                                                           mesh)
            row[name] = {"one_device": one, "mesh_2x2": on_mesh,
                         "abs_diff": {k: abs(on_mesh[k] - one[k])
                                      for k in KEYS}}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
