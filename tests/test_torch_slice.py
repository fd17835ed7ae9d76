"""The port's first slice as a whole against the reference on the CPU.

The reference's params cross over through repro_torch.convert; the port
hashes on its own and draws S-ANN's keep decisions from the same threefry
keys.  A short S-ANN stream and a short SW-AKDE + RACE stream run through
both packages, and the final states and query answers agree: integer state
bit-exact, estimates equal, distances within (1e-5, 1e-6).

Also: the port (every subpackage, and chip_smoke.py) imports neither jax
nor the reference package, and its allocating entry points default to the
card and raise without one.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import race as jrace
from repro.core import sann as jsann
from repro.core import swakde as jswakde
from repro_torch import convert
from repro_torch.core import race as trace
from repro_torch.core import sann as tsann
from repro_torch.core import swakde as tswakde

from torch_parity import (assert_state_equal, assert_topk_match, fields, np_,
                          ref_pstable)

PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def _clustered(n, dim, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1.0, size=(16, dim))
    x = centers[rng.integers(0, 16, n)] + 0.3 * rng.normal(size=(n, dim))
    return x.astype(np.float32)


def test_sann_stream_and_queries_match_reference():
    kw = dict(dim=16, n_max=2000, eta=0.4, r=1.5, c=1.5, w=3.0, L=6, k=3,
              bucket_cap=8)
    cfg_j = jsann.SANNConfig(**kw).resolved()
    params_j = ref_pstable(0, cfg_j.dim, cfg_j.L, cfg_j.k, cfg_j.w,
                           cfg_j.n_buckets)
    st_j = jsann.sann_empty_state(cfg_j)
    cfg_t = tsann.SANNConfig(**kw).resolved()
    params_t = convert.params_from_numpy(fields(params_j), device="cpu")
    st_t = tsann.sann_empty_state(cfg_t, device="cpu")
    prep_j = jax.jit(jsann.sann_prepare_chunk, static_argnums=(3,))
    commit_j = jax.jit(jsann.sann_commit_chunk, static_argnums=(2,))
    xs = _clustered(4 * 256, 16, 1)
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    for i, key in enumerate(keys):
        x = xs[i * 256:(i + 1) * 256]
        pj = prep_j(params_j, jnp.asarray(x), key, cfg_j)
        st_j = commit_j(st_j, pj, cfg_j)
        pt = tsann.sann_prepare_chunk(
            params_t, torch.from_numpy(x),
            convert.key_from_numpy(np.asarray(key), "cpu"), cfg_t)
        st_t = tsann.sann_commit_chunk(st_t, pt, cfg_t)
    assert_state_equal(st_t, st_j)
    assert int(st_t.n_stored) > 20

    stored = np.asarray(st_j.points)[np.asarray(st_j.valid)]
    rng = np.random.default_rng(2)
    qs = (stored[:16] + 0.05 * rng.normal(size=(16, 16))).astype(np.float32)
    rj = jax.jit(jsann.sann_query_batch, static_argnums=(3,))(
        st_j, params_j, jnp.asarray(qs), cfg_j)
    rt = tsann.sann_query_batch(st_t, params_t, torch.from_numpy(qs), cfg_t)
    np.testing.assert_array_equal(np_(rt.index), np.asarray(rj.index))
    np.testing.assert_array_equal(np_(rt.n_candidates), np.asarray(rj.n_candidates))
    np.testing.assert_allclose(np_(rt.distance), np.asarray(rj.distance),
                               rtol=1e-5, atol=1e-6)
    assert np.asarray(rj.found).mean() > 0.5

    ids_j, dj = jax.jit(jsann.sann_query_topk_batch, static_argnums=(3, 4))(
        st_j, params_j, jnp.asarray(qs), cfg_j, 10)
    ids_t, dt = tsann.sann_query_topk_batch(st_t, params_t,
                                            torch.from_numpy(qs), cfg_t, 10)
    pts = np.asarray(st_j.points, np.float64)
    exact = ((pts[None] - qs[:, None].astype(np.float64)) ** 2).sum(-1)
    exact = np.concatenate([exact, np.full((len(qs), 1), np.inf)], 1)
    assert_topk_match(np_(dt) ** 2, np_(ids_t), np.asarray(dj) ** 2,
                      np.asarray(ids_j), exact)


def test_swakde_and_race_stream_match_reference():
    L, W, dim = 6, 24, 16
    params_j = ref_pstable(3, dim, L, 2, 4.0, W)
    params_t = convert.params_from_numpy(fields(params_j), device="cpu")
    kw = dict(L=L, W=W, window=50, eh_eps=0.2)
    cfg_j, cfg_t = jswakde.SWAKDEConfig(**kw), tswakde.SWAKDEConfig(**kw)
    upd_j = jax.jit(jswakde.swakde_update_chunk, static_argnums=(3,))
    race_j = jax.jit(jrace.race_update_batch)
    sw_j, sw_t = jswakde.swakde_init(cfg_j), tswakde.swakde_init(cfg_t, device="cpu")
    rc_j, rc_t = jrace.race_init(L, W), trace.race_init(L, W, device="cpu")
    xs = _clustered(4 * 40, dim, 4)
    for i in range(4):                                   # 160 steps > window
        x = xs[i * 40:(i + 1) * 40]
        sw_j = upd_j(sw_j, params_j, jnp.asarray(x), cfg_j)
        rc_j = race_j(rc_j, params_j, jnp.asarray(x))
        rc_t = trace.race_update_batch(rc_t, params_t, torch.from_numpy(x))
    sw_t = tswakde.swakde_stream_batched(sw_t, params_t, torch.from_numpy(xs),
                                         cfg_t, chunk=40)
    assert_state_equal(sw_t, sw_j)
    assert_state_equal(rc_t, rc_j)

    q_j = jax.jit(jswakde.swakde_query_batch, static_argnums=(3,))
    rq_j = jax.jit(jrace.race_query_batch, static_argnums=(3,))
    for B in (10, 30):                                   # B < W and B >= W
        qs = xs[-B:]
        np.testing.assert_array_equal(
            tswakde.swakde_query_batch(sw_t, params_t, torch.from_numpy(qs), cfg_t).numpy(),
            np.asarray(q_j(sw_j, params_j, jnp.asarray(qs), cfg_j)))
        for mom in (0, 3):
            np.testing.assert_array_equal(
                trace.race_query_batch(rc_t, params_t, torch.from_numpy(qs), mom).numpy(),
                np.asarray(rq_j(rc_j, params_j, jnp.asarray(qs), mom)))


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_source_imports_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [PORT.parent.parent / "chip_smoke.py"]
    assert len(files) >= 56
    packages = {f.parent.name for f in files}
    assert {"core", "kernels", "configs", "models", "serve", "persist",
            "parallel", "checkpoint", "net"} <= packages
    names = {f"{f.parent.name}/{f.name}" for f in files}
    assert {"core/fleet.py", "serve/tenant_fleet.py", "serve/cluster.py",
            "parallel/sketch_sharding.py", "parallel/sharding.py",
            "net/protocol.py", "net/worker.py",
            "net/cluster.py"} <= names
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not offenders, offenders


def test_port_imports_without_jax_in_a_fresh_process():
    code = ("import sys, repro_torch, repro_torch.net; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_allocating_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only box")
    g = torch.Generator().manual_seed(0)
    cfg = tsann.SANNConfig(dim=4, n_max=100, eta=0.5, r=1.0, c=2.0, L=2, k=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsann.sann_init(cfg, g)
    with pytest.raises(RuntimeError, match="CUDA"):
        tswakde.swakde_init(tswakde.SWAKDEConfig(L=2, W=4, window=8, eh_eps=0.5))
    with pytest.raises(RuntimeError, match="CUDA"):
        trace.race_init(2, 4)
    from repro_torch.configs import registry
    from repro_torch.models import model
    from repro_torch.serve import kv_cache
    lm = registry.get_smoke_config("gemma3-4b")
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_model(lm, g)
    with pytest.raises(RuntimeError, match="CUDA"):
        kv_cache.init_cache(lm, 1, 512, sketch=True)
