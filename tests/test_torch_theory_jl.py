"""The paper's formulas (repro_torch.core.theory) and the JL baseline
(repro_torch.core.jl) against the reference on the CPU.

The formulas are the same host-side float64 arithmetic and must be equal.
JL projections are fp32 matmuls summed in another order in each framework,
so the stored points and distances agree within (1e-5, 1e-6); the map
itself is carried across from the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import jl as jjl
from repro.core import theory as jtheory
from repro_torch import convert
from repro_torch.core import jl as tjl
from repro_torch.core import theory as ttheory

from torch_parity import RTOL, ATOL, np_


def test_theory_formulas_equal_reference():
    cases = {
        "pstable_p": [(0.0, 4.0), (1.5, 4.0), (9.0, 2.0)],
        "srp_p": [(0.0,), (1.0,), (3.0,)],
        "rho": [(0.8, 0.3), (0.5, 0.1)],
        "choose_k": [(1000, 0.3), (10**6, 0.55)],
        "choose_L": [(1000, 0.8, 0.3), (10**6, 0.6, 0.2)],
        "sann_space_words": [(10**6, 0.3, 0.8, 0.3)],
        "sann_failure_prob": [(10**6, 0.3, 50.0), (1000, 0.5, 3.0)],
        "turnstile_failure_prob": [(10**6, 0.3, 500.0, 0), (10**6, 0.3, 500.0, 3),
                                   (1000, 0.5, 3.0, 5)],
        "poisson_tail_le": [(0, 3.0), (2, 7.5)],
        "swakde_rows": [(10.0, 2.0, 0.1, 0.05)],
        "eh_eps_for_kde_eps": [(0.21,), (0.5,)],
        "swakde_space_bound": [(96, 96, 0.21, 65_536)],
    }
    for name, args_list in cases.items():
        for args in args_list:
            assert getattr(ttheory, name)(*args) == getattr(jtheory, name)(*args), \
                (name, args)


def test_jl_baseline_matches_reference():
    cfg_j = jjl.JLConfig(dim=16, k=6, capacity=40)
    cfg_t = tjl.JLConfig(**dataclasses.asdict(cfg_j))
    st_j = jjl.jl_init(cfg_j, jax.random.PRNGKey(0))
    st_t = convert.jl_state_from_numpy(
        {f: np.asarray(v) for f, v in st_j._asdict().items()}, device="cpu")
    xs = np.random.default_rng(1).normal(size=(50, 16)).astype(np.float32)
    st_j = jax.jit(jjl.jl_insert_stream, static_argnums=(2,))(
        st_j, jnp.asarray(xs), cfg_j)
    st_t = tjl.jl_insert_stream(st_t, torch.from_numpy(xs), cfg_t)
    assert int(st_t.n) == int(st_j.n) == 50                 # the ring wrapped
    np.testing.assert_allclose(st_t.store.numpy(), np.asarray(st_j.store),
                               rtol=RTOL, atol=ATOL)
    qs = (xs[-8:] + 0.01).astype(np.float32)
    idx_j, d_j = jax.jit(jjl.jl_query_batch, static_argnums=(2, 3))(
        st_j, jnp.asarray(qs), cfg_j, 3)
    idx_t, d_t = tjl.jl_query_batch(st_t, torch.from_numpy(qs), cfg_t, 3)
    np.testing.assert_array_equal(np_(idx_t), np.asarray(idx_j))
    np.testing.assert_allclose(np_(d_t), np.asarray(d_j), rtol=RTOL, atol=ATOL)
    assert tjl.jl_bytes(cfg_t) == jjl.jl_bytes(cfg_j)
    # a fresh map from the port's own generator has the reference's scale
    g = torch.Generator().manual_seed(0)
    fresh = tjl.jl_init(tjl.JLConfig(dim=64, k=400, capacity=4), g, device="cpu")
    assert abs(float(fresh.proj.std()) - 400 ** -0.5) < 0.1 * 400 ** -0.5
    empty_idx, empty_d = tjl.jl_query(fresh, torch.ones(64), fresh_cfg := tjl.JLConfig(64, 400, 4), 2)
    assert torch.isinf(empty_d).all() and empty_idx.tolist() == [0, 1]
    assert fresh_cfg.capacity == 4
