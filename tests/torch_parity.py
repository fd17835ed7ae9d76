"""Helpers shared by the parity tests of the PyTorch port (tests/test_torch_*.py).

Reference objects cross to the port as dicts of numpy arrays
(`repro_torch.convert`); the comparisons here state the tolerances once.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import lsh as jlsh

# batch_score_topk: fp32 sums in another order than the reference's.
RTOL, ATOL = 1e-5, 1e-6


def _mix(rng, L, k):
    """Odd uint32 multipliers, as the reference's init draws them."""
    return ((rng.integers(1, 2**31 - 1, size=(L, k)).astype(np.uint32) << 1)
            | np.uint32(1))


def ref_srp(seed, dim, L, k, n_buckets):
    """Reference SRP params drawn with numpy (no JAX random compile)."""
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(dim, L * k)).astype(np.float32)
    return jlsh.SRPParams(proj=jnp.asarray(proj), mix=jnp.asarray(_mix(rng, L, k)),
                          L=L, k=k, n_buckets=n_buckets)


def ref_pstable(seed, dim, L, k, w, n_buckets):
    """Reference p-stable params drawn with numpy."""
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(dim, L * k)).astype(np.float32)
    bias = rng.uniform(0.0, w, size=L * k).astype(np.float32)
    return jlsh.PStableParams(proj=jnp.asarray(proj), bias=jnp.asarray(bias),
                              mix=jnp.asarray(_mix(rng, L, k)), w=w, L=L, k=k,
                              n_buckets=n_buckets)


def fields(obj) -> dict:
    """A reference params dataclass or state NamedTuple → dict of numpy
    arrays (static fields stay Python scalars)."""
    if hasattr(obj, "_asdict"):
        items = obj._asdict().items()
    else:
        items = ((f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in items}


def np_(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_state_equal(port_state, ref_state, names=None):
    """Every (or each named) leaf bit-identical, dtype included."""
    names = names or port_state._fields
    for name in names:
        a, b = np_(getattr(port_state, name)), np_(getattr(ref_state, name))
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


def assert_topk_match(d2_p, idx_p, d2_r, idx_r, exact_d2):
    """Top-k outputs agree: d2 within (RTOL, ATOL); ids equal except at a
    detected near-tie, where the two candidates' exact distances
    (``exact_d2 (B, M)``, float64, inf where masked) differ by less than the
    tolerance."""
    d2_p, idx_p, d2_r, idx_r = map(np_, (d2_p, idx_p, d2_r, idx_r))
    np.testing.assert_allclose(d2_p, d2_r, rtol=RTOL, atol=ATOL)
    rows, cols = np.nonzero(idx_p != idx_r)
    for b, j in zip(rows, cols):
        dp, dr = exact_d2[b, idx_p[b, j]], exact_d2[b, idx_r[b, j]]
        tie = (dp == dr) or abs(dp - dr) <= ATOL + RTOL * abs(dr)
        assert tie, f"id mismatch at ({b}, {j}) without a near-tie: {dp} vs {dr}"
