"""Parity of the port's LSH (repro_torch.core.lsh) with repro.core.lsh.

The uint32 fold is bit-exact.  SRP codes may differ only where the float64
projection lies within 1e-4 of the sign boundary: the two frameworks sum
the fp32 matmul in different orders.  A p-stable code may differ only
where the two fp32 products ``x @ proj`` themselves differ; where they are
equal the code is equal, because both packages then multiply by the same
fp32 reciprocal of ``w`` (the jitted reference's rewrite of ``/ w``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro_torch import convert
from repro_torch.core import lsh as tlsh
from repro_torch.kernels import ref as kref

from torch_parity import fields, ref_pstable, ref_srp

BOUNDARY = 1e-4


@pytest.mark.parametrize("family", ["srp", "pstable"])
def test_hash_codes_match_reference(family):
    rng = np.random.default_rng(0)
    dim, L, k, nb = 16, 6, 3, 97
    xs = rng.normal(size=(400, dim)).astype(np.float32)
    if family == "srp":
        pj = ref_srp(1, dim, L, k, nb)
    else:
        pj = ref_pstable(1, dim, L, k, 2.7, nb)
    pt = convert.params_from_numpy(fields(pj), device="cpu")
    codes_r = np.asarray(jax.jit(jlsh.hash_points)(pj, jnp.asarray(xs)))
    codes_p = tlsh.hash_points(pt, torch.from_numpy(xs)).numpy()
    assert codes_p.dtype == np.int32 and codes_p.shape == (400, L)

    if family == "srp":
        y = xs.astype(np.float64) @ np.asarray(pj.proj, np.float64)
        allowed = (np.abs(y) < BOUNDARY).reshape(400, L, k).any(-1)
    else:
        prod_r = np.asarray(jax.jit(jnp.matmul)(jnp.asarray(xs), pj.proj))
        prod_p = (torch.from_numpy(xs) @ pt.proj).numpy()
        allowed = (prod_r != prod_p).reshape(400, L, k).any(-1)
    bad = (codes_p != codes_r) & ~allowed
    assert not bad.any(), np.argwhere(bad)
    assert (codes_p == codes_r).mean() > 0.99


def _division_boundaries(w, n=200):
    """fp32 values v near multiples of w where ``floor(v / w)`` (IEEE
    division) and ``floor(v * (1/w))`` (fp32 reciprocal) differ."""
    w32 = np.float32(w)
    recip = np.float32(1) / w32
    out = []
    for m in range(-400, 400):
        v = np.float32(m * w32)
        for step in (-1, 1):
            u = v
            for _ in range(3):
                u = np.nextafter(u, np.float32(step * np.inf))
                if np.floor(u / w32) != np.floor(u * recip):
                    out.append(u)
    assert len(out) >= n
    return np.array(out[:n], np.float32)


@pytest.mark.parametrize("w", [9.612, 3.0, 1.6])
def test_pstable_codes_equal_reference_when_the_product_is_exact(w):
    """One-hot inputs make ``x @ proj`` exact in both frameworks, and the
    projections are set to values where a true division by w and the
    multiply by its fp32 reciprocal floor differently: every code must equal
    the jitted reference's (which multiplies), and so must every floor."""
    dim, L, k, nb = 8, 4, 3, 1009
    pj = ref_pstable(8, dim, L, k, w, nb)
    vals = _division_boundaries(w, n=dim * L * k)
    pj = dataclasses.replace(pj, proj=jnp.asarray(vals.reshape(dim, L * k)),
                             bias=jnp.zeros(L * k, jnp.float32))
    pt = convert.params_from_numpy(fields(pj), device="cpu")
    xs = np.eye(dim, dtype=np.float32)
    codes_r = np.asarray(jax.jit(jlsh.hash_points)(pj, jnp.asarray(xs)))
    codes_p = tlsh.hash_points(pt, torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(codes_p, codes_r)
    y_r = np.asarray(jax.jit(lambda x: jnp.floor(
        (x @ pj.proj + pj.bias) / pj.w))(jnp.asarray(xs)))
    y_p = torch.floor((torch.from_numpy(xs) @ pt.proj + pt.bias)
                      * tlsh.fp32_reciprocal(w)).numpy()
    np.testing.assert_array_equal(y_p, y_r)
    true_div = np.floor(vals / np.float32(w)).reshape(dim, L * k)
    assert (true_div != y_r).all()          # the inputs do separate the two


def test_fold_bit_exact_near_2_pow_32():
    """Injected raw hashes near 2^32 (and negative int32s, read as uint32)
    fold bit-exactly: the int64 port masks after every multiply and sum."""
    rng = np.random.default_rng(2)
    L, k, nb = 5, 4, 253_580
    raw = np.concatenate([
        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32 - 2, 2**32 - 2**16,
                  2**16 - 1, 2**16, 2**31 + 2**16 - 1, 12345, 2**32 - 3],
                 dtype=np.uint64),
        rng.integers(2**32 - 2**20, 2**32, size=88, dtype=np.uint64),
        rng.integers(0, 2**32, size=100, dtype=np.uint64),
    ]).astype(np.uint32).reshape(-1, L, k)
    mix = ((rng.integers(1, 2**31 - 1, size=(L, k)).astype(np.uint32) << 1)
           | 1).astype(np.uint32)
    mix[0, 0] = 2**32 - 1
    fold_j = jax.jit(jlsh._fold, static_argnums=(2,))
    ref = np.asarray(fold_j(jnp.asarray(raw), jnp.asarray(mix), nb))
    got = kref.fold(torch.from_numpy(raw.astype(np.int64)),
                    torch.from_numpy(mix.astype(np.int64)), nb).numpy()
    np.testing.assert_array_equal(got, ref)
    # negative int32 hashes (floor of negative projections)
    neg = rng.integers(-2**31, 0, size=(40, L, k)).astype(np.int32)
    ref = np.asarray(fold_j(jnp.asarray(neg), jnp.asarray(mix), nb))
    got = kref.fold(torch.from_numpy(neg), torch.from_numpy(
        mix.astype(np.int64)), nb).numpy()
    np.testing.assert_array_equal(got, ref)


def test_mul32_matches_uint64_arithmetic():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, size=1000, dtype=np.uint64)
    b = rng.integers(0, 2**32, size=1000, dtype=np.uint64)
    want = (a * b) & np.uint64(0xFFFFFFFF)          # uint64 wraps mod 2^64
    got = kref.mul32(torch.from_numpy(a.astype(np.int64)),
                     torch.from_numpy(b.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_collision_probabilities_match_reference():
    rng = np.random.default_rng(4)
    dist = np.concatenate([[0.0], rng.uniform(0.01, 10.0, size=50)]).astype(np.float32)
    pstable_j = jax.jit(jlsh.pstable_collision_prob, static_argnums=(1, 2))
    for w, p in ((4.0, 1), (2.0, 2)):
        ref = np.asarray(pstable_j(jnp.asarray(dist), w, p))
        got = tlsh.pstable_collision_prob(torch.from_numpy(dist), w, p).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    x = rng.normal(size=(30, 8)).astype(np.float32)
    y = rng.normal(size=(30, 8)).astype(np.float32)
    ref = np.asarray(jax.jit(jlsh.srp_collision_prob, static_argnums=(2,))(
        jnp.asarray(x), jnp.asarray(y), 2))
    got = tlsh.srp_collision_prob(torch.from_numpy(x), torch.from_numpy(y), 2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_init_draws_params_of_the_reference_shapes():
    g = torch.Generator().manual_seed(0)
    p = tlsh.init_pstable(g, 8, 5, 3, 2.0, 101, device="cpu")
    assert p.proj.shape == (8, 15) and p.bias.shape == (15,)
    assert ((p.bias >= 0) & (p.bias < 2.0)).all()
    assert p.mix.dtype == torch.int64 and (p.mix % 2 == 1).all()
    assert ((p.mix > 0) & (p.mix < 2**32)).all()
    s = tlsh.init_srp(g, 8, 5, 3, 101, device="cpu")
    codes = tlsh.hash_points(s, torch.randn(10, 8, generator=g))
    assert codes.dtype == torch.int32 and ((codes >= 0) & (codes < 101)).all()
