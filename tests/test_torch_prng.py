"""The port's threefry keys (repro_torch.core.prng) against jax.random, and
the S-ANN keep decisions drawn from them against the reference's.

Everything here is integer arithmetic and must be bit-exact.  The recipe
reproduces JAX's *partitionable* threefry, the mode the installed JAX runs
in; the first test pins that mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sann as jsann
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.core import sann as tsann

from torch_parity import fields, ref_pstable

SEEDS = (0, 7, 2**31 - 1, 2**32 - 1)


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def test_jax_threefry_is_partitionable():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_match_jax(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed, device="cpu")
    np.testing.assert_array_equal(kt.numpy(), _u32(kj))
    for i in (0, 1, 5, 1000, 2**31 + 3):
        np.testing.assert_array_equal(prng.fold_in(kt, i).numpy(),
                                      _u32(jax.random.fold_in(kj, i)))
    np.testing.assert_array_equal(prng.split(kt, 9).numpy(),
                                  _u32(jax.random.split(kj, 9)))
    # a batch of keys folds in a batch of counters
    keys = jax.random.split(kj, 4)
    got = prng.fold_in(convert.key_from_numpy(np.asarray(keys), "cpu"),
                       torch.arange(4))
    want = jax.vmap(jax.random.fold_in)(keys, jnp.arange(4, dtype=jnp.uint32))
    np.testing.assert_array_equal(got.numpy(), _u32(want))
    assert np.array_equal(convert.key_to_numpy(kt), np.asarray(kj))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_bits_and_bernoulli_match_jax(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), 400)
    kt = convert.key_from_numpy(np.asarray(keys), "cpu")
    bits = jax.jit(jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32)))(keys)
    np.testing.assert_array_equal(prng.bits32(kt).numpy(), _u32(bits))
    for p in (0.3, 0.0158, 0.5, 1e-7):
        want = jax.jit(jax.vmap(lambda k: jax.random.bernoulli(k, p)))(keys)
        np.testing.assert_array_equal(prng.bernoulli(kt, p).numpy(),
                                      np.asarray(want))
    assert bool(prng.bernoulli(kt[0], 0.5)) == \
        bool(jax.random.bernoulli(keys[0], 0.5))


def test_prngkey_rejects_seeds_outside_32_bits():
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)
    with pytest.raises(ValueError):
        prng.PRNGKey(2**32)


def test_prepare_chunk_keep_matches_reference_without_injection():
    """The port draws its own keep mask from the key: equal to the
    reference's, and prefix-stable (a shorter chunk keeps a prefix)."""
    cfg_j = jsann.SANNConfig(dim=4, n_max=400, eta=0.3, r=1.0, c=1.5, L=2,
                             k=2, bucket_cap=4).resolved()
    cfg_t = tsann.SANNConfig(dim=4, n_max=400, eta=0.3, r=1.0, c=1.5, L=2,
                             k=2, bucket_cap=4).resolved()
    params_j = ref_pstable(0, 4, cfg_j.L, cfg_j.k, cfg_j.w, cfg_j.n_buckets)
    params_t = convert.params_from_numpy(fields(params_j), device="cpu")
    xs = np.random.default_rng(0).normal(size=(300, 4)).astype(np.float32)
    prep = jax.jit(jsann.sann_prepare_chunk, static_argnums=(3,))
    for seed in (1, 9):
        pj = prep(params_j, jnp.asarray(xs), jax.random.PRNGKey(seed), cfg_j)
        pt = tsann.sann_prepare_chunk(params_t, torch.from_numpy(xs),
                                      prng.PRNGKey(seed, device="cpu"), cfg_t)
        np.testing.assert_array_equal(pt.keep.numpy(), np.asarray(pj.keep))
        np.testing.assert_array_equal(pt.kept_rank.numpy(),
                                      np.asarray(pj.kept_rank))
        assert 0 < int(pt.n_kept) < 300
        short = tsann.sann_prepare_chunk(params_t, torch.from_numpy(xs[:77]),
                                         prng.PRNGKey(seed, device="cpu"), cfg_t)
        assert torch.equal(short.keep, pt.keep[:77])
