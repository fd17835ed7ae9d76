"""The language-model layers, the sketch decode kernel's function and the
signature projection of the port against the reference, on the CPU.

Layers: float32 within 1e-6 relative (reductions and transcendental
functions round differently in XLA and in torch), bfloat16 within one ulp.
`sketch_decode_attn`: the port's CPU route and plain version against the
reference's Pallas kernel in interpret mode and its oracle, within the
reference's own 2e-5 (tests/test_kernels.py).  Live-block lists are equal.
Also the `prng.PRNGKey` device rule.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro.kernels import sketch_decode_attn as jsda
from repro.models import layers as jlayers
from repro.serve import serve_step as jserve
from repro_torch.core import prng
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sketch_decode_attn as tsda
from repro_torch.models import layers as tlayers
from repro_torch.serve import serve_step as tserve

from torch_parity import np_

_T = torch.from_numpy


def _bf16_ulps(a, b) -> int:
    """Largest distance in bfloat16 ulps between two bf16-valued arrays."""
    ia = np.asarray(a, np.float32).view(np.int32) >> 16
    ib = np.asarray(b, np.float32).view(np.int32) >> 16
    return int(np.abs(ia.astype(np.int64) - ib).max())


def _rel(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np_(got).astype(np.float32), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 3, 64)) * 3).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    f = jax.jit(jlayers.rms_norm)
    _rel(tlayers.rms_norm(_T(x), _T(w)), f(x, w), 1e-6)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    got = tlayers.rms_norm(_T(x).bfloat16(), _T(w).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got.float().numpy(), f(xb, wb).astype(jnp.float32)) <= 1


@pytest.mark.parametrize("dh,theta", [(16, 10_000.0), (256, 1_000_000.0)])
def test_rope_matches_reference_up_to_position_4096(dh, theta):
    """fp32 angles equal bit for bit (the frequencies are XLA's correctly
    rounded pow); cos and sin of angles up to ~4096 rad round differently in
    the two frameworks, so the rotated values agree within 1e-6 of the
    largest."""
    rng = np.random.default_rng(dh)
    x = rng.normal(size=(2, 7, 2, dh)).astype(np.float32)
    pos = np.array([[0, 1, 600, 1023, 2047, 4095, 4096],
                    [5, 17, 511, 512, 3000, 4000, 4096]], np.int32)
    want = jax.jit(jlayers.rope, static_argnums=2)(x, pos, theta)
    _rel(tlayers.rope(_T(x), _T(pos), theta), want, 1e-6)
    freq = theta ** (-jnp.arange(0, dh // 2, dtype=jnp.float32) / (dh // 2))
    np.testing.assert_array_equal(
        tlayers.rope_freq(dh // 2, theta, "cpu").numpy(),
        np.asarray(jax.jit(lambda: freq)()))
    # the decode form: one position for the whole batch
    one = jax.jit(jserve.rope_token, static_argnums=(1, 2))(x[:, :1], 4095, theta)
    _rel(tserve.rope_token(_T(x[:, :1]), 4095, theta), one, 1e-6)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(1)
    p = {"w_up": rng.normal(size=(32, 48)).astype(np.float32) / 6,
         "w_gate": rng.normal(size=(32, 48)).astype(np.float32) / 6,
         "w_down": rng.normal(size=(48, 32)).astype(np.float32) / 7}
    x = rng.normal(size=(3, 1, 32)).astype(np.float32)
    jact = jax.nn.gelu if act == "gelu" else jax.nn.silu
    tact = tlayers.gelu_tanh if act == "gelu" else F.silu
    want = jax.jit(lambda p, x: jlayers.mlp(p, x, act=jact))(p, x)
    got = tlayers.mlp({k: _T(v) for k, v in p.items()}, _T(x), act=tact)
    _rel(got, want, 1e-6)


@pytest.mark.parametrize("tie,softcap", [(False, 0.0), (True, 30.0)])
def test_embed_unembed_and_scaled_embedding_match_reference(tie, softcap):
    rng = np.random.default_rng(2)
    V, d = 50, 40
    p = {"embed": (rng.normal(size=(V, d)) * 0.5).astype(np.float32)}
    if not tie:
        p["unembed"] = rng.normal(size=(d, V)).astype(np.float32)
    tp = {k: _T(v) for k, v in p.items()}
    tok = rng.integers(0, V, size=(3, 1))
    np.testing.assert_array_equal(np_(tlayers.embed(tp, _T(tok))),
                                  np.asarray(jlayers.embed(p, tok)))
    x = rng.normal(size=(3, 1, d)).astype(np.float32) * 4
    want = jax.jit(lambda p, x: jlayers.unembed(p, x, softcap=softcap))(p, x)
    _rel(tlayers.unembed(tp, _T(x), softcap), want, 1e-6)
    # serve_step's sqrt(d_model) scale is rounded to bf16 first (50.5 at 2560)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = xb * jnp.asarray(math.sqrt(2560), xb.dtype)
    got = _T(x).bfloat16() * float(torch.tensor(math.sqrt(2560), dtype=torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _attn_inputs(seed, Hkv, G, dh, S, bs, frac_live, B=None):
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    q = rng.normal(size=lead + (Hkv, G, dh)).astype(np.float32)
    k = rng.normal(size=lead + (S, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=lead + (S, Hkv, dh)).astype(np.float32)
    nb = S // bs
    live = rng.random(size=lead + (nb,)) < frac_live
    ids = np.full(lead + (nb,), -1, np.int32)
    n_live = np.zeros(lead + (1,) if B is None else (B,), np.int32)
    for idx in np.ndindex(*lead):
        lv = np.nonzero(live[idx])[0]
        ids[idx][: len(lv)] = lv
        n_live[idx] = len(lv)
    return q, k, v, live, ids, n_live


@pytest.mark.parametrize("case", [
    dict(seed=0, Hkv=2, G=4, dh=64, S=1024, bs=128, softcap=20.0,
         frac_live=0.5, kv_len=900),
    dict(seed=2, Hkv=1, G=2, dh=32, S=256, bs=64, softcap=0.0,
         frac_live=0.0, kv_len=256),
], ids=["softcap20_half_live", "no_live_block"])
def test_sketch_decode_attn_matches_reference_pallas_interpret(case):
    c = dict(case)
    kv_len, softcap, bs = c.pop("kv_len"), c.pop("softcap"), c["bs"]
    q, k, v, live, ids, n_live = _attn_inputs(**c)
    pallas = np.asarray(jsda.sketch_decode_attn(
        q, k, v, ids, n_live, np.array([kv_len], np.int32), block_size=bs,
        softcap=softcap, interpret=True))
    got = tops.sketch_decode_attn(_T(q), _T(k), _T(v), _T(ids), _T(n_live),
                                  kv_len, bs, softcap)
    plain = tref.sketch_decode_attn_ref(_T(q), _T(k), _T(v), _T(live), kv_len,
                                        bs, softcap)
    for out in (got, plain):
        assert out.dtype == torch.float32 and out.shape == q.shape
        np.testing.assert_allclose(out.numpy(), pallas, rtol=2e-5, atol=2e-5)
    if not live.any():
        assert not got.any()


_jref_attn = jax.jit(jref.sketch_decode_attn_ref, static_argnums=(5, 6))


@pytest.mark.parametrize("case", [
    dict(seed=1, Hkv=1, G=8, dh=32, S=512, bs=64, softcap=0.0,
         frac_live=1.0, kv_len=100),
    dict(seed=3, Hkv=2, G=2, dh=16, S=512, bs=128, softcap=50.0,
         frac_live=0.6, kv_len=450),
    dict(seed=4, Hkv=2, G=4, dh=64, S=1024, bs=128, softcap=0.0,
         frac_live=1.0, kv_len=1024),
], ids=["partial_kv_len", "softcap50", "all_live"])
def test_sketch_decode_attn_matches_reference_oracle(case):
    c = dict(case)
    kv_len, softcap, bs = c.pop("kv_len"), c.pop("softcap"), c["bs"]
    q, k, v, live, ids, n_live = _attn_inputs(**c)
    want = np.asarray(_jref_attn(q, k, v, live, np.int32(kv_len), bs, softcap))
    got = tops.sketch_decode_attn(_T(q), _T(k), _T(v), _T(ids), _T(n_live),
                                  kv_len, bs, softcap)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_sketch_decode_attn_batched_equals_per_request_loop():
    q, k, v, _, ids, n_live = _attn_inputs(5, 2, 2, 16, 512, 64, 0.5, B=3)
    ids[1], n_live[1] = -1, 0                     # one request with no block
    got = tops.sketch_decode_attn(_T(q), _T(k), _T(v), _T(ids), _T(n_live),
                                  400, 64, 20.0)
    for b in range(3):
        one = tops.sketch_decode_attn(_T(q[b]), _T(k[b]), _T(v[b]), _T(ids[b]),
                                      _T(n_live[b:b + 1]), 400, 64, 20.0)
        np.testing.assert_array_equal(got[b].numpy(), one.numpy())
    assert not got[1].any()


def test_live_blocks_from_sketch_matches_reference():
    # tests/test_kernels.py's compaction case
    sigs = np.asarray([[1, 0, 0], [1, 1, 0], [0, 0, 1], [1, 1, 1]], bool)
    qsig = np.asarray([1, 1, 0], bool)
    rng = np.random.default_rng(6)
    cases = [(qsig, sigs, 4 * 16, 16, 2)]
    for kv_len in (0, 1, 700, 2048):
        cases.append((rng.random(64) < 0.5, rng.random((8, 64)) < 0.4, kv_len,
                      256, 16))
    for q_sig, block_sigs, kv_len, bs, mm in cases:
        ids_j, n_j = jsda.live_blocks_from_sketch(
            jnp.asarray(q_sig), jnp.asarray(block_sigs), jnp.int32(kv_len), bs, mm)
        ids_t, n_t = tsda.live_blocks_from_sketch(_T(q_sig), _T(block_sigs),
                                                  kv_len, bs, mm)
        assert ids_t.dtype == torch.int32 and n_t.dtype == torch.int32
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))


def test_signature_projection_and_bits_match_reference():
    """`_sig_proj` is jax.random.normal(PRNGKey(42)) within 4 ulp (XLA's
    log1p rounds differently); signatures agree wherever the projection
    is not within 1e-5 of the sign boundary."""
    for dh in (16, 256):
        want = np.asarray(jserve._sig_proj(dh))
        got = tserve._sig_proj(dh).numpy()
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
        assert ulps.max() <= 4, (dh, ulps.max())
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 1, 8, 256)).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = _T(x).to(dt)
        xj = jnp.asarray(x, jdt)
        mean_t = tserve._head_mean(xt)
        mean_j = xj.mean(axis=2)
        np.testing.assert_array_equal(mean_t.float().numpy(),
                                      np.asarray(mean_j.astype(jnp.float32)))
        bits_t = tserve._sig_bits(mean_t[:, 0], tserve._sig_proj(256)).numpy()
        bits_j = np.asarray(jserve._sig_bits(mean_j[:, 0], jserve._sig_proj(256)))
        flips, unexplained = tserve.sig_flips(mean_t[:, 0], tserve._sig_proj(256),
                                              _T(bits_t), torch.tensor(bits_j))
        assert unexplained == 0 and flips == int((bits_t != bits_j).sum())


def test_prngkey_defaults_to_the_card():
    np.testing.assert_array_equal(prng.PRNGKey(0, device="cpu").numpy(),
                                  np.asarray(jax.random.PRNGKey(0)).astype(np.int64))
    if torch.cuda.is_available():
        assert prng.PRNGKey(0).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            prng.PRNGKey(0)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (300, 50.0)])
def test_decode_attention_with_sketch_mask_matches_reference(window, softcap):
    """The plain decode attention under the reference's sketch block mask
    (the port's global layers run the kernel instead; local layers and
    sketch-off layers run this)."""
    rng = np.random.default_rng(window + 8)
    B, H, Hkv, dh, S, length = 2, 4, 2, 16, 1024, 700
    q = rng.normal(size=(B, 1, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    sigs = rng.random((B, S // 512, 64)) < 0.3
    mask_j = jax.jit(jserve.sketch_block_mask, static_argnums=2)(q, sigs, length)
    mask_t = tserve.sketch_block_mask(_T(q), _T(sigs), length)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    want = jax.jit(lambda q, k, v, m: jserve.decode_attention(
        q, k, v, length, window=window, softcap=softcap, extra_mask=m))(q, k, v, mask_j)
    got = tserve.decode_attention(_T(q), _T(k), _T(v), length, window=window,
                                  softcap=softcap, extra_mask=mask_t)
    _rel(got, want, 1e-6)
