"""The port's training mixers of the recurrent and latent-attention families
against the reference's, on the CPU, float32: Mamba2's full-sequence
``mamba2`` (the causal conv and the chunked SSD) and MLA's
``mla_attention``, forward and gradient.

Tolerances.  ``mla_attention``: its output and latent pair within 1e-5 of
their largest value, gradients within 5e-5 (fp32 sums in another order, as
``tests/test_torch_model.py`` holds the dense attention).  ``mamba2``: the
final SSD state is float32 arithmetic end to end (a chunk's contribution
``B_j (dt_j x_j)^T`` and the decays), held to 1e-5 of its largest; the
conv tail is a slice of the input projection, 1e-6.  The output carries
the intra-chunk term, whose decay-weighted scores are rounded to bfloat16
and contracted with bfloat16 ``x * dt`` in both packages (the reference's
precision): where the two packages' float32 scores differ in their last
bit, a score rounds to the neighbouring bfloat16 value, one bfloat16 ulp
(2^-8 of itself) away.  So the output and every gradient are held to
``BF16_TOL`` = 2^-8 of their largest value, one bfloat16 ulp (seen: 3.8e-7
on the output, 1.7e-6 on the gradients: no score rounded apart here).
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import registry as jregistry
from repro.models import mla as jmla
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.models import mla as tmla
from repro_torch.models import ssm as tssm

from torch_parity import assert_rel, fast_jit, flat, lm_tree_np

_T = torch.from_numpy
BF16_TOL = 2.0 ** -8


def _cfg(arch):
    return dataclasses.replace(jregistry.get_smoke_config(arch),
                               param_dtype="float32")


def _layer(tree, *idx):
    for i in idx:
        tree = {k: _layer(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return tree


def _port_grads(fn, params, x, r):
    """``fn``'s outputs and the gradients of ``sum(out * r)`` with respect
    to ``params`` (a tree) and ``x``."""
    leaves = convert.train_params_from_numpy(params, "cpu")
    flat_leaves = [t.requires_grad_() for t in jax.tree.leaves(
        leaves, is_leaf=lambda t: isinstance(t, torch.Tensor))]
    xt = _T(x).requires_grad_()
    outs = fn(leaves, xt)
    (outs[0] * _T(r)).sum().backward()
    grads = jax.tree.unflatten(jax.tree.structure(params),
                               [t.grad for t in flat_leaves])
    return outs, grads, xt.grad


def test_mamba2_matches_reference():
    """Zamba2's smoke widths (4 heads of 16, state 8, conv 4) at S = 40:
    the chunk 16 shrinks to 10, four chunks.  Then the port's final state
    and conv tail equal what its own single-token decode reaches from a
    zero state over the same 40 tokens (the decode's state is float32
    throughout: 1e-5)."""
    cfg = _cfg("zamba2-2.7b")
    p = _layer(lm_tree_np(cfg, 0)["mamba_blocks"], 0, 1)["mixer"]
    kw = dict(state=cfg.ssm_state, conv=cfg.ssm_conv, expand=cfg.ssm_expand,
              head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk,
              norm_eps=cfg.norm_eps)
    B, S = 2, 40
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    r = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)

    def jf(p, x, r):
        def loss(p, x):
            out, c = jssm.mamba2(p, x, **kw)
            return (out * r).sum(), (out, c.state, c.conv_buf)
        (_, outs), g = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(p, x)
        return outs, g

    (out_j, st_j, cb_j), (gp_j, gx_j) = fast_jit(jf)(p, x, r)
    (out_t, cache), gp_t, gx_t = _port_grads(
        lambda pt, xt: tssm.mamba2(pt, xt, **kw), p, x, r)
    assert_rel(out_t, out_j, BF16_TOL)
    assert_rel(cache.state, st_j, 1e-5)
    assert_rel(cache.conv_buf, cb_j, 1e-6)
    assert cache.conv_buf.shape == (B, cfg.ssm_conv - 1,
                                    2 * cfg.d_model + 2 * cfg.ssm_state)
    want, got = flat(jax.tree.map(np.asarray, gp_j)), flat(gp_t)
    assert got.keys() == want.keys()
    for name in want:
        assert_rel(got[name], want[name], BF16_TOL)
    assert_rel(gx_t, gx_j, BF16_TOL)

    # the prompt's state against the port's decode, token by token
    pt = convert.train_params_from_numpy(p, "cpu")
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    step = tssm.SSMCache(
        torch.zeros(B, H, cfg.ssm_state, cfg.ssm_head_dim),
        torch.zeros(B, cfg.ssm_conv - 1, cache.conv_buf.shape[-1]))
    dkw = {k: kw[k] for k in ("state", "expand", "head_dim", "norm_eps")}
    with torch.no_grad():
        for t in range(S):
            _, step = tssm.mamba2_decode_step(pt, _T(x[:, t:t + 1]), step, **dkw)
    assert_rel(cache.state, step.state.numpy(), 1e-5)
    assert_rel(cache.conv_buf, step.conv_buf.numpy(), 1e-6)


def test_mla_attention_matches_reference():
    """deepseek-v3's smoke widths (4 heads, dh 16, rope 8, latents 32 and
    48) at S = 24: the flash attention with dqk = 24 and dv = 16."""
    cfg = _cfg("deepseek-v3-671b")
    p = _layer(lm_tree_np(cfg, 2)["moe_blocks"], 1)["attn"]
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.resolved_head_dim,
              rope_dim=cfg.mla_rope_dim, rope_theta=cfg.rope_theta,
              norm_eps=cfg.norm_eps)
    B, S = 2, 24
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    r = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))

    def jf(p, x, r):
        def loss(p, x):
            out, cc = jmla.mla_attention(p, x, pos, **kw)
            return (out * r).sum(), (out, cc)
        (_, outs), g = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(p, x)
        return outs, g

    (out_j, (c_j, kr_j)), (gp_j, gx_j) = fast_jit(jf)(p, x, r)
    (out_t, (c_t, kr_t)), gp_t, gx_t = _port_grads(
        lambda pt, xt: tmla.mla_attention(pt, xt, _T(pos.copy()), **kw),
        p, x, r)
    assert out_t.shape == (B, S, cfg.d_model)
    assert_rel(out_t, out_j, 1e-5)
    assert_rel(c_t, c_j, 1e-5)
    assert_rel(kr_t, kr_j, 1e-5)
    want, got = flat(jax.tree.map(np.asarray, gp_j)), flat(gp_t)
    assert got.keys() == want.keys()
    for name in want:
        assert_rel(got[name], want[name], 5e-5)
    assert_rel(gx_t, gx_j, 5e-5)
