"""The port's recurrent mixers against the reference's, on the CPU, float32.

Mamba2's single-token decode (``mamba2_decode_step``) over 16 steps from a
zero state: the output, the SSD ``state`` and the conv tail ``conv_buf``
after every step within 1e-5 of their largest value (fp32 sums in another
order, growing through the recurrence).  The xLSTM mixers (``mlstm``,
``slstm``) over S = 16 from their initial state, whose stabiliser ``m`` is
-inf, then continued from the returned state over 16 more: outputs and
every state leaf within 1e-5, no value NaN, and the ``-inf`` start taken
without an -inf operand (the first step's stabiliser is its input gate).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch import convert
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm

from torch_parity import assert_rel, fast_jit, lm_tree_np

_T = torch.from_numpy
TOL = 1e-5


def _cfg(arch):
    return dataclasses.replace(jregistry.get_smoke_config(arch),
                               param_dtype="float32")


def _layer(tree, *idx):
    for i in idx:
        tree = {k: _layer(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return tree


def test_mamba2_decode_step_matches_reference():
    cfg = _cfg("zamba2-2.7b")
    p = _layer(lm_tree_np(cfg, 0)["mamba_blocks"], 1, 0)["mixer"]
    kw = dict(state=cfg.ssm_state, expand=cfg.ssm_expand,
              head_dim=cfg.ssm_head_dim, norm_eps=cfg.norm_eps)
    B, steps = 2, 16
    d_in = cfg.ssm_expand * cfg.d_model
    H, C = d_in // cfg.ssm_head_dim, d_in + 2 * cfg.ssm_state
    step_j = fast_jit(lambda p, x, st, cb: jssm.mamba2_decode_step(
        p, x, jssm.SSMCache(st, cb), **kw))
    st = np.zeros((B, H, cfg.ssm_state, cfg.ssm_head_dim), np.float32)
    cb = np.zeros((B, cfg.ssm_conv - 1, C), np.float32)
    cache_j = (st, cb)
    cache_t = tssm.SSMCache(_T(st), _T(cb))
    pt = convert.train_params_from_numpy(p, "cpu")
    xs = np.random.default_rng(1).normal(size=(steps, B, 1, cfg.d_model))
    for x in xs.astype(np.float32):
        y_j, cache_j = step_j(p, x, *cache_j)
        y_t, cache_t = tssm.mamba2_decode_step(pt, _T(x), cache_t, **kw)
        assert_rel(y_t, np.asarray(y_j), TOL)
        assert_rel(cache_t.state, np.asarray(cache_j.state), TOL)
        assert_rel(cache_t.conv_buf, np.asarray(cache_j.conv_buf), TOL)
    assert float(np.abs(np.asarray(cache_j.state)).max()) > 1e-2  # not trivial


@pytest.mark.filterwarnings("ignore:Anomaly Detection has been enabled")
def test_mlstm_slstm_match_reference_from_the_inf_state_and_continued():
    cfg = _cfg("xlstm-125m")
    tree = lm_tree_np(cfg, 2)
    pm = _layer(tree["mlstm_blocks"], 1)["mixer"]
    ps = _layer(tree["slstm_blocks"], 1)["mixer"]
    H, eps = cfg.n_heads, cfg.norm_eps
    B, S = 2, 16
    xs = np.random.default_rng(3).normal(size=(2, B, S, cfg.d_model))
    xs = xs.astype(np.float32)
    m_j = fast_jit(lambda p, x, st: jxlstm.mlstm(p, x, n_heads=H, norm_eps=eps,
                                                state=st))
    s_j = fast_jit(lambda p, x, st: jxlstm.slstm(p, x, n_heads=H, norm_eps=eps,
                                                state=st))
    P = 2 * cfg.d_model // H
    st_mj, st_sj = jxlstm.mlstm_init_state(B, H, P), \
        jxlstm.slstm_init_state(B, cfg.d_model)
    st_mt, st_st = None, None          # the port starts from its own -inf
    pmt = convert.train_params_from_numpy(pm, "cpu")
    pst = convert.train_params_from_numpy(ps, "cpu")
    with torch.autograd.detect_anomaly():
        for x in xs:
            o_mj, st_mj = m_j(pm, x, st_mj)
            o_sj, st_sj = s_j(ps, x, st_sj)
            o_mt, st_mt = txlstm.mlstm(pmt, _T(x), n_heads=H, norm_eps=eps,
                                       state=st_mt)
            o_st, st_st = txlstm.slstm(pst, _T(x), n_heads=H, norm_eps=eps,
                                       state=st_st)
            for got, want in ((o_mt, o_mj), (o_st, o_sj), *zip(st_mt, st_mj),
                              *zip(st_st, st_sj)):
                assert not torch.isnan(got).any()
                assert_rel(got, np.asarray(want), TOL)
    for init in (txlstm.mlstm_init_state(B, H, P, "cpu"),
                 txlstm.slstm_init_state(B, 4, "cpu")):
        assert torch.isneginf(init.m).all()
