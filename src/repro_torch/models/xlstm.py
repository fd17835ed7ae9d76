"""xLSTM blocks (xlstm-125m): stabilised mLSTM (matrix memory) and sLSTM.

Counterpart of the reference's ``models/xlstm.py``.  Both cells are exact
sequential recurrences, a Python loop over time here where the reference
scans; the decode runs them on sequences of length 1, so its state is O(1).

mLSTM: per-head matrix memory C (Pv, Pk), normaliser n (Pk), stabiliser m.
sLSTM: per-head scalar-memory cell with block-diagonal recurrent weights.

The stabiliser m starts at -inf.  Where it is still -inf, the reference
selects ``m_new = i_raw`` and ``f = 0`` with ``jnp.where`` and discards the
other branch; the port selects the same values, and computes that branch
from a zero in place of -inf, so no -inf enters an arithmetic operation.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.util import fp32_reciprocal
from . import layers
from .ssm import softplus


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def _stabilise(m, logf, i_raw):
    """(m_new, i, f) of one stabilised step from the previous stabiliser
    ``m`` (-inf before the first step)."""
    first = torch.isinf(m)
    m_prev = torch.where(first, torch.zeros_like(m), m)
    m_new = torch.where(first, i_raw, torch.maximum(logf + m_prev, i_raw))
    i = torch.exp(i_raw - m_new)
    f = torch.where(first, torch.zeros_like(m),
                    torch.exp(logf + m_prev - m_new))
    return m_new, i, f


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen, d_model: int, n_heads: int, dtype, device,
               expand: int = 2, lead: tuple = ()) -> dict:
    """mLSTM weights; ``lead`` prepends axes (a stack of layers).  ``b_if``
    stays float32."""
    d_in = expand * d_model
    w = lambda *shape: layers._normal(gen, lead + shape,
                                      1.0 / math.sqrt(shape[0]), dtype, device)
    b_if = torch.cat([torch.zeros(n_heads), torch.full((n_heads,), 3.0)])
    return {
        "w_up": w(d_model, d_in),
        "w_gate": w(d_model, d_in),
        "w_q": w(d_in, d_in),
        "w_k": w(d_in, d_in),
        "w_v": w(d_in, d_in),
        "w_if": w(d_in, 2 * n_heads),
        "b_if": b_if.to(device).expand(lead + (2 * n_heads,)).clone(),
        "norm_w": torch.zeros(lead + (d_in,), dtype=dtype, device=device),
        "w_down": w(d_in, d_model),
    }


class MLSTMState(NamedTuple):
    C: torch.Tensor   # (B, H, Pv, Pk) fp32
    n: torch.Tensor   # (B, H, Pk) fp32
    m: torch.Tensor   # (B, H) fp32


def mlstm_init_state(B: int, H: int, P: int, device) -> MLSTMState:
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(C=torch.zeros((B, H, P, P), **f32),
                      n=torch.zeros((B, H, P), **f32),
                      m=torch.full((B, H), float("-inf"), **f32))


def _mlstm_cell(state: MLSTMState, q, k, v, i_raw, f_raw):
    """One stabilised mLSTM step.  q/k/v (B, H, P) fp32; gates (B, H) fp32."""
    m_new, i, f = _stabilise(state.m, _log_sigmoid(f_raw), i_raw)
    C = f[..., None, None] * state.C + i[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f[..., None] * state.n + i[..., None] * k
    h_num = torch.einsum("bhvk,bhk->bhv", C, q)
    h_den = torch.clamp(torch.einsum("bhk,bhk->bh", n, q).abs(), min=1.0)
    h = h_num / h_den[..., None]
    return MLSTMState(C=C, n=n, m=m_new), h


def mlstm(params, x, *, n_heads: int, expand: int = 2, norm_eps: float = 1e-6,
          state: Optional[MLSTMState] = None):
    """Full-sequence mLSTM mixer.  x (B, S, d) → (out, final state)."""
    B, S, d = x.shape
    d_in = expand * d
    H = n_heads
    P = d_in // H
    up = x @ params["w_up"]
    gate = x @ params["w_gate"]
    inv = fp32_reciprocal(math.sqrt(P))
    q = (up @ params["w_q"]).reshape(B, S, H, P).float() * inv
    k = (up @ params["w_k"]).reshape(B, S, H, P).float() * inv
    v = (up @ params["w_v"]).reshape(B, S, H, P).float()
    ifg = (up @ params["w_if"]).float() + params["b_if"]
    i_raw, f_raw = torch.split(ifg.reshape(B, S, 2 * H), H, dim=-1)
    if state is None:
        state = mlstm_init_state(B, H, P, x.device)
    hs = []
    for t in range(S):
        state, h = _mlstm_cell(state, q[:, t], k[:, t], v[:, t],
                               i_raw[:, t], f_raw[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, d_in).to(x.dtype)
    h = layers.rms_norm(h, params["norm_w"], norm_eps) * F.silu(gate)
    return h @ params["w_down"], state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen, d_model: int, n_heads: int, dtype, device,
               lead: tuple = ()) -> dict:
    """sLSTM weights; ``lead`` prepends axes.  ``b`` (the four gates'
    biases, forget gate at 3) stays float32."""
    P = d_model // n_heads
    b = torch.zeros((4, d_model), dtype=torch.float32)
    b[1] = 3.0
    return {
        # 4 gates (i, f, z, o): input and block-diagonal recurrent weights
        "w_x": layers._normal(gen, lead + (d_model, 4 * d_model),
                              1.0 / math.sqrt(d_model), dtype, device),
        "w_r": layers._normal(gen, lead + (4, n_heads, P, P),
                              1.0 / math.sqrt(P), dtype, device),
        "b": b.to(device).expand(lead + (4, d_model)).clone(),
        "norm_w": torch.zeros(lead + (d_model,), dtype=dtype, device=device),
        "w_out": layers._normal(gen, lead + (d_model, d_model),
                                1.0 / math.sqrt(d_model), dtype, device),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, d) fp32
    n: torch.Tensor   # (B, d) fp32
    h: torch.Tensor   # (B, d) fp32
    m: torch.Tensor   # (B, d) fp32


def slstm_init_state(B: int, d: int, device) -> SLSTMState:
    z = torch.zeros((B, d), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, h=z, m=torch.full_like(z, float("-inf")))


def _slstm_cell(state: SLSTMState, xw, params, H: int, P: int) -> SLSTMState:
    """xw: (B, 4d) precomputed input projections for one step."""
    B = xw.shape[0]
    d = xw.shape[1] // 4
    hprev = state.h.reshape(B, H, P)
    rec = torch.einsum("ghpq,bhq->gbhp", params["w_r"].float(), hprev)
    gates = xw.reshape(B, 4, d).permute(1, 0, 2) + rec.reshape(4, B, d) \
        + params["b"][:, None, :]
    i_raw, f_raw, z_raw, o_raw = gates
    m_new, i, f = _stabilise(state.m, _log_sigmoid(f_raw), i_raw)
    c = f * state.c + i * torch.tanh(z_raw)
    n = f * state.n + i
    h = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1.0)
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def slstm(params, x, *, n_heads: int, norm_eps: float = 1e-6,
          state: Optional[SLSTMState] = None):
    """Full-sequence sLSTM mixer.  x (B, S, d) → (out, final state).  The
    sLSTM block's 4/3-factor post-FFN is added by the block assembly."""
    B, S, d = x.shape
    P = d // n_heads
    xw = (x @ params["w_x"]).float()                        # (B, S, 4d)
    if state is None:
        state = slstm_init_state(B, d, x.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(state, xw[:, t], params, n_heads, P)
        hs.append(state.h)
    h = torch.stack(hs, dim=1).to(x.dtype)
    h = layers.rms_norm(h, params["norm_w"], norm_eps)
    return h @ params["w_out"], state
