"""xLSTM blocks (xlstm-125m): stabilised mLSTM (matrix memory) and sLSTM.

Counterpart of the reference's ``models/xlstm.py``.  Both cells are exact
sequential recurrences, a Python loop over time here where the reference
scans; the decode runs them on sequences of length 1, so its state is O(1).

mLSTM: per-head matrix memory C (Pv, Pk), normaliser n (Pk), stabiliser m.
sLSTM: per-head scalar-memory cell with block-diagonal recurrent weights.

On a ``(data, model)`` mesh (`mlstm_ranks`, `slstm_ranks`) the mLSTM splits
its heads over ``model`` where ``d_in / model`` falls on whole heads (the
reference constrains nothing here, but its specs split ``w_up``,
``w_gate``, ``w_q`` on their columns and ``w_down`` on its rows by name):
each rank gathers ``w_up`` whole (every head's query, key and value reads
all of ``up``), takes its heads' columns of ``w_q``, ``w_k``, ``w_v`` and
the gates, runs the cell on its heads, normalises by the ranks' summed
squares and takes its rows of ``w_down``, summed over ``model``; otherwise
it gathers every weight and runs every head on every rank.  The sLSTM
gathers its weights and runs whole on every rank.  The time loops run on
each rank's rows of the batch.

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
from ..parallel import sharding
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
    """Full-sequence mLSTM mixer.  x (B, S, d) → (out, final state):
    `_mlstm_heads` over every head, then `_mlstm_out`."""
    h, gate, state = _mlstm_heads(params, x, 0, n_heads, n_heads=n_heads,
                                  expand=expand, state=state)
    return _mlstm_out(params, h, gate, None, 0, norm_eps), state


def _mlstm_heads(p, x, h0: int, n: int, *, n_heads: int, expand: int,
                 state: Optional[MLSTMState] = None):
    """The mLSTM cell of the heads ``[h0, h0 + n)`` (one rank's heads on a
    mesh, or all of them) before its norm: x (B, S, d) → (h (B, S, n P) in
    x's dtype, the gate's pre-activation (B, S, n P), the final state).
    ``w_gate`` and ``w_q`` hold those heads' columns and ``w_down`` their
    rows (the whole weights when ``n`` is ``n_heads``); the other leaves
    are whole."""
    B, S, d = x.shape
    H = n_heads
    P = expand * d // H
    lo, hi = h0 * P, (h0 + n) * P
    inv = fp32_reciprocal(math.sqrt(P))
    up = x @ p["w_up"]
    heads = lambda t: t.reshape(B, S, n, P).float()
    q = heads(up @ p["w_q"]) * inv
    k = heads(up @ p["w_k"][:, lo:hi]) * inv
    v = heads(up @ p["w_v"][:, lo:hi])
    ifg = (up @ p["w_if"]).float() + p["b_if"]
    i_raw, f_raw = ifg[..., h0:h0 + n], ifg[..., H + h0:H + h0 + n]
    if state is None:
        state = mlstm_init_state(B, n, P, x.device)
    hs = []
    for t in range(S):
        state, h = _mlstm_cell(state, q[:, t], k[:, t], v[:, t],
                               i_raw[:, t], f_raw[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, n * P).to(x.dtype)
    return h, x @ p["w_gate"], state


def _mlstm_out(p, h, gate, sq, lo: int, norm_eps: float):
    """The norm of ``h (B, S, n)``, columns ``[lo, lo + n)`` of ``d_in``, by
    ``sq``, the float32 sum of squares over all of ``d_in`` (the ranks' sum
    on a mesh; None where ``h`` is all of it), gated, then ``w_down`` (those columns' rows)."""
    w = p["norm_w"][lo:lo + h.shape[-1]]
    y = layers.rms_norm(h, w, norm_eps, sq=sq, n=p["norm_w"].shape[-1])
    return (y * F.silu(gate)) @ p["w_down"]


def mlstm_ranks(params, hs: list, mesh, *, n_heads: int, expand: int = 2,
                norm_eps: float = 1e-6) -> list:
    """`mlstm`'s output of one activation a rank, one body for every case:
    `_mlstm_heads` on a rank's heads, then `_mlstm_out`.  The heads split
    over ``model`` where ``w_gate`` and ``w_q`` split their columns and
    ``w_down`` its rows over ``model`` alone and ``d_in / model`` falls on
    whole heads: a rank takes those blocks, gathers the rest whole, and the
    squares and the outputs are summed over ``model``.  Otherwise (and on
    one device, with no ``mesh``) each rank gathers every weight and runs
    every head."""
    M = mesh.shape.get("model", 1) if mesh is not None else 1
    H = n_heads
    split = (M > 1 and H % M == 0
             and all(layers._model_split(params[k], -1)
                     for k in ("w_gate", "w_q"))
             and layers._model_split(params["w_down"], -2))
    if split:
        local = {k: params[k].gathered(keep=("model",))
                 for k in ("w_gate", "w_q", "w_down")}
        whole = {k: layers.rank_leaves(v, len(hs)) for k, v in params.items()
                 if k not in local}
        w = [{k: v[r] for k, v in {**whole, **local}.items()}
             for r in range(len(hs))]
    else:
        w = layers.gathered_tree(params)
    Hl = H // M if split else H
    h0s = [sharding.axis_index(mesh, r, "model") * Hl if split else 0
           for r in range(len(hs))]
    P = expand * hs[0].shape[-1] // H
    outs = [_mlstm_heads(w[r], x, h0s[r], Hl, n_heads=H, expand=expand)
            for r, x in enumerate(hs)]
    sq = (sharding.psum([(h.float() * h.float()).sum(-1) for h, _, _ in outs],
                        mesh, "model") if split else [None] * len(outs))
    parts = [_mlstm_out(w[r], h, g, sq[r], h0s[r] * P, norm_eps)
             for r, (h, g, _) in enumerate(outs)]
    return sharding.psum(parts, mesh, "model") if split else parts


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


def slstm_ranks(params, hs: list, *, n_heads: int,
                norm_eps: float = 1e-6) -> list:
    """`slstm`'s output of one activation a rank, its weights gathered
    whole (with no mesh, `slstm` on one device)."""
    w = layers.gathered_tree(params)
    return [slstm(w[r], h, n_heads=n_heads, norm_eps=norm_eps)[0]
            for r, h in enumerate(hs)]
