"""Blockwise flash attention with a hand-written backward (plain PyTorch).

The port of the reference's ``models/flash.py``, which is a ``lax.scan``
flash attention with a custom VJP and no Pallas kernel: here a
``torch.autograd.Function`` whose forward keeps only (q, k, v, o, lse) for
the backward, which recomputes each block's scores and runs the two-pass
FlashAttention backward (pass 1: dq over query blocks; pass 2: dk and dv
over key blocks).  No (S, S) score tensor is built, and the backward holds
no per-step accumulator.

Supports GQA (Hkv <= H), dv != dqk, causal masking, a sliding window
(0 = global), the tanh softcap and a ``q_offset`` for chunked prefill.
Rows with no live key give o = 0, lse = -inf and zero gradients.

Scores are float32, as in the reference (``_scores`` casts its blocks).  A
block pair whose every (query, key) is masked is skipped: the reference's
online softmax leaves its state unchanged by such a block (its rescale
factor is exactly 1, or its state stays 0), and its backward adds exact
zeros, so skipping it gives the same result and saves the causal upper
triangle and everything outside a window.  A block pair whose every
(query, key) is visible skips the mask and the guards for rows with no
live key, which are no-ops there.
"""
from __future__ import annotations

import torch

from ..core.util import fp32_reciprocal


def _pick_block(s: int, target: int) -> int:
    b = min(target, s)
    while s % b:
        b -= 1
    return b


class _Geom:
    """Block geometry and masking of one call."""

    def __init__(self, Sq, Sk, bq, bk, causal, window, q_offset):
        self.bq, self.bk = bq, bk
        self.nq, self.nk = Sq // bq, Sk // bk
        self.causal, self.window, self.q_offset = causal, int(window), q_offset

    def _bounds(self, qi: int, kj: int):
        q0 = self.q_offset + qi * self.bq
        k0 = kj * self.bk
        return q0, q0 + self.bq - 1, k0, k0 + self.bk - 1

    def live(self, qi: int, kj: int) -> bool:
        """False when every (query, key) of the block pair is masked."""
        q0, q1, k0, k1 = self._bounds(qi, kj)
        if self.causal and k0 > q1:
            return False
        return not (self.window > 0 and k1 <= q0 - self.window)

    def full(self, qi: int, kj: int) -> bool:
        """True when every (query, key) of the block pair is visible: the
        mask and the guards for rows with no live key are no-ops there."""
        q0, q1, k0, k1 = self._bounds(qi, kj)
        if self.causal and k1 > q0:
            return False
        return not (self.window > 0 and k0 <= q1 - self.window)

    def mask(self, qi: int, kj: int, device):
        """(bq, bk) bool: True where the key is visible to the query; None
        for a `full` block pair."""
        if self.full(qi, kj):
            return None
        qpos = self.q_offset + qi * self.bq + torch.arange(
            self.bq, device=device, dtype=torch.int32)[:, None]
        kpos = kj * self.bk + torch.arange(self.bk, device=device,
                                           dtype=torch.int32)[None, :]
        mask = torch.ones((self.bq, self.bk), dtype=torch.bool, device=device)
        if self.causal:
            mask &= kpos <= qpos
        if self.window > 0:
            mask &= kpos > qpos - self.window
        return mask


def _scores(qblk, kblk, scale: float, softcap: float):
    """``qblk (B,Hkv,G,bq,dh) @ kblk (B,Hkv,bk,dh)^T * scale``, softcapped."""
    s = torch.matmul(qblk, kblk.transpose(-1, -2)[:, :, None]) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s * fp32_reciprocal(softcap))
    return s


def _layout(q, k, v):
    """fp32 copies with heads ahead of positions: q (B,Hkv,G,Sq,dh),
    k (B,Hkv,Sk,dh), v (B,Hkv,Sk,dv)."""
    return (q.float().permute(0, 2, 3, 1, 4).contiguous(),
            k.float().permute(0, 2, 1, 3).contiguous(),
            v.float().permute(0, 2, 1, 3).contiguous())


def _forward(q, k, v, geo: _Geom, scale: float, softcap: float):
    qf, kf, vf = _layout(q, k, v)
    B, Hkv, G, Sq, _ = qf.shape
    dv = vf.shape[-1]
    bq, bk = geo.bq, geo.bk
    o = torch.empty((B, Hkv, G, Sq, dv), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    neg_inf = float("-inf")
    for qi in range(geo.nq):
        qblk = qf[:, :, :, qi * bq:(qi + 1) * bq]
        m = torch.full((B, Hkv, G, bq, 1), neg_inf, device=q.device)
        l = torch.zeros((B, Hkv, G, bq, 1), device=q.device)
        acc = torch.zeros((B, Hkv, G, bq, dv), device=q.device)
        for kj in range(geo.nk):
            if not geo.live(qi, kj):
                continue
            kblk = kf[:, :, kj * bk:(kj + 1) * bk]
            vblk = vf[:, :, kj * bk:(kj + 1) * bk]
            s = _scores(qblk, kblk, scale, softcap)
            mask = geo.mask(qi, kj, q.device)
            if mask is not None:
                s = s.masked_fill(~mask, neg_inf)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            if mask is not None:   # a row with no live key yet: exp(nan)
                alpha = torch.where(torch.isnan(alpha), 0.0, alpha)
                p = torch.where(torch.isnan(p), 0.0, p)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vblk[:, :, None])
            m = m_new
        o[:, :, :, qi * bq:(qi + 1) * bq] = torch.where(
            l > 0, acc / torch.clamp(l, min=1e-30), 0.0)
        blk_lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
        lse[:, :, :, qi * bq:(qi + 1) * bq] = torch.where(
            torch.isinf(m[..., 0]), neg_inf, blk_lse)
    # back to (B, Sq, Hkv, G, dv); lse stays (B, Hkv, G, Sq)
    return o.permute(0, 3, 1, 2, 4).to(q.dtype), lse


def _backward(q, k, v, o, lse, do, geo: _Geom, scale: float, softcap: float):
    qf, kf, vf = _layout(q, k, v)
    dof = do.float().permute(0, 2, 3, 1, 4).contiguous()      # (B,Hkv,G,Sq,dv)
    # delta_i = rowsum(do_i * o_i)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 3, 1)
    bq, bk = geo.bq, geo.bk

    def block_ds(qi, kj):
        """Recompute p and ds for one (q, k) block pair."""
        qs, ks = slice(qi * bq, (qi + 1) * bq), slice(kj * bk, (kj + 1) * bk)
        mask = geo.mask(qi, kj, q.device)
        s_cap = _scores(qf[:, :, :, qs], kf[:, :, ks], scale, softcap)
        if mask is not None:
            s_cap = s_cap.masked_fill(~mask, float("-inf"))
        p = torch.exp(s_cap - lse[:, :, :, qs, None])
        if mask is not None:   # rows with no live key: lse = -inf
            p = torch.where(torch.isnan(p) | torch.isinf(p), 0.0, p)
        dp = torch.matmul(dof[:, :, :, qs], vf[:, :, None, ks].transpose(-1, -2))
        ds = p * (dp - delta[:, :, :, qs, None])
        if softcap > 0.0:
            t = s_cap if mask is None else torch.where(mask, s_cap, 0.0)
            t = t * fp32_reciprocal(softcap)
            ds = ds * (1.0 - t * t)
        if mask is not None:
            ds = torch.where(mask, ds, 0.0)
        return p, ds * scale

    # ---- pass 1: dq, query block by query block
    dq = torch.zeros_like(qf)
    for qi in range(geo.nq):
        acc = dq[:, :, :, qi * bq:(qi + 1) * bq]
        for kj in range(geo.nk):
            if geo.live(qi, kj):
                _, ds = block_ds(qi, kj)
                acc += torch.matmul(ds, kf[:, :, None, kj * bk:(kj + 1) * bk])
    # ---- pass 2: dk, dv, key block by key block (GQA groups summed)
    dk, dvv = torch.zeros_like(kf), torch.zeros_like(vf)
    for kj in range(geo.nk):
        ks = slice(kj * bk, (kj + 1) * bk)
        for qi in range(geo.nq):
            if not geo.live(qi, kj):
                continue
            qs = slice(qi * bq, (qi + 1) * bq)
            p, ds = block_ds(qi, kj)
            dvv[:, :, ks] += torch.einsum("bhgqk,bhgqd->bhkd", p, dof[:, :, :, qs])
            dk[:, :, ks] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qf[:, :, :, qs])
    return (dq.permute(0, 3, 1, 2, 4).to(q.dtype),
            dk.permute(0, 2, 1, 3).to(k.dtype),
            dvv.permute(0, 2, 1, 3).to(v.dtype))


class _Flash(torch.autograd.Function):
    """q (B, Sq, Hkv, G, dh), k (B, Sk, Hkv, dh), v (B, Sk, Hkv, dv) →
    o (B, Sq, Hkv, G, dv) in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, geo, softcap):
        scale = q.shape[-1] ** -0.5
        o, lse = _forward(q, k, v, geo, scale, softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.geo, ctx.softcap, ctx.scale = geo, softcap, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, ctx.geo, ctx.scale,
                               ctx.softcap)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """q (B, Sq, H, dh), k (B, Sk, Hkv, dh), v (B, Sk, Hkv, dv) →
    (B, Sq, H, dv) in q's dtype; ``window`` 0 is global."""
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    bq, bk = _pick_block(Sq, block_q), _pick_block(Sk, block_k)
    geo = _Geom(Sq, Sk, bq, bk, causal, window, int(q_offset))
    qg = q.reshape(B, Sq, Hkv, H // Hkv, dh)
    o = _Flash.apply(qg, k, v, geo, float(softcap))
    return o.reshape(B, Sq, H, v.shape[-1])
