"""Optimizers: AdamW (fp32 moments), Adam8bit (block-quantised moments),
Adafactor (factored second moment).

The port of the reference's ``optim/adam.py``, with its state NamedTuples
and field names, so a ``TrainState`` checkpoint crosses packages.  An
`Optimizer` is ``init(params) -> state`` and ``update(grads, state, params)
-> (params, state)``; here the update writes the parameters and the state
in place, leaf by leaf under ``torch.no_grad``, and returns the same
objects.  Each leaf is updated in pieces of whole rows along its last
axis, as the reference's ``_maybe_map`` updates a large leaf layer block
by layer block, so the temporaries stay per piece: up to 2^27 elements on
the card; on the CPU 2^18, so that they stay in cache (allocating fresh
pages for float64 temporaries the size of a layer costs 20× the
arithmetic there).

Numerics follow the reference as XLA compiles it on the CPU: ``a * x + y``
with a scalar ``a`` is one fused multiply-add (XLA contracts it), which
the port computes in float64 from the exact float32 product and rounds
once (`_fma`); a division by a constant is a multiply by its float32
reciprocal; a mean is sum × reciprocal.  The schedule's scalars are 0-d
tensors on the parameters' device, so an update never waits on the card.
Adam8bit's int8 codes then equal the reference's bit for bit (rounding is
half to even in both packages).

On a mesh the trees' leaves are `parallel.sharding.Sharded` and each rank
updates its own blocks (`_leaf_sets`): AdamW is elementwise; Adam8bit
quantises 64-element blocks along the last axis, so a leaf whose last axis
splits into blocks of a width that is not a multiple of 64 is updated
whole (gathered on the mesh's first device, the result written back to
every rank's block), which keeps the reference's codes; Adafactor's
factored statistics and update norm span the whole leaf, so it updates
every split leaf whole.  `init_on_mesh` makes an optimizer's (all-zero)
initial state on the mesh, placed by `param_specs.opt_state_shardings`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..checkpoint.checkpoint import tree_leaves, tree_map, tree_unflatten
from ..core.util import fp32_reciprocal, mean_last
from ..parallel import param_specs
from ..parallel.sharding import Sharded, zeros_sharded


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable   # (grads, state, params) -> (params, state), in place


_PIECE = {"cuda": 2 ** 27, "cpu": 2 ** 18}   # elements of one update piece


def _f32(x: float) -> float:
    """A Python scalar rounded to float32, as XLA takes a weak-typed one."""
    return float(np.float32(x))


def _fma(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 ``a * x + y`` rounded once, as XLA's contracted multiply-add
    (the float32 product is exact in float64)."""
    if isinstance(a, torch.Tensor):
        a = a.double()
    return (x.double() * a + y.double()).float()


def _pieces(*leaves):
    """The leaves (contiguous, with as many rows as the last one, the
    parameter) viewed as ``(rows, last axis)`` and cut into pieces of whole
    rows, each about `_PIECE` elements of the parameter."""
    rows = [leaf.reshape(-1, leaf.shape[-1] if leaf.dim() else 1)
            for leaf in leaves]
    p = rows[-1]
    step = max(1, _PIECE.get(p.device.type, _PIECE["cuda"]) // p.shape[1])
    return zip(*(r.split(step) for r in rows))


def _map(fn: Callable, tree):
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])


def _leaf_sets(grads, *trees, whole=None):
    """For each leaf of ``grads`` and the matching leaves of ``trees`` (the
    optimizer state's, then the parameters'), the tensors one update runs
    on: the leaves themselves; for `Sharded` leaves each rank's blocks in
    turn, or where ``whole(leaves)`` holds the leaves' global tensors on
    the mesh's first device, whose updated values are then written back to
    every rank's blocks of ``trees``."""
    for leaves in zip(*(tree_leaves(t) for t in (grads,) + trees)):
        if not isinstance(leaves[-1], Sharded):
            yield leaves
        elif whole is not None and whole(leaves):
            full = [x.full() for x in leaves]
            yield tuple(full)
            for x, f in zip(leaves[1:], full[1:]):
                x.read_from(f)
        else:
            for r in range(len(leaves[-1].shards)):
                yield tuple(x.shards[r] for x in leaves)


class _OnDevice:
    """The step's scalars (0-d tensors) copied once to each device that
    asks for them."""

    def __init__(self, *scalars):
        self._by = {scalars[0].device: scalars}

    def on(self, device):
        if device not in self._by:
            self._by[device] = tuple(s.to(device) for s in
                                     next(iter(self._by.values())))
        return self._by[device]


def init_on_mesh(optimizer: "Optimizer", params):
    """``optimizer.init`` of a tree of `Sharded` parameters: the state's
    structure, shapes and dtypes from the optimizer's init over meta
    tensors of the global shapes, each leaf zeros placed by
    `param_specs.opt_state_shardings` (every optimizer here starts from
    zeros), the 0-d step on the mesh's first device."""
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), params)
    like = optimizer.init(meta)
    mesh = tree_leaves(params)[0].mesh
    specs = param_specs.opt_state_shardings(
        like, param_specs.specs_of(params), mesh)

    def zeros(_, x, spec):
        if x.dim() == 0:
            return torch.zeros((), dtype=x.dtype, device=mesh.devices[0])
        return zeros_sharded(tuple(x.shape), x.dtype, spec, mesh)
    return param_specs.map_with_path(zeros, like, specs)


def _step_scalars(step: torch.Tensor, lr: float, b1: float, b2: float,
                  warmup: int):
    """(lr_t, 1 - b1^t, 1 - b2^t) as float32 0-d tensors on the device."""
    s = step.float()
    warm = torch.clamp((s + 1) * fp32_reciprocal(warmup), max=1.0)
    lr_t = warm * _f32(lr)
    one = torch.ones((), dtype=torch.float32, device=step.device)
    b1c = one - torch.pow(one * _f32(b1), s)
    b2c = one - torch.pow(one * _f32(b2), s)
    return lr_t, b1c, b2c


def _moments(g, m, v, b1: float, b2: float):
    """Adam's new moments of one block (float32)."""
    m = _fma(_f32(b1), m, g * _f32(1 - b1))
    v = _fma(_f32(b2), v, (g * _f32(1 - b2)) * g)
    return m, v


def _apply(p: torch.Tensor, u: torch.Tensor, lr_t, weight_decay: float):
    """``p - lr_t * (u + wd * p)`` in float32, written into ``p``."""
    p32 = p.float()
    new = _fma(-lr_t, _fma(_f32(weight_decay), p32, u), p32)
    p.copy_(new)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01,
          warmup: int = 100) -> Optimizer:
    def init(params):
        p0 = tree_leaves(params)[0]
        zeros = lambda: _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
        return AdamState(step=torch.zeros((), dtype=torch.int32,
                                          device=p0.device),
                         m=zeros(), v=zeros())

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        scalars = _OnDevice(*_step_scalars(step, lr, b1, b2, warmup))
        for leaves in _leaf_sets(grads, state.m, state.v, params):
            lr_t, b1c, b2c = scalars.on(leaves[-1].device)
            for g, m, v, p in _pieces(*leaves):
                m_new, v_new = _moments(g.float(), m, v, b1, b2)
                u = (m_new / b1c) / (torch.sqrt(v_new / b2c) + _f32(eps))
                _apply(p, u, lr_t, weight_decay)
                m.copy_(m_new)
                v.copy_(v_new)
        return params, state._replace(step=step)

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------------------
# Adam8bit — block-quantised moments
# ---------------------------------------------------------------------------

BLOCK = 64


def _pad_blocks(x: torch.Tensor) -> torch.Tensor:
    """``x (..., n)`` zero-padded to whole blocks → ``(..., nb, BLOCK)``."""
    xr = x.reshape(x.shape or (1,))
    pad = (-xr.shape[-1]) % BLOCK
    xp = torch.nn.functional.pad(xr, (0, pad))
    return xp.reshape(*xp.shape[:-1], xp.shape[-1] // BLOCK, BLOCK)


def _quantize(x: torch.Tensor):
    """float32 ``(..., n)`` → (int8 codes of the same shape, float32
    per-block scales ``(..., ceil(n / BLOCK))``), blockwise along the last
    axis: scale = absmax / 127, codes = round(x / scale)."""
    n = x.shape[-1] if x.dim() else 1
    xb = _pad_blocks(x)
    scale = xb.abs().amax(dim=-1) * fp32_reciprocal(127.0)
    codes = torch.round(xb / torch.clamp(scale[..., None], min=1e-12))
    codes = codes.to(torch.int8).reshape(*xb.shape[:-2], -1)[..., :n]
    return codes.reshape(x.shape), scale


def _dequantize(codes: torch.Tensor, scale: torch.Tensor, shape):
    n = codes.shape[-1] if codes.dim() else 1
    cb = _pad_blocks(codes)
    x = cb.float() * scale[..., None]
    return x.reshape(*cb.shape[:-2], -1)[..., :n].reshape(shape)


def _straddles_blocks(leaves) -> bool:
    """Whether a `Sharded` parameter's last axis splits into blocks whose
    width is not a whole number of quantisation blocks."""
    p = leaves[-1]
    if not p.shape:
        return False
    return p.shards[0].shape[-1] != p.shape[-1] and \
        p.shards[0].shape[-1] % BLOCK != 0


class Adam8bitState(NamedTuple):
    step: torch.Tensor
    m_codes: dict
    m_scale: dict
    v_codes: dict
    v_scale: dict


def adam8bit(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
             eps: float = 1e-8, weight_decay: float = 0.01,
             warmup: int = 100) -> Optimizer:
    def init(params):
        # `_quantize` of zeros: zero codes, zero scales
        p0 = tree_leaves(params)[0]
        codes = lambda: _map(lambda p: torch.zeros(
            p.shape, dtype=torch.int8, device=p.device), params)
        scales = lambda: _map(lambda p: torch.zeros(
            p.shape[:-1] + (-(-p.shape[-1] // BLOCK),) if p.dim() else (1,),
            dtype=torch.float32, device=p.device), params)
        return Adam8bitState(step=torch.zeros((), dtype=torch.int32,
                                              device=p0.device),
                             m_codes=codes(), m_scale=scales(),
                             v_codes=codes(), v_scale=scales())

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        scalars = _OnDevice(*_step_scalars(step, lr, b1, b2, warmup))
        for leaves in _leaf_sets(grads, state.m_codes, state.m_scale,
                                 state.v_codes, state.v_scale, params,
                                 whole=_straddles_blocks):
            lr_t, b1c, b2c = scalars.on(leaves[-1].device)
            for g, mc, ms, vc, vs, p in _pieces(*leaves):
                g = g.float()
                m = _dequantize(mc, ms, g.shape)
                v = _dequantize(vc, vs, g.shape)
                m, v = _moments(g, m, v, b1, b2)
                v = torch.clamp(v, min=0.0)
                u = (m / b1c) / (torch.sqrt(v / b2c) + _f32(eps))
                _apply(p, u, lr_t, weight_decay)
                for (c, s), x in (((mc, ms), m), ((vc, vs), v)):
                    c2, s2 = _quantize(x)
                    c.copy_(c2)
                    s.copy_(s2)
        return params, state._replace(step=step)

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment) — memory floor
# ---------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: dict   # row stats
    vc: dict   # col stats


def _mean_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.mean(dim)`` as sum × float32 reciprocal of the count."""
    return x.sum(dim) * fp32_reciprocal(x.shape[dim])


def adafactor(lr: float = 3e-4, eps: float = 1e-30, clip: float = 1.0) -> Optimizer:
    def init(params):
        p0 = tree_leaves(params)[0]

        def zero(p, col: bool):
            if p.dim() >= 2:
                shape = p.shape[:-2] + p.shape[-1:] if col else p.shape[:-1]
            else:
                shape = (1,) if col else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdafactorState(step=torch.zeros((), dtype=torch.int32,
                                               device=p0.device),
                              vr=_map(lambda p: zero(p, False), params),
                              vc=_map(lambda p: zero(p, True), params))

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        beta = 1.0 - torch.pow(step.float() + 1, -0.8)
        f_eps = _f32(eps)
        for g, vr, vc, p in _leaf_sets(grads, state.vr, state.vc, params,
                                       whole=lambda leaves: True):
            g = g.float()
            g2 = g * g + f_eps
            if p.dim() >= 2:
                vr.copy_(_fma(beta, vr, (1 - beta) * mean_last(g2)))
                vc.copy_(_fma(beta, vc, (1 - beta) * _mean_dim(g2, -2)))
                r = vr / torch.clamp(mean_last(vr)[..., None], min=f_eps)
                u = g / torch.sqrt(torch.clamp(r[..., None] * vc[..., None, :],
                                               min=f_eps))
            else:
                vr.copy_(_fma(beta, vr, (1 - beta) * g2))
                u = g / torch.sqrt(torch.clamp(vr, min=f_eps))
            norm = torch.sqrt((u * u).sum() * fp32_reciprocal(u.numel()))
            u = u / torch.clamp(norm * fp32_reciprocal(clip), min=1.0)
            p.copy_(_fma(-_f32(lr), u, p.float()))
        return params, state._replace(step=step)

    return Optimizer(init=init, update=update)


OPTIMIZERS = {"adamw": adamw, "adam8bit": adam8bit, "adafactor": adafactor}
