"""Gradient compression: int8 block-quantised all-reduce with error feedback.

The port of the reference's ``optim/compress.py``.  Each rank quantises
(grad + carried error) to per-64-block int8, all-reduces the codes (summing
int8 codes times their scales), dequantises, and carries the quantisation
residual to the next step (error feedback keeps SGD unbiased in the long
run): 4x fewer bytes on the link, int8 codes + one fp32 scale per 64.

The reference calls it under ``shard_map``, on each device's gradients; here
it takes the mesh's per-rank gradients: ``grads`` is a sequence with one
tree a rank (rank r's tensors on ``mesh.devices[r]``), and the reduction
runs over the named mesh axis with `parallel.sharding.psum`.  Nothing in
the train step calls it.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..checkpoint.checkpoint import tree_leaves, tree_unflatten
from ..core.util import fp32_reciprocal
from ..parallel.sharding import Mesh, axis_size, psum

BLOCK = 64


class ErrorState(NamedTuple):
    err: list    # one tree a rank, like the grads, fp32 quantisation residuals


def init_error_state(grads_like: Sequence) -> ErrorState:
    return ErrorState(err=[tree_unflatten(g, [
        torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for x in tree_leaves(g)]) for g in grads_like])


def _q(x: torch.Tensor):
    """float32 ``x`` → (int8 codes ``(nb, BLOCK)`` of the flattened, zero-
    padded ``x``, float32 scales ``(nb,)``): scale = absmax / 127."""
    n = x.numel()
    pad = (-n) % BLOCK
    xp = torch.nn.functional.pad(x.reshape(-1), (0, pad)).reshape(-1, BLOCK)
    scale = xp.abs().amax(dim=1, keepdim=True) * fp32_reciprocal(127.0)
    codes = torch.round(xp / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return codes, scale[:, 0]


def _dq(codes: torch.Tensor, scale: torch.Tensor, shape, n: int) -> torch.Tensor:
    return (codes.float() * scale[:, None]).reshape(-1)[:n].reshape(shape)


def compressed_psum_leaf(gs: Sequence[torch.Tensor], es: Sequence[torch.Tensor],
                         mesh: Mesh, axis):
    """One leaf, one tensor a rank: quantise(g + e), sum codes x scales over
    ``axis``, dequantise the mean; returns (reduced grads, new errors), one
    a rank."""
    xs = [g.float() + e for g, e in zip(gs, es)]
    qs = [_q(x) for x in xs]
    new_err = [x - _dq(c, s, x.shape, x.numel()) for x, (c, s) in zip(xs, qs)]
    n_dev = axis_size(mesh, axis)
    summed = psum([c.to(torch.int32) * s[:, None] for c, s in qs], mesh, axis)
    reduced = [(t / n_dev).reshape(-1)[:x.numel()].reshape(x.shape)
               for t, x in zip(summed, xs)]
    return reduced, new_err


def compressed_pmean(grads: Sequence, err_state: ErrorState, mesh: Mesh,
                     axis):
    """Every leaf of the per-rank ``grads`` through `compressed_psum_leaf`
    → (one reduced tree a rank, the new `ErrorState`)."""
    per_rank = [tree_leaves(g) for g in grads]
    errs = [tree_leaves(e) for e in err_state.err]
    red = [[] for _ in grads]
    new = [[] for _ in grads]
    for j in range(len(per_rank[0])):
        r, e = compressed_psum_leaf([p[j] for p in per_rank],
                                    [q[j] for q in errs], mesh, axis)
        for i in range(len(grads)):
            red[i].append(r[i])
            new[i].append(e[i])
    return ([tree_unflatten(g, x) for g, x in zip(grads, red)],
            ErrorState(err=[tree_unflatten(g, x) for g, x in zip(grads, new)]))


def bytes_saved_per_step(grads) -> tuple[int, int]:
    """(exact fp32 all-reduce bytes, compressed bytes) per rank of one
    rank's gradient tree."""
    n = sum(g.numel() for g in tree_leaves(grads))
    exact = n * 4
    comp = n * 1 + (n // BLOCK + 1) * 4
    return exact, comp
