"""Small shared helpers for the sketch state machines."""
from __future__ import annotations

import torch

_INT32_MAX = 2**31 - 1


def saturating_add(counter: torch.Tensor, delta) -> torch.Tensor:
    """int32 counter + delta, clamped at INT32_MAX instead of wrapping.

    Stream counters (`n_seen`, `t`, `n`) are int32, as in the reference;
    streams longer than 2^31 steps saturate, so the counters stop being
    exact but stay monotone and positive.  ``delta`` may be a Python int or
    an int tensor (broadcast against ``counter``)."""
    counter = counter.to(torch.int32)
    if isinstance(delta, int):          # a scalar operand: no copy to the card
        overflow = counter > _INT32_MAX - max(delta, 0)
    else:
        delta = torch.as_tensor(delta, dtype=torch.int32, device=counter.device)
        overflow = (delta > 0) & (counter > _INT32_MAX - delta)
    return torch.where(overflow, torch.full_like(counter + delta, _INT32_MAX),
                       counter + delta)


def mean_last(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(-1)`` as the reference computes it: XLA turns ``jnp.mean``'s
    division by the count into multiplication by the float32 reciprocal, so
    the port sums, then multiplies by that reciprocal (a 0-d tensor, so the
    product is one fp32 multiply on every device)."""
    return x.sum(-1) * x.new_full((), 1.0 / x.shape[-1])


def resolve_device(device) -> torch.device:
    """The device an allocating entry point will use.  A CUDA device without
    a card raises: the port never drops to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return device


def set_drop(base: torch.Tensor, idx: torch.Tensor,
             src: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].set(src, mode="drop")`` along dim 0, out of place.

    Indices outside ``[0, base.shape[0])`` are dropped.  The write goes to
    a copy with one spare row that absorbs the dropped entries, so no mask
    is compacted and nothing waits on the device.  In-range indices must be
    distinct (as in every caller), so the result is deterministic."""
    n = base.shape[0]
    idx = torch.where((idx >= 0) & (idx < n), idx, n).to(torch.int64)
    buf = torch.empty((n + 1,) + tuple(base.shape[1:]), dtype=base.dtype,
                      device=base.device)
    buf[:n] = base
    buf.index_copy_(0, idx, src.to(base.dtype))
    return buf[:n]
