"""Public wrappers for the four CUDA kernels of the main path.

Dispatch (single source of truth: `dispatch.py`): a CUDA tensor launches
the hand-written kernel, a CPU tensor runs the plain version in `ref`.
`LAUNCHES` maps each kernel name to the number of times its kernel was
launched; only the launch itself adds to it.
"""
from __future__ import annotations

import torch

from . import _build
from . import batch_score as _bs
from . import ingest_commit as _ic
from . import race_update as _ru
from . import ref
from .dispatch import use_kernel

LAUNCHES = _build.LAUNCHES


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def race_hist(codes: torch.Tensor, W: int) -> torch.Tensor:
    """Per-row histogram of ``codes (B, L) int32`` → ``(L, W) int32``."""
    if use_kernel(codes):
        return _ru.race_hist(codes, W)
    return ref.race_hist_ref(codes, W)


def batch_score_topk(qs: torch.Tensor, cands: torch.Tensor, ok: torch.Tensor,
                     k: int):
    """Fused batched scorer: masked squared-L2 top-k of ``cands (B, M, d)``
    against ``qs (B, d)`` → ``(d2 (B, k) ascending, idx (B, k) int32)``;
    k = 1 is the argmin of the (c, r)-query path."""
    if use_kernel(cands):
        return _bs.batch_score_topk(qs, cands, ok, k)
    return ref.batch_score_topk_ref(qs, cands, ok, k)


def swakde_segment_pass(cell_ts, cell_num, done, sorted_ts, seg_first,
                        seg_len, *, window: int, maxb: int, n_levels: int,
                        cap: int = 0):
    """One expiry-free closed-form commit pass over the prepared segments
    (see `ref.swakde_segment_pass_ref`) → ``(cell_ts, cell_num, done)``."""
    fn = _ic.swakde_segment_pass if use_kernel(cell_ts) \
        else ref.swakde_segment_pass_ref
    return fn(cell_ts, cell_num, done, sorted_ts, seg_first, seg_len,
              window=window, maxb=maxb, n_levels=n_levels, cap=cap)


def sann_table_scatter(tables, table_ptr, s_l, s_c, rank, val, mask):
    """Sorted-segment ring append into the S-ANN hash tables, **in place**
    on ``tables`` (see `ref.sann_table_scatter_ref`); returns ``tables``."""
    fn = _ic.sann_table_scatter if use_kernel(tables) \
        else ref.sann_table_scatter_ref
    return fn(tables, table_ptr, s_l, s_c, rank, val, mask)
