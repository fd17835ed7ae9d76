"""Public wrappers for the seven CUDA kernels and their fused entries.

Dispatch (single source of truth: `dispatch.py`): a CUDA tensor launches
the hand-written kernel, a CPU tensor runs the plain version in `ref`.
`LAUNCHES` maps each kernel name to the number of times its kernel was
launched; only the launch itself adds to it.
"""
from __future__ import annotations

import torch

from . import _build
from . import batch_score as _bs
from . import cand_score as _cs
from . import ingest_commit as _ic
from . import race_update as _ru
from . import ref
from . import sketch_decode_attn as _sda
from . import srp_hash as _sh
from .dispatch import use_kernel

LAUNCHES = _build.LAUNCHES


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def srp_hash(x: torch.Tensor, proj: torch.Tensor, mix: torch.Tensor,
             n_buckets: int) -> torch.Tensor:
    """SRP codes of ``x (B, d)`` → ``(B, L) int32``: projection, sign bits
    and the uint32 fold (see `ref.srp_hash_ref`)."""
    if use_kernel(x):
        return _sh.srp_hash(x, proj, mix, n_buckets)
    return ref.srp_hash_ref(x, proj, mix, n_buckets)


def cand_score(q: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Squared L2 of ``q (d,)`` to each row of ``cands (M, d)`` → ``(M,)``
    float32, diff-based (the per-query S-ANN scorer)."""
    if use_kernel(cands):
        return _cs.cand_score(q, cands)
    return ref.cand_score_ref(q, cands)


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


def batch_score_topk_gather(qs: torch.Tensor, points: torch.Tensor,
                            cand: torch.Tensor, ok: torch.Tensor, k: int):
    """`batch_score_topk` of the rows ``points[max(cand, 0)]`` for slot ids
    ``cand (B, M) int32`` into ``points (N, d)``; on the card the kernel
    reads the rows itself (the ``(B, M, d)`` gather is never built) and
    counts one ``batch_score_topk`` launch."""
    if use_kernel(points):
        return _bs.batch_score_topk_gather(qs, points, cand, ok, k)
    return ref.batch_score_topk_gather_ref(qs, points, cand, ok, k)


def swakde_segment_pass(cell_ts, cell_num, done, sorted_ts, seg_first,
                        seg_len, *, window: int, maxb: int, n_levels: int,
                        cap: int = 0):
    """One expiry-free closed-form commit pass over the prepared segments
    (see `ref.swakde_segment_pass_ref`) → ``(cell_ts, cell_num, done)``."""
    fn = _ic.swakde_segment_pass if use_kernel(cell_ts) \
        else ref.swakde_segment_pass_ref
    return fn(cell_ts, cell_num, done, sorted_ts, seg_first, seg_len,
              window=window, maxb=maxb, n_levels=n_levels, cap=cap)


def swakde_segment_commit(ts, num, sorted_ts, seg_code, seg_first, seg_len,
                          *, window: int, maxb: int, n_levels: int,
                          cap: int = 0):
    """The SW-AKDE commit of a prepared chunk: every hit cell drained
    through closed-form passes and written into a copy of the grid (see
    `ref.swakde_segment_commit_ref`) → ``(ts, num)``.  On the card one
    launch, counted as ``swakde_segment_pass``, with no host sync."""
    fn = _ic.swakde_segment_commit if use_kernel(ts) \
        else ref.swakde_segment_commit_ref
    return fn(ts, num, sorted_ts, seg_code, seg_first, seg_len,
              window=window, maxb=maxb, n_levels=n_levels, cap=cap)


def sann_table_scatter(tables, table_ptr, s_l, s_c, rank, val, mask):
    """Sorted-segment ring append into the S-ANN hash tables, **in place**
    on ``tables`` (see `ref.sann_table_scatter_ref`); returns ``tables``."""
    fn = _ic.sann_table_scatter if use_kernel(tables) \
        else ref.sann_table_scatter_ref
    return fn(tables, table_ptr, s_l, s_c, rank, val, mask)


def sann_table_commit(tables, table_ptr, s_l, s_c, rank, val, mask,
                      write_ptr, n_kept, capacity: int, rows_per_tenant=None):
    """The S-ANN commit's table update: tombstone the ids of the slots
    recycled this chunk, then the ring append (see
    `ref.sann_table_commit_ref`) → new tables; ``tables`` is not modified.
    ``write_ptr`` / ``n_kept`` hold one entry per tenant of a stacked fleet
    whose tenants own ``rows_per_tenant`` table rows each (default: one
    tenant, scalars allowed)."""
    fn = _ic.sann_table_commit if use_kernel(tables) \
        else ref.sann_table_commit_ref
    return fn(tables, table_ptr, s_l, s_c, rank, val, mask, write_ptr,
              n_kept, capacity, rows_per_tenant)


def sketch_decode_attn(q, k, v, block_ids, n_live, kv_len,
                       block_size: int = 512, softcap: float = 0.0):
    """Sketch-pruned decode attention over the first ``n_live`` entries of
    ``block_ids`` (see `_sda.sketch_decode_attn` for the shapes, batched or
    the reference's unbatched form) → fp32 of ``q``'s shape.  On the CPU the
    live list becomes a block mask for `ref.sketch_decode_attn_ref`."""
    if use_kernel(k):
        return _sda.sketch_decode_attn(q, k, v, block_ids, n_live, kv_len,
                                       block_size, softcap)
    batched = block_ids.dim() == 2
    live = _sda.block_mask(block_ids if batched else block_ids[None], n_live,
                           k.shape[-3] // block_size)
    return ref.sketch_decode_attn_ref(q, k, v, live if batched else live[0],
                                      kv_len, block_size, softcap)


def sketch_decode_attn_partial(q, k, v, block_ids, n_live, kv_len: int,
                               block_size: int = 512, softcap: float = 0.0):
    """`sketch_decode_attn` over one rank's block of a sequence split over a
    mesh, un-merged (batched shapes; ids and ``kv_len`` local to the block)
    → ``(o, lse)`` for `parallel.sharding.merge_partials` (see
    `_sda.sketch_decode_attn_partial`).  On the CPU the live list becomes a
    block mask for `ref.sketch_decode_attn_partial_ref`."""
    if use_kernel(k):
        return _sda.sketch_decode_attn_partial(q, k, v, block_ids, n_live,
                                               kv_len, block_size, softcap)
    live = _sda.block_mask(block_ids, n_live, k.shape[1] // block_size)
    return ref.sketch_decode_attn_partial_ref(q, k, v, live, kv_len,
                                              block_size, softcap)
