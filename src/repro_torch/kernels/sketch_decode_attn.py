"""CUDA kernel: sketch-pruned flash-decode attention over the live KV blocks
(``csrc/sketch_decode_attn.cu``), and the live-block lists it reads.

Replaces the reference's Pallas ``sketch_decode_attn``
(``kernels/sketch_decode_attn.py``), which walks one request's live list as
a sequential grid axis.  Here the list is split over thread blocks, each
streaming its share through a ring of cp.async tiles, and a second launch
combines the splits; see the source note for the bound and the design.
One call launches both kernels and counts as one launch in
``LAUNCHES["sketch_decode_attn"]``.  `sketch_decode_attn_partial` is the
entry of a rank that holds one block of a sequence split over a mesh: the
same kernels, the combine also writing the log-sum-exp, so the ranks'
results merge (`parallel.sharding.merge_partials`).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build
from ..core.util import fp32_reciprocal

TILE = 32              # kTile in csrc/sketch_decode_attn.cu
MAX_G = 8              # kMaxG
MAX_DH = 512           # kMaxDh
MAX_SPLIT = 256
BLOCKS_PER_SM = 1      # kBlocksPerSm: resident blocks an SM at dh 256


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def default_n_split(B: int, Hkv: int, nb_max: int, block_size: int,
                    n_sms: int) -> int:
    """Splits per (request, KV head): as many thread blocks as fit at once
    (``BLOCKS_PER_SM`` on every SM, so no second wave), at most one a tile
    of the longest list."""
    tiles = nb_max * -(-block_size // TILE)
    want = BLOCKS_PER_SM * n_sms // max(B * Hkv, 1)
    return max(1, min(want, tiles, MAX_SPLIT))


def sketch_decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       block_ids: torch.Tensor, n_live: torch.Tensor, kv_len,
                       block_size: int = 512,
                       softcap: float = 0.0) -> torch.Tensor:
    """``q (B, Hkv, G, dh)`` fp32|bf16, ``k``/``v (B, S, Hkv, dh)`` bf16|fp32,
    ``block_ids (B, nb_max)`` int32 (-1 padded), ``n_live (B,)`` int32 and
    ``kv_len`` (an int) → ``(B, Hkv, G, dh)`` fp32.  The reference's
    unbatched form (``q (Hkv, G, dh)``, ``k (S, Hkv, dh)``, ``block_ids
    (nb_max,)``, ``n_live (1,)``) gives ``(Hkv, G, dh)``; a ``kv_len``
    tensor is read back to the host there.  The split count is
    `default_n_split`'s."""
    if q.dim() == 3:
        return sketch_decode_attn(q[None], k[None], v[None], block_ids[None],
                                  n_live.reshape(1), kv_len, block_size,
                                  softcap)[0]
    return _launch(q, k, v, block_ids, n_live, kv_len, block_size, softcap,
                   with_lse=False)[0]


def sketch_decode_attn_partial(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, block_ids: torch.Tensor,
                               n_live: torch.Tensor, kv_len: int,
                               block_size: int = 512, softcap: float = 0.0):
    """The kernel over one rank's block of the cache's sequence, un-merged
    (batched shapes of `sketch_decode_attn`; ``block_ids`` and ``kv_len``
    local to the block) → ``(o (B, Hkv, G, dh), lse (B, Hkv, G))`` fp32:
    the normalised output (zeros where nothing is live) and its
    log-sum-exp (-inf there), the partial that
    `parallel.sharding.merge_partials` combines across ranks.  The same
    two launches, the combine writing ``lse`` beside ``o``; one launch
    counted."""
    return _launch(q, k, v, block_ids, n_live, kv_len, block_size, softcap,
                   with_lse=True)


def _launch(q, k, v, block_ids, n_live, kv_len, block_size: int,
            softcap: float, with_lse: bool):
    if isinstance(kv_len, torch.Tensor):
        kv_len = int(kv_len.reshape(-1)[0])
    B, Hkv, G, dh = q.shape
    S = k.shape[1]
    nb_max = block_ids.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sketch_decode_attn q: expected fp32 or bf16, got {q.dtype}")
    if k.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sketch_decode_attn k: expected bf16 or fp32, got {k.dtype}")
    _build.check("sketch_decode_attn q", q, q.dtype, (B, Hkv, G, dh))
    _build.check_all("sketch_decode_attn", {"k": k, "v": v}, k.dtype,
                     (B, S, Hkv, dh), device=q.device)
    _build.check("sketch_decode_attn block_ids", block_ids, torch.int32,
                 (B, nb_max), device=q.device)
    _build.check("sketch_decode_attn n_live", n_live, torch.int32, (B,),
                 device=q.device)
    if not (1 <= G <= MAX_G and 1 <= dh <= MAX_DH):
        raise ValueError(f"sketch_decode_attn: need G <= {MAX_G} and dh <= "
                         f"{MAX_DH}, got G={G}, dh={dh}")
    if block_size < 1 or S % block_size:
        raise ValueError(f"sketch_decode_attn: S={S} is not a multiple of "
                         f"block_size={block_size}")
    dev = q.device
    n_split = default_n_split(B, Hkv, nb_max, block_size, _n_sms(dev.index))
    out = torch.empty((B, Hkv, G, dh), dtype=torch.float32, device=dev)
    lse = torch.empty((B, Hkv, G), dtype=torch.float32, device=dev) \
        if with_lse else None
    if B * Hkv == 0:
        return out, lse
    # one scratch tensor: the splits' accumulators, then their (m, l)
    n_acc = B * Hkv * n_split * G * dh
    scratch = torch.empty(n_acc + B * Hkv * n_split * G * 2,
                          dtype=torch.float32, device=dev)
    softcap = float(softcap)
    inv_softcap = fp32_reciprocal(softcap) if softcap > 0.0 else 0.0
    args = (q, k, v, block_ids, n_live, scratch[n_acc:], scratch, out)
    scalars = (B, Hkv, G, dh, S, nb_max, kv_len, block_size, n_split,
               int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
               dh ** -0.5, softcap, inv_softcap)
    if with_lse:
        _build.launch("sketch_decode_attn", "sketch_decode_attn_lse_launch",
                      *args, lse, *scalars)
    else:
        _build.launch("sketch_decode_attn", "sketch_decode_attn_launch",
                      *args, *scalars)
    return out, lse


def compact_live(live: torch.Tensor):
    """``live (B, nb)`` bool → ``(block_ids (B, nb) int32, n_live (B,) int32)``:
    each row's live block ids in ascending order, then -1 (the reference's
    stable compaction, batched; no host wait)."""
    order = torch.argsort((~live).to(torch.uint8), dim=1, stable=True)
    ids = torch.where(torch.gather(live, 1, order), order, -1)
    return ids.to(torch.int32), live.sum(1, dtype=torch.int32)


def block_mask(block_ids: torch.Tensor, n_live: torch.Tensor, nb: int):
    """The inverse of `compact_live`: ``block_ids (B, nb_max)`` and
    ``n_live (B,)`` → ``(B, nb)`` bool; entries at or past ``n_live``, and
    -1s, mark nothing."""
    dev = block_ids.device
    take = torch.arange(block_ids.shape[1], device=dev) < n_live.reshape(-1, 1)
    take &= block_ids >= 0
    live = torch.zeros((block_ids.shape[0], nb + 1), dtype=torch.bool, device=dev)
    live.scatter_(1, torch.where(take, block_ids.long(), nb), True)  # rest → col nb
    return live[:, :nb]


def live_blocks_from_sketch(q_sig: torch.Tensor, block_sigs: torch.Tensor,
                            kv_len, block_size: int, min_match: int,
                            current: Optional[int] = None):
    """Sketch pruning decision: a block is live iff at least ``min_match``
    of the query's set signature bits are present in the block signature
    (or it is block ``current``, which the decode step always keeps) AND
    the block intersects ``[0, kv_len)``.  ``q_sig (bits,)``, ``block_sigs
    (num_blocks, bits)`` bool → ``(block_ids (num_blocks,)`` int32 padded
    with -1, ``n_live (1,)`` int32); batched, ``q_sig (B, bits)`` and
    ``block_sigs (B, num_blocks, bits)`` → ``(B, num_blocks)``, ``(B,)``."""
    if q_sig.dim() == 1:
        ids, n_live = live_blocks_from_sketch(q_sig[None], block_sigs[None],
                                              kv_len, block_size, min_match,
                                              current)
        return ids[0], n_live
    blk = torch.arange(block_sigs.shape[1], device=block_sigs.device)
    live = (block_sigs & q_sig[:, None, :]).sum(-1) >= min_match
    if current is not None:
        live |= blk == current
    return compact_live(live & (blk * block_size < kv_len))
