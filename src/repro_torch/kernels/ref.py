"""Plain PyTorch versions of the seven CUDA kernels.

Each function is the semantic definition of its kernel (ported from the
reference's ``kernels/ref.py``).  On a CPU tensor `ops` runs these; on the
card the kernels run instead, and ``chip_smoke.py`` holds each kernel
against its plain version on the same inputs.
"""
from __future__ import annotations

import torch

from ..core.util import fp32_reciprocal

_INT32_MAX = 2**31 - 1
# Golden-ratio multiplicative constant for multiply-shift hashing.
_MIX = 2654435761
_MASK32 = 0xFFFFFFFF


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``(a * b) mod 2^32`` for int64 tensors holding values in [0, 2^32):
    the low and high 16 bits of ``a`` are multiplied separately, so no
    intermediate exceeds 2^49."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def fold(raw: torch.Tensor, mix: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Universal multiply-shift fold of ``(..., L, k)`` integer hashes →
    ``(..., L)`` int32 buckets, bit-exact to the reference's uint32 wrap.

    ``raw`` is any integer tensor; it is read as uint32 (two's complement,
    as ``astype(uint32)`` does in the reference)."""
    a = raw.to(torch.int64) & _MASK32
    acc = mul32(a, mix).sum(dim=-1) & _MASK32
    acc = mul32(acc, _MIX)
    return (acc % n_buckets).to(torch.int32)


def srp_hash_ref(x: torch.Tensor, proj: torch.Tensor, mix: torch.Tensor,
                 n_buckets: int) -> torch.Tensor:
    """``x (B, d)``, ``proj (d, L*k)``, ``mix (L, k)`` int64 holding uint32
    values → codes ``(B, L)`` int32 in [0, n_buckets): one fp32 matmul, the
    sign bits (``y >= 0``) and the uint32 fold."""
    L, k = mix.shape
    y = x.float() @ proj.float()                                 # (B, L*k)
    return fold((y >= 0).reshape(x.shape[0], L, k), mix, n_buckets)


def srp_code_flips(x: torch.Tensor, proj: torch.Tensor, mix: torch.Tensor,
                   got: torch.Tensor, want: torch.Tensor, tol: float = 1e-5):
    """The parity rule of the `srp_hash` kernel against `srp_hash_ref`:
    codes may differ only where a projection's sign is within rounding of
    0, i.e. |y| (a float64 product) <= ``tol * |x| * |proj column|`` for
    one of the code's k projections, since the kernel's fp32 sums run in
    another order.  Returns ``(flips, unexplained)``: the codes that
    differ, and of those the ones with no such projection."""
    L, k = mix.shape
    x, proj = x.double(), proj.to(x.device).double()
    y = (x @ proj).view(-1, L, k)
    scale = x.norm(dim=1)[:, None] * proj.norm(dim=0)[None, :]
    near = (y.abs() <= tol * scale.view(-1, L, k)).any(-1)
    diff = got.to(x.device) != want.to(x.device)
    return int(diff.sum()), int((diff & ~near).sum())


def cand_score_ref(q: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """``q (d,)``, ``cands (M, d)`` → squared L2 distances ``(M,)`` in fp32,
    diff-based (no matmul identity)."""
    return ((cands.float() - q.float()[None, :]) ** 2).sum(-1)


def race_update_ref(counts: torch.Tensor, codes: torch.Tensor,
                    sign: int = 1) -> torch.Tensor:
    """counts (L, W) int32, codes (B, L) → counts + sign * histogram, where
    the histogram is ``#{b : codes[b, l] = w}``.  Codes outside [0, W) are
    ignored (hashing never produces them)."""
    L, W = counts.shape
    rows = torch.arange(L, device=codes.device).expand(codes.shape)
    inside = (codes >= 0) & (codes < W)
    flat = torch.where(inside, rows * W + codes.long(), L * W).reshape(-1)
    hist = torch.zeros(L * W + 1, dtype=torch.int32, device=codes.device)
    hist.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts + sign * hist[:L * W].view(L, W)


def race_hist_ref(codes: torch.Tensor, W: int) -> torch.Tensor:
    """Per-row histogram of ``codes (B, L)`` → (L, W) int32."""
    zeros = torch.zeros((codes.shape[1], W), dtype=torch.int32,
                        device=codes.device)
    return race_update_ref(zeros, codes)


def batch_score_ref(qs: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """qs (B, d), cands (B, M, d) → squared L2 distances (B, M) in fp32,
    diff-based (no matmul identity)."""
    return ((cands.float() - qs.float()[:, None, :]) ** 2).sum(-1)


def batch_score_topk_ref(qs: torch.Tensor, cands: torch.Tensor,
                         ok: torch.Tensor, k: int):
    """Masked squared-L2 top-k per query: ``(d2 (B, k) ascending, idx (B, k)
    int32 into M)``.  Masked entries score inf; ties resolve to the lowest
    candidate index (``lax.top_k`` semantics, from a stable sort), so a
    fully masked row gives inf with idx ``0..k-1``."""
    d2 = torch.where(ok, batch_score_ref(qs, cands),
                     torch.full((), float("inf"), device=qs.device))
    vals, idx = torch.sort(d2, dim=1, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def batch_score_topk_gather_ref(qs: torch.Tensor, points: torch.Tensor,
                                cand: torch.Tensor, ok: torch.Tensor, k: int):
    """`batch_score_topk_ref` of the rows ``points[max(cand, 0)]``:
    ``cand (B, M)`` slot ids into ``points (N, d)``, ``-1`` allowed (it reads
    row 0, which ``ok`` masks in practice) → ``(d2 (B, k), idx (B, k)
    int32 into M)``."""
    return batch_score_topk_ref(qs, points[cand.clamp(min=0).long()], ok, k)


def swakde_segment_pass_ref(
    cell_ts: torch.Tensor,    # (R, G, levels, S) int32 — gathered EH rings
    cell_num: torch.Tensor,   # (R, G, levels) int32 — live buckets per level
    done: torch.Tensor,       # (R, G) int32 — arrivals already committed
    sorted_ts: torch.Tensor,  # (R, C) int32 — per-row stamps, sorted order
    seg_first: torch.Tensor,  # (R, G) int32 — first sorted position
    seg_len: torch.Tensor,    # (R, G) int32 — arrivals hitting each segment
    *,
    window: int,
    maxb: int,
    n_levels: int,
    cap: int = 0,
):
    """One closed-form, expiry-free commit pass over every (row, segment)
    pair → ``(cell_ts, cell_num, done)``; the contract of the reference's
    ``swakde_segment_pass_ref``, op for op.

    A segment is one cell's run of unit adds at ascending stamps
    ``sorted_ts[r, seg_first + done .. seg_first + seg_len)``.  The pass
    expires each active cell at its first arrival, takes the longest prefix
    of arrivals during which nothing expires (capped at ``cap`` when
    ``cap > 0``), and settles the DGIM cascade level by level in closed
    form.  Callers loop until ``done == seg_len``."""
    R, G, LV, S = cell_ts.shape
    C = sorted_ts.shape[1]
    dev = cell_ts.device
    i32 = torch.int32
    sidx = torch.arange(S, dtype=i32, device=dev)

    active = done < seg_len                                      # (R, G)
    start = seg_first + done                                     # (R, G)
    t_first = torch.gather(sorted_ts, 1, start.clamp(0, C - 1).long())

    # --- expire active cells at their first arrival ------------------------
    live = (sidx < cell_num[..., None]) & \
        (cell_ts > (t_first - window)[..., None, None])          # (R,G,LV,S)
    cell_num = torch.where(active[..., None], live.sum(-1).to(i32), cell_num)
    oldest = torch.where(live, cell_ts, _INT32_MAX).amin(dim=(-2, -1))

    # --- expiry-free pass length (both conditions select a prefix) ---------
    pos = torch.arange(C, dtype=i32, device=dev)[None, None, :]
    thr = (sorted_ts - window)[:, None, :]                       # (R, 1, C)
    in_seg = (pos >= start[..., None]) & \
        (pos < (seg_first + seg_len)[..., None])
    ok = (thr < oldest[..., None]) & (thr < t_first[..., None])
    p = (in_seg & ok).sum(-1).to(i32)                            # (R, G)
    if cap:
        p = torch.clamp(p, max=cap)
    p = torch.where(active, torch.minimum(p, seg_len - done), 0)

    # --- the per-level closed form -----------------------------------------
    sorted_b = sorted_ts[:, None, :].expand(R, G, C)

    def queue(i, ts_l, m0, P, np_, b, stride):
        """Oldest-first queue lookup: reversed live ring ++ P ++ strided
        tail of ``sorted_ts``; ``i`` (R, G, n)."""
        K = (m0 + np_)[..., None]
        ring = torch.gather(ts_l, -1, (m0[..., None] - 1 - i).clamp(0, S - 1).long())
        pre = torch.gather(P, -1, (i - m0[..., None]).clamp(0, S - 1).long())
        tpos = (b[..., None] + (i - K) * stride[..., None]).clamp(0, C - 1)
        tail = torch.gather(sorted_b, -1, tpos.long())
        return torch.where(i < m0[..., None], ring,
                           torch.where(i < K, pre, tail))

    cts = cell_ts.clone()
    cnum = cell_num.clone()
    P = torch.zeros((R, G, S), dtype=i32, device=dev)
    np_ = torch.zeros((R, G), dtype=i32, device=dev)
    b = start.clamp(0, C - 1)
    stride = torch.ones((R, G), dtype=i32, device=dev)
    r = p
    odd = (2 * sidx + 1).expand(R, G, S)
    for lvl in range(LV):
        ts_l = cts[:, :, lvl]
        m0 = cnum[:, :, lvl]
        p_l = np_ + r                                            # arrivals
        K = m0 + np_
        total = m0 + p_l
        # The level fills to maxb+1 once, then every second arrival fires a
        # merge; the top level never merges.
        mu = torch.where((total <= maxb) | (lvl == n_levels - 1), 0,
                         1 + (p_l - (maxb + 1 - m0)) // 2)
        new_num = total - 2 * mu
        arr = queue(total[..., None] - 1 - sidx, ts_l, m0, P, np_, b, stride)
        old = torch.gather(ts_l, -1,
                           (sidx - p_l[..., None]).clamp(0, S - 1).long())
        new_ts = torch.where(sidx < p_l[..., None], arr, old)
        # Merge j consumes queue[2j], queue[2j+1] and carries up the newer
        # stamp queue[2j+1]: those below K form the explicit prefix, the rest
        # a stride-doubled window into sorted_ts.
        np_n = torch.minimum(mu, K // 2)
        r_n = mu - np_n
        P_n = queue(odd, ts_l, m0, P, np_, b, stride)
        b_n = (b + (2 * np_n + 1 - K) * stride).clamp(0, C - 1)
        cts[:, :, lvl] = new_ts
        cnum[:, :, lvl] = new_num
        P, np_, b, stride, r = P_n, np_n, b_n, stride * 2, r_n
    return cts, cnum, done + p


def swakde_segment_commit_ref(
    ts: torch.Tensor,         # (L, W, levels, S) int32 — the state's EH rings
    num: torch.Tensor,        # (L, W, levels) int32 — live buckets per level
    sorted_ts: torch.Tensor,  # (L, C) int32 — per-row stamps, sorted order
    seg_code: torch.Tensor,   # (L, G) int32 — cell of each segment (W = none)
    seg_first: torch.Tensor,  # (L, G) int32 — first sorted position
    seg_len: torch.Tensor,    # (L, G) int32 — arrivals hitting each segment
    *,
    window: int,
    maxb: int,
    n_levels: int,
    cap: int = 0,
):
    """The SW-AKDE commit of a prepared chunk → new ``(ts, num)``; the
    inputs are not modified.  Gathers each segment's cell by ``seg_code``,
    runs `swakde_segment_pass_ref` until every segment is drained, and
    writes the settled cells back; sentinel segments (code ``W``) are
    dropped, as the reference's ``mode="drop"`` scatter does."""
    L, W = ts.shape[:2]
    rows = torch.arange(L, device=ts.device)[:, None].expand_as(seg_code)
    gcode = torch.clamp(seg_code, max=W - 1).long()           # clamp padding
    cell_ts, cell_num = ts[rows, gcode], num[rows, gcode]
    done = torch.zeros_like(seg_len)
    while bool((done < seg_len).any()):
        cell_ts, cell_num, done = swakde_segment_pass_ref(
            cell_ts, cell_num, done, sorted_ts, seg_first, seg_len,
            window=window, maxb=maxb, n_levels=n_levels, cap=cap)
    real = seg_code < W
    ts, num = ts.clone(), num.clone()
    ts[rows[real], seg_code[real].long()] = cell_ts[real]
    num[rows[real], seg_code[real].long()] = cell_num[real]
    return ts, num


def sann_table_scatter_ref(
    tables: torch.Tensor,     # (L, n_buckets, bucket_cap) int32, updated in place
    table_ptr: torch.Tensor,  # (L, n_buckets) int32 — per-bucket ring pointers
    s_l: torch.Tensor,        # (E,) int32 — row of each sorted append
    s_c: torch.Tensor,        # (E,) int32 — bucket code of each append
    rank: torch.Tensor,       # (E,) int32 — rank within its (row, code) run
    val: torch.Tensor,        # (E,) int32 — slot id to write (-1 tombstone)
    mask: torch.Tensor,       # (E,) bool — append lands in the final window
) -> torch.Tensor:
    """Sorted-segment ring append, in place: entry i writes ``val[i]`` at
    ring position ``(table_ptr[s_l, s_c] + rank) % bucket_cap`` (floored)
    of its bucket when ``mask[i]`` is set.  The masked entries of one bucket
    are its last ``bucket_cap`` ranks, so their positions are distinct and
    the order of the writes does not matter.  Returns ``tables``."""
    L, NB, cap = tables.shape
    s_l, s_c = s_l.long(), s_c.long()
    ring_pos = (table_ptr[s_l, s_c].long() + rank.long()) % cap
    flat = (s_l * NB + s_c) * cap + ring_pos
    tables.view(-1)[flat[mask]] = val[mask].to(tables.dtype)
    return tables


def sann_table_commit_ref(tables, table_ptr, s_l, s_c, rank, val, mask,
                          write_ptr, n_kept, capacity: int,
                          rows_per_tenant=None) -> torch.Tensor:
    """The S-ANN commit's table update → new tables (``tables`` is not
    modified): every slot id ``v >= 0`` that points at a slot recycled this
    chunk, i.e. ring offset ``(v - write_ptr) mod capacity < n_kept``, is
    tombstoned to -1 (an id at or past ``capacity`` reads the offset of slot
    ``capacity - 1``, the reference's clamped gather), then
    `sann_table_scatter_ref` appends the chunk into the result.

    A stacked fleet passes ``tables (T * R, NB, cap)`` with
    ``rows_per_tenant = R`` and ``write_ptr`` / ``n_kept`` of shape
    ``(T,)``: row ``r`` is tombstoned against tenant ``r // R``'s pointers.
    The default is one tenant (0-d or one-entry pointers)."""
    rows = tables.shape[0]
    R = rows if rows_per_tenant is None else int(rows_per_tenant)
    T = rows // R
    wp = write_ptr.reshape(T, 1)
    ring_off = (torch.arange(capacity, dtype=torch.int32,
                             device=tables.device)[None, :] - wp) % capacity
    overwritten = ring_off < n_kept.reshape(T, 1)               # (T, capacity)
    tenant = (torch.arange(rows, device=tables.device) // R)[:, None, None]
    stale = (tables >= 0) & overwritten[
        tenant, tables.clamp(0, capacity - 1).long()]
    out = torch.where(stale, -1, tables)
    return sann_table_scatter_ref(out, table_ptr, s_l, s_c, rank, val, mask)


def sketch_decode_attn_ref(
    q: torch.Tensor,            # ([B,] Hkv, G, dh) fp32 or bf16
    k: torch.Tensor,            # ([B,] S, Hkv, dh)
    v: torch.Tensor,            # ([B,] S, Hkv, dh)
    block_live: torch.Tensor,   # ([B,] num_blocks) bool — sketch-pruned blocks
    kv_len,                     # int (or 0-d / (1,) tensor) — valid positions
    block_size: int,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Masked decode attention: softmax over the positions whose block
    survives the sketch pruning and that lie below ``kv_len``, of
    ``(q . k) / sqrt(dh)`` (softcapped when ``softcap > 0``), times v.
    Returns fp32 of ``q``'s shape; a row with no position gets zeros.
    Takes the reference's unbatched form or a leading batch axis."""
    if q.dim() == 3:
        return sketch_decode_attn_ref(q[None], k[None], v[None], block_live[None],
                                      kv_len, block_size, softcap)[0]
    S, dh = k.shape[1], q.shape[-1]
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * dh ** -0.5
    if softcap and softcap > 0.0:
        scores = softcap * torch.tanh(scores * fp32_reciprocal(softcap))
    pos = torch.arange(S, device=k.device)
    live = block_live[:, pos // block_size] & (pos < kv_len)         # (B, S)
    scores = torch.where(live[:, None, None, :], scores, float("-inf"))
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    w = e / e.sum(-1, keepdim=True)
    w = torch.where(torch.isnan(w), 0.0, w)   # all-masked rows → zero output
    return torch.einsum("bhgs,bshd->bhgd", w, v.float())


def sketch_decode_attn_partial_ref(q, k, v, block_live, kv_len,
                                   block_size: int, softcap: float = 0.0):
    """`sketch_decode_attn_ref` over one rank's block of the sequence, un-
    merged: ``(o, lse)``, ``o`` the normalised output (zeros where nothing
    is live) and ``lse (B, Hkv, G)`` fp32 the log-sum-exp of its scores
    (-inf where nothing is live), for `parallel.sharding.merge_partials`.
    Batched shapes only."""
    S, dh = k.shape[1], q.shape[-1]
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * dh ** -0.5
    if softcap and softcap > 0.0:
        scores = softcap * torch.tanh(scores * fp32_reciprocal(softcap))
    pos = torch.arange(S, device=k.device)
    live = block_live[:, pos // block_size] & (pos < kv_len)         # (B, S)
    scores = torch.where(live[:, None, None, :], scores, float("-inf"))
    m = scores.amax(-1)
    e = torch.exp(scores - torch.clamp(m, min=-1e30)[..., None])
    l = e.sum(-1)
    o = torch.einsum("bhgs,bshd->bhgd", e, v.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(l), float("-inf"))
    return o, lse
