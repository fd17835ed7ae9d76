"""Exponential Histograms [DGIM02] in fixed-shape tensors (paper §2.4).

The SW-AKDE cell: DGIM's linked-list buckets are a dense
``ts[levels, slots]`` ring of timestamps (newest-first per level) plus
per-level live counts ``num[levels]``.  Two variants, as in the reference's
``core/eh.py``:

* ``EH`` — Basic Counting over 0/1 streams (`eh_add`, `eh_step`,
  `eh_merge`, `eh_query`), with the level-scan cascade `eh_add_ref` as the
  oracle of the closed form `eh_add`;
* ``SumEH`` — increments in [0, R] per step (Corollary 4.2): `sum_eh_add`
  settles ``value`` unit adds sharing one stamp level by level in closed
  form, `sum_eh_add_ref` replays them one at a time.

Every function takes a batch of cells: ``ts (..., levels, slots)``,
``num (..., levels)``, and a clock ``t`` (an int or an int32 tensor that
broadcasts against the leading dims).  The reference vmaps one cell;
here the batch dimensions are written out, and each ``lax.scan`` over the
levels is a Python loop over levels, batched over all cells.  Each cell's
result is bit-identical to the reference's, dead ring slots included.
All timestamps are int32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .util import resolve_device

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class EHConfig:
    window: int          # N — sliding-window length (timesteps)
    k: int               # ceil(1/eps'): max k/2+1 buckets per level
    levels: int          # number of size levels (2^0 .. 2^{levels-1})
    slots: int           # per-level ring capacity = k//2 + 2

    @staticmethod
    def create(window: int, eps: float) -> "EHConfig":
        k = max(2, math.ceil(1.0 / eps))
        levels = math.ceil(math.log2(max(window, 2))) + 2
        return EHConfig(window=window, k=k, levels=levels, slots=k // 2 + 2)

    @property
    def max_buckets_per_level(self) -> int:
        return self.k // 2 + 1


class EHState(NamedTuple):
    ts: torch.Tensor    # (..., levels, slots) int32 — bucket stamps, newest-first
    num: torch.Tensor   # (..., levels) int32 — live buckets per level


def eh_init(cfg: EHConfig, device="cuda") -> EHState:
    """One empty cell on ``device`` (raises on ``"cuda"`` without a card):
    ``ts`` -1, ``num`` 0."""
    device = resolve_device(device)
    return EHState(
        ts=torch.full((cfg.levels, cfg.slots), -1, dtype=_I32, device=device),
        num=torch.zeros((cfg.levels,), dtype=_I32, device=device))


def _clock(t, like: torch.Tensor) -> torch.Tensor:
    """``t`` as an int32 tensor on ``like``'s device, shaped to broadcast
    against the cells' leading dims (``like`` is a ``num (..., levels)``)."""
    t = torch.as_tensor(t, dtype=_I32, device=like.device)
    return t.reshape(t.shape + (1,) * (like.dim() - t.dim()))[..., 0]


def _expire(state: EHState, t, cfg: EHConfig) -> EHState:
    """Drop buckets whose stamp left the window (a suffix per level)."""
    tc = _clock(t, state.num)
    idx = torch.arange(cfg.slots, device=state.ts.device)
    live = (idx < state.num[..., None]) & \
        (state.ts > (tc - cfg.window)[..., None, None])
    return EHState(ts=state.ts, num=live.sum(-1).to(_I32))


def eh_add_ref(state: EHState, t, cfg: EHConfig) -> EHState:
    """Record a 1 at time ``t`` with the level-by-level cascade: each level
    takes an optional carry from below, prepends it, and on overflow merges
    its two oldest buckets into a carry (stamped with the newer of the
    two) for the level above.  The oracle of `eh_add`."""
    ts, num = _expire(state, t, cfg)
    S = cfg.slots
    maxb = cfg.max_buckets_per_level
    in_ts = _clock(t, num).expand(num.shape[:-1]).clone()
    in_flag = torch.ones(num.shape[:-1], dtype=torch.bool, device=ts.device)
    out_ts, out_num = [], []
    for lvl in range(cfg.levels):
        row_ts, row_num = ts[..., lvl, :], num[..., lvl]
        rolled = torch.cat([in_ts[..., None], row_ts[..., :-1]], dim=-1)
        new_ts = torch.where(in_flag[..., None], rolled, row_ts)
        new_num = row_num + in_flag.to(_I32)
        overflow = (new_num > maxb) & (lvl < cfg.levels - 1)
        merged = torch.gather(new_ts, -1,
                              (new_num - 2).clamp(0, S - 1).long()[..., None])
        out_ts.append(new_ts)
        out_num.append(torch.where(overflow, new_num - 2, new_num))
        in_ts, in_flag = merged[..., 0], overflow
    return EHState(ts=torch.stack(out_ts, -2), num=torch.stack(out_num, -1))


def eh_add(state: EHState, t, cfg: EHConfig) -> EHState:
    """Record a 1 at time ``t`` — closed-form carry count, no level loop.

    The carry reaches level l iff every level below it is full; a reached
    level prepends its incoming stamp (t at level 0, above it the merged
    stamp of the level below, its pre-add ring at index num-2), and a
    reached full level drops its two oldest buckets.  Bit-identical to
    `eh_add_ref`, dead slots included."""
    ts, num = _expire(state, t, cfg)
    dev = ts.device
    S = cfg.slots
    lvl = torch.arange(cfg.levels, device=dev)
    full = (num >= cfg.max_buckets_per_level) & (lvl < cfg.levels - 1)
    blocked = torch.cumsum((~full).to(_I32), dim=-1)
    reach = torch.ones_like(full)
    reach[..., 1:] = blocked[..., :-1] == 0
    below = (num[..., :-1] - 2).clamp(0, S - 1).long()
    carry_up = torch.gather(ts[..., :-1, :], -1, below[..., None])[..., 0]
    t0 = _clock(t, num).expand(num.shape[:-1])
    carry = torch.cat([t0[..., None], carry_up], dim=-1)
    shifted = torch.cat([carry[..., None], ts[..., :-1]], dim=-1)
    fired = reach & full
    return EHState(ts=torch.where(reach[..., None], shifted, ts),
                   num=num + reach.to(_I32) - 2 * fired.to(_I32))


def eh_step(state: EHState, t, bit, cfg: EHConfig) -> EHState:
    """Add ``bit`` (0 or 1, broadcast over the cells) at time ``t``."""
    added = eh_add(state, t, cfg)
    expired = _expire(state, t, cfg)
    keep = torch.as_tensor(bit, device=state.ts.device).to(torch.bool)
    keep_n = keep.reshape(keep.shape + (1,) * (state.num.dim() - keep.dim()))
    return EHState(ts=torch.where(keep_n[..., None], added.ts, expired.ts),
                   num=torch.where(keep_n, added.num, expired.num))


def eh_query_cells(ts: torch.Tensor, num: torch.Tensor, t,
                   cfg: EHConfig) -> torch.Tensor:
    """DGIM estimate TOTAL - LAST/2 of #1s in (t - window, t] for a batch of
    cells: ``ts (..., levels, slots)``, ``num (..., levels)`` → ``(...)``
    float32, bit-identical per cell to the reference's `eh_query_cells`."""
    dev = ts.device
    idx = torch.arange(cfg.slots, device=dev)
    live = (idx < num[..., None]) & \
        (ts > (_clock(t, num) - cfg.window)[..., None, None])
    sizes = (1 << torch.arange(cfg.levels, dtype=torch.int32, device=dev))[:, None]
    total = torch.where(live, sizes, 0).sum(dim=(-2, -1))
    # Oldest live bucket = the live bucket at the highest level.
    has = live.any(dim=-1)
    lvl = torch.arange(cfg.levels, device=dev)
    last_level = torch.where(has, lvl, -1).amax(dim=-1)
    last = torch.where(last_level >= 0, 1 << last_level.clamp(min=0), 0)
    est = total - last // 2
    return torch.clamp(est, min=0).float()


def eh_query(state: EHState, t, cfg: EHConfig) -> torch.Tensor:
    """DGIM estimate of #1s in (t - window, t] per cell."""
    return eh_query_cells(state.ts, state.num, t, cfg)


def eh_merge(a: EHState, b: EHState, t, cfg: EHConfig) -> EHState:
    """Merge two EHs over disjoint sub-streams sharing one clock: both are
    expired at ``t``, then per level (bottom-up) the union of A's, B's and
    the carried-up buckets is sorted newest-first and the oldest pairs
    merge into the next level, each carrying up the pair's newer stamp.
    Commutative bit for bit; the top level never merges and keeps at most
    ``slots`` buckets."""
    a = _expire(a, t, cfg)
    b = _expire(b, t, cfg)
    S = cfg.slots
    C = 2 * S                                    # carry capacity
    pool_len = 2 * S + C
    maxb = cfg.max_buckets_per_level
    dev = a.ts.device
    iota_s = torch.arange(S, dtype=_I32, device=dev)
    iota_c = torch.arange(C, dtype=_I32, device=dev)
    lead = a.num.shape[:-1]
    c_ts = torch.full(lead + (C,), -1, dtype=_I32, device=dev)
    c_n = torch.zeros(lead, dtype=_I32, device=dev)
    out_ts, out_num = [], []
    for lvl in range(cfg.levels):
        a_n, b_n = a.num[..., lvl], b.num[..., lvl]
        pool = torch.cat([
            torch.where(iota_s < a_n[..., None], a.ts[..., lvl, :], -1),
            torch.where(iota_s < b_n[..., None], b.ts[..., lvl, :], -1),
            torch.where(iota_c < c_n[..., None], c_ts, -1)], dim=-1)
        s = torch.sort(pool, dim=-1, descending=True).values  # newest first
        count = a_n + b_n + c_n
        m = torch.where((count > maxb) & (lvl < cfg.levels - 1),
                        (count - maxb + 1) // 2, 0)
        out_ts.append(s[..., :S])
        out_num.append(torch.clamp(count - 2 * m, max=S))
        idx = (count[..., None] - 2 - 2 * iota_c).clamp(0, pool_len - 1)
        c_ts = torch.where(iota_c < m[..., None],
                           torch.gather(s, -1, idx.long()), -1)
        c_n = m
    return EHState(ts=torch.stack(out_ts, -2), num=torch.stack(out_num, -1))


def eh_exact_upper(cfg: EHConfig) -> int:
    """Worst-case live buckets — the paper's space bound
    (k/2+1)(log(2N/k)+1)+1."""
    return (cfg.k // 2 + 1) * (int(math.log2(max(2 * cfg.window / cfg.k, 2))) + 2)


# ---------------------------------------------------------------------------
# SumEH — batch updates (Corollary 4.2): per-step increments in [0, R]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SumEHConfig:
    base: EHConfig
    batch_max: int    # R — max increment per timestep

    @staticmethod
    def create(window: int, eps: float, batch_max: int) -> "SumEHConfig":
        k = max(2, math.ceil(1.0 / eps))
        levels = math.ceil(math.log2(max(window * batch_max, 2))) + 2
        base = EHConfig(window=window, k=k, levels=levels, slots=k // 2 + 2)
        return SumEHConfig(base=base, batch_max=batch_max)

    @property
    def max_buckets(self) -> int:
        return self.base.levels * self.base.slots


SumEHState = EHState  # identical dense layout


def sum_eh_init(cfg: SumEHConfig, device="cuda") -> SumEHState:
    return eh_init(cfg.base, device)


def _where_state(cond: torch.Tensor, a: EHState, b: EHState) -> EHState:
    """Per cell ``a if cond else b``; ``cond`` has the cells' leading shape."""
    return EHState(ts=torch.where(cond[..., None, None], a.ts, b.ts),
                   num=torch.where(cond[..., None], a.num, b.num))


def _value(value, like: torch.Tensor) -> torch.Tensor:
    return _clock(value, like).expand(like.shape[:-1])


def sum_eh_add_ref(state: SumEHState, t, value, cfg: SumEHConfig) -> SumEHState:
    """``value`` sequential unit `eh_add`s, all stamped ``t`` (a loop of
    ``batch_max`` steps, each applied where ``i < value``): the oracle of
    `sum_eh_add`."""
    v = _value(value, state.num)
    for i in range(cfg.batch_max):
        state = _where_state(i < v, eh_add(state, t, cfg.base), state)
    return state


def sum_eh_add(state: SumEHState, t, value, cfg: SumEHConfig) -> SumEHState:
    """Add ``value`` in [0, batch_max] unit elements, all stamped ``t`` —
    closed-form cascade, O(levels · slots) independent of ``value``.

    Per level, arrivals are consumed oldest-first, so the j-th merge takes
    items 2j and 2j+1 of ``queue = reverse(live ring) ++ carried-up stamps
    ++ t, t, ...`` and carries up ``queue[2j+1]``; the level fills to
    maxb+1 once, then every second arrival fires a merge.  Carried-up stamps
    stay a (prefix of old stamps, count of trailing ``t``s) pair across
    levels.  A cell with ``value == 0`` is left untouched (expiry stays
    lazy).  Bit-identical per cell to the reference's `sum_eh_add`."""
    base = cfg.base
    maxb = base.max_buckets_per_level
    S = base.slots
    ts0, num0 = _expire(state, t, base)
    dev = ts0.device
    t32 = _clock(t, num0)[..., None]
    iota = torch.arange(S, dtype=_I32, device=dev)
    v = _value(value, num0)
    lead = num0.shape[:-1]
    pre = torch.zeros(lead + (S,), dtype=_I32, device=dev)
    npre = torch.zeros(lead, dtype=_I32, device=dev)
    r = v.to(_I32)
    out_ts, out_num = [], []
    for lvl in range(base.levels):
        row_ts, num = ts0[..., lvl, :], num0[..., lvl]
        c = npre + r
        total = num + c
        K = num + npre

        def q(i, row_ts=row_ts, num=num, pre=pre, K=K):
            """Queue lookup at indices ``i (..., S)``."""
            ring = torch.gather(row_ts, -1,
                                (num[..., None] - 1 - i).clamp(0, S - 1).long())
            pv = torch.gather(pre, -1, (i - num[..., None]).clamp(0, S - 1).long())
            return torch.where(i < num[..., None], ring,
                               torch.where(i < K[..., None], pv, t32))

        m = torch.where(total <= maxb, 0, 1 + (c - (maxb + 1 - num)) // 2)
        if lvl == base.levels - 1:                   # top level never merges
            m = torch.zeros_like(m)
        out_pre = q((2 * iota + 1).expand(lead + (S,)))
        out_npre = torch.minimum(m, K // 2)
        n_f = total - 2 * m
        out_ts.append(torch.where(iota < n_f[..., None],
                                  q(total[..., None] - 1 - iota), row_ts))
        out_num.append(n_f)
        pre, npre, r = out_pre, out_npre, m - out_npre
    new = EHState(ts=torch.stack(out_ts, -2), num=torch.stack(out_num, -1))
    return _where_state(v > 0, new, state)


def sum_eh_query(state: SumEHState, t, cfg: SumEHConfig) -> torch.Tensor:
    return eh_query(state, t, cfg.base)
