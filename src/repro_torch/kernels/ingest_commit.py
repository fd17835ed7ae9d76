"""CUDA kernels of the two-phase ingest commit.

* ``swakde_segment_pass`` (``csrc/swakde_segment_pass.cu``) replaces the
  reference's Pallas ``ingest_commit.swakde_segment_pass``: one thread per
  (row, segment) runs the closed-form DGIM cascade settle as scalar code.
* ``sann_table_scatter`` (``csrc/sann_table_scatter.cu``) replaces the
  reference's Pallas ``ingest_commit.sann_table_scatter`` and its O(L·E)
  serial walk: one thread per append entry, updating ``tables`` in place.
* ``sann_table_commit`` (the same source) is the S-ANN commit's table
  update: the tombstone pass of the commit fused into one vectorised copy
  of the old tables, then the ring append into the copy.  It counts as one
  ``sann_table_scatter`` launch.

See the source notes for each kernel's bound and design.
"""
from __future__ import annotations

import torch

from . import _build

MAX_SLOTS = 32          # kMaxSlots in csrc/swakde_segment_pass.cu


def swakde_segment_pass(cell_ts, cell_num, done, sorted_ts, seg_first,
                        seg_len, *, window: int, maxb: int, n_levels: int,
                        cap: int = 0):
    """One expiry-free closed-form commit pass (contract:
    `ref.swakde_segment_pass_ref`) → new ``(cell_ts, cell_num, done)``;
    the inputs are not modified."""
    R, G, LV, S = cell_ts.shape
    C = sorted_ts.shape[1]
    i32 = torch.int32
    _build.check("swakde_segment_pass cell_ts", cell_ts, i32, (R, G, LV, S))
    _build.check("swakde_segment_pass cell_num", cell_num, i32, (R, G, LV))
    _build.check("swakde_segment_pass done", done, i32, (R, G))
    _build.check("swakde_segment_pass sorted_ts", sorted_ts, i32, (R, C))
    _build.check("swakde_segment_pass seg_first", seg_first, i32, (R, G))
    _build.check("swakde_segment_pass seg_len", seg_len, i32, (R, G))
    if S > MAX_SLOTS:
        raise ValueError(f"swakde_segment_pass: slots {S} > {MAX_SLOTS}")
    if R * G == 0:
        return cell_ts.clone(), cell_num.clone(), done.clone()
    ts_out = torch.empty_like(cell_ts)
    num_out = torch.empty_like(cell_num)
    done_out = torch.empty_like(done)
    _build.launch("swakde_segment_pass", "swakde_segment_pass_launch",
                  cell_ts, cell_num, done, sorted_ts, seg_first, seg_len,
                  ts_out, num_out, done_out,
                  R, G, LV, S, C, window, maxb, n_levels, cap)
    return ts_out, num_out, done_out


def _check_entries(name, tables, table_ptr, s_l, s_c, rank, val, mask):
    L, NB, cap = tables.shape
    E = s_l.shape[0]
    _build.check(f"{name} tables", tables, torch.int32, (L, NB, cap))
    _build.check(f"{name} table_ptr", table_ptr, torch.int32, (L, NB))
    _build.check_all(name, {"s_l": s_l, "s_c": s_c, "rank": rank, "val": val},
                     torch.int32, (E,))
    _build.check(f"{name} mask", mask, torch.bool, (E,))
    return L, NB, cap, E


def sann_table_scatter(tables, table_ptr, s_l, s_c, rank, val, mask):
    """Sorted-segment ring append into ``tables`` **in place** (contract:
    `ref.sann_table_scatter_ref`); returns ``tables``."""
    L, NB, cap, E = _check_entries("sann_table_scatter", tables, table_ptr,
                                   s_l, s_c, rank, val, mask)
    if E and cap:
        _build.launch("sann_table_scatter", "sann_table_scatter_launch",
                      tables, table_ptr, s_l, s_c, rank, val, mask,
                      E, L, NB, cap)
    return tables


def sann_table_commit(tables, table_ptr, s_l, s_c, rank, val, mask,
                      write_ptr, n_kept, capacity: int):
    """The S-ANN commit's table update (contract:
    `ref.sann_table_commit_ref`) → new tables; ``tables`` is not modified.
    ``write_ptr`` and ``n_kept`` are int32 scalars on the card."""
    L, NB, cap, E = _check_entries("sann_table_commit", tables, table_ptr,
                                   s_l, s_c, rank, val, mask)
    _build.check_all("sann_table_commit", {"write_ptr": write_ptr.reshape(1),
                                           "n_kept": n_kept.reshape(1)},
                     torch.int32, (1,))
    if capacity < 1:
        raise ValueError(f"sann_table_commit: capacity {capacity} < 1")
    if tables.data_ptr() % 16:
        raise ValueError("sann_table_commit: tables must be 16-byte aligned")
    out = torch.empty_like(tables)
    _build.launch("sann_table_scatter", "sann_table_commit_launch",
                  tables, out, table_ptr, s_l, s_c, rank, val, mask,
                  write_ptr, n_kept, E, L, NB, cap, capacity)
    return out
