"""CUDA kernels of the two-phase ingest commit.

* ``swakde_segment_pass`` (``csrc/swakde_segment_pass.cu``) replaces the
  reference's Pallas ``ingest_commit.swakde_segment_pass``: one warp per
  (row, segment) runs the closed-form DGIM cascade settle, lane j owning
  ring slots j, j + 32, ... (any number of EH slots: a cell that fits in
  a block's shared memory stays there, a larger one lives in a global
  scratch slice per warp, `swakde_cell_form`).
* ``swakde_segment_commit`` (the same source and device code) is the
  SW-AKDE commit of a chunk: each warp reads its hit cell from the state
  grid, runs passes until its segment is drained, and writes the settled
  cell into a copy of the grid, with no check on the host between passes.
  It counts as one ``swakde_segment_pass`` launch.
* ``sann_table_scatter`` (``csrc/sann_table_scatter.cu``) replaces the
  reference's Pallas ``ingest_commit.sann_table_scatter`` and its O(L·E)
  serial walk: one thread per append entry, updating ``tables`` in place.
* ``sann_table_commit`` (the same source) is the S-ANN commit's table
  update: the tombstone pass of the commit fused into one vectorised copy
  of the old tables, then the ring append into the copy.  It counts as one
  ``sann_table_scatter`` launch.  A stacked fleet's tables (T tenants of
  ``rows_per_tenant`` rows each, one write pointer and kept count per
  tenant) commit in the same single launch.

See the source notes for each kernel's bound and design.
"""
from __future__ import annotations

import torch

from . import _build

SMEM_LIMIT = 232_448    # bytes of shared memory one block may use (H100)


def swakde_cell_bytes(levels: int, slots: int) -> int:
    """Memory one warp's cell takes in ``csrc/swakde_segment_pass.cu``
    (``warp_cell_ints``): ``levels * 34`` ints up to 32 slots, else
    ``levels * (S_pad + 2) + 3 * S_pad`` with ``S_pad = 32 * ceil(S / 32)``."""
    if slots <= 32:
        return 4 * levels * 34
    s_pad = 32 * -(-slots // 32)
    return 4 * (levels * (s_pad + 2) + 3 * s_pad)


def swakde_cell_form(levels: int, slots: int) -> str:
    """Where the kernel keeps a warp's cell: ``"registers"`` (up to 32
    slots: the ring in shared memory, the carried prefix in a register),
    ``"shared"`` (more slots, the cell fits in the shared memory a block may
    use) or ``"global"`` (a larger cell, in a scratch slice of its own)."""
    if slots <= 32:
        return "registers"
    return "shared" if swakde_cell_bytes(levels, slots) <= SMEM_LIMIT \
        else "global"


def _cell_scratch(cells: int, levels: int, slots: int, device):
    """The global form's scratch (one cell slice per (row, segment)), from
    the caching allocator, or None when the cell fits in shared memory."""
    if swakde_cell_form(levels, slots) != "global":
        return None
    return torch.empty(cells * swakde_cell_bytes(levels, slots) // 4,
                       dtype=torch.int32, device=device)


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
    _build.check("swakde_segment_pass cell_num", cell_num, i32, (R, G, LV),
                 device=cell_ts.device)
    _build.check("swakde_segment_pass done", done, i32, (R, G),
                 device=cell_ts.device)
    _build.check("swakde_segment_pass sorted_ts", sorted_ts, i32, (R, C),
                 device=cell_ts.device)
    _build.check("swakde_segment_pass seg_first", seg_first, i32, (R, G),
                 device=cell_ts.device)
    _build.check("swakde_segment_pass seg_len", seg_len, i32, (R, G),
                 device=cell_ts.device)
    if R * G == 0:
        return cell_ts.clone(), cell_num.clone(), done.clone()
    ts_out = torch.empty_like(cell_ts)
    num_out = torch.empty_like(cell_num)
    done_out = torch.empty_like(done)
    scratch = _cell_scratch(R * G, LV, S, cell_ts.device)
    _build.launch("swakde_segment_pass", "swakde_segment_pass_launch",
                  cell_ts, cell_num, done, sorted_ts, seg_first, seg_len,
                  ts_out, num_out, done_out, scratch,
                  R, G, LV, S, C, window, maxb, n_levels, cap)
    return ts_out, num_out, done_out


def swakde_segment_commit(ts, num, sorted_ts, seg_code, seg_first, seg_len,
                          *, window: int, maxb: int, n_levels: int,
                          cap: int = 0):
    """The SW-AKDE commit of a prepared chunk (contract:
    `ref.swakde_segment_commit_ref`) → new ``(ts, num)`` grids; the inputs
    are not modified."""
    L, W, LV, S = ts.shape
    C = sorted_ts.shape[1]
    G = seg_code.shape[1]
    i32 = torch.int32
    _build.check("swakde_segment_commit ts", ts, i32, (L, W, LV, S))
    _build.check("swakde_segment_commit num", num, i32, (L, W, LV),
                 device=ts.device)
    _build.check("swakde_segment_commit sorted_ts", sorted_ts, i32, (L, C),
                 device=ts.device)
    _build.check_all("swakde_segment_commit",
                     {"seg_code": seg_code, "seg_first": seg_first,
                      "seg_len": seg_len}, i32, (L, G), device=ts.device)
    ts_out, num_out = ts.clone(), num.clone()
    if L * G:
        _build.launch("swakde_segment_pass", "swakde_segment_commit_launch",
                      ts, num, sorted_ts, seg_code, seg_first, seg_len,
                      ts_out, num_out, _cell_scratch(L * G, LV, S, ts.device),
                      L, G, W, LV, S, C, window, maxb, n_levels, cap)
    return ts_out, num_out


def _check_entries(name, tables, table_ptr, s_l, s_c, rank, val, mask):
    L, NB, cap = tables.shape
    E = s_l.shape[0]
    _build.check(f"{name} tables", tables, torch.int32, (L, NB, cap))
    _build.check(f"{name} table_ptr", table_ptr, torch.int32, (L, NB),
                 device=tables.device)
    _build.check_all(name, {"s_l": s_l, "s_c": s_c, "rank": rank, "val": val},
                     torch.int32, (E,), device=tables.device)
    _build.check(f"{name} mask", mask, torch.bool, (E,), device=tables.device)
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


def tenant_rows(tables, write_ptr, rows_per_tenant) -> tuple:
    """``(T, rows_per_tenant)`` of a commit over ``tables (T * R, NB, cap)``
    with ``write_ptr`` of T entries (a 0-d pointer is one tenant)."""
    rows = tables.shape[0]
    R = rows if rows_per_tenant is None else int(rows_per_tenant)
    if R < 1 or rows % R:
        raise ValueError(f"sann_table_commit: {rows} table rows are not a "
                         f"whole number of tenants of {R} rows")
    T = rows // R
    if write_ptr.numel() != T:
        raise ValueError(f"sann_table_commit: {write_ptr.numel()} write "
                         f"pointers for {T} tenants")
    return T, R


def sann_table_commit(tables, table_ptr, s_l, s_c, rank, val, mask,
                      write_ptr, n_kept, capacity: int,
                      rows_per_tenant=None):
    """The S-ANN commit's table update (contract:
    `ref.sann_table_commit_ref`) → new tables; ``tables`` is not modified.
    ``write_ptr`` and ``n_kept`` are int32 tensors on the card, one entry
    per tenant (a 0-d scalar for one sketch); row ``r`` of ``tables``
    belongs to tenant ``r // rows_per_tenant`` (default: every row to one
    tenant).  One launch whatever the number of tenants."""
    L, NB, cap, E = _check_entries("sann_table_commit", tables, table_ptr,
                                   s_l, s_c, rank, val, mask)
    T, R = tenant_rows(tables, write_ptr, rows_per_tenant)
    _build.check_all("sann_table_commit", {"write_ptr": write_ptr.reshape(T),
                                           "n_kept": n_kept.reshape(T)},
                     torch.int32, (T,), device=tables.device)
    if capacity < 1:
        raise ValueError(f"sann_table_commit: capacity {capacity} < 1")
    if tables.data_ptr() % 16:
        raise ValueError("sann_table_commit: tables must be 16-byte aligned")
    out = torch.empty_like(tables)
    _build.launch("sann_table_scatter", "sann_table_commit_launch",
                  tables, out, table_ptr, s_l, s_c, rank, val, mask,
                  write_ptr, n_kept, E, L, NB, cap, capacity, R)
    return out
