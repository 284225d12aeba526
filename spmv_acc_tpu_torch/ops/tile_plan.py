"""Analyze pass of the ``adaptive_plus`` strategy: the (128-row x 128-column)
window decomposition.

The same function as the JAX package's ``spmv_acc_tpu/ops/tile_plan.py`` (the
csr_adaptive_plus_analyze.cpp:12-98 analog), array for array: the matrix is
cut into blocks of 128 rows by 128 columns; inside a block a row is a lane and
its k-th element in the window is slot k, so a block holds ``W x 128`` slots,
W its deepest row's count.  Blocks are bucketed by W rounded up to a power of
two (``BUCKETS``; a row holds at most 128 elements of one window, so W <= 128)
and each bucket's blocks are sorted by (row block, column tile).  The native
C++ pass (``io/native.py::tile_analyze_native``) and the numpy branch give the
same plan.  The device layout built from it is in :mod:`.adaptive_plus`;
:func:`build_tile_schedule` cuts its row blocks into chunks of whole blocks,
one CUDA thread block each.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .swell_plan import ChunkSchedule, chunk_schedule

__all__ = ["LANES", "COL_WINDOW", "BUCKETS", "TILE_CHUNK_ROWS", "TileBucket", "TilePlan",
           "build_tile_plan", "build_tile_schedule"]

LANES = 128  # rows per block
COL_WINDOW = 128  # columns per block
# Padded depths: a block of depth w goes to the first bucket >= w.
BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
# Most slot rows (sum of block depths) one thread block of the tile kernel
# walks, unless a single block is deeper: a chunk always holds a whole block.
# Set from the chunk-cap sweep on an H100 (PERF.md): TSOPF_RS_b2383 was
# fastest at 256, and boneS10 (~88 slot rows a row block) is not split there.
TILE_CHUNK_ROWS = 256


@dataclasses.dataclass(frozen=True)
class TileBucket:
    """All blocks of one padded depth W, sorted by (row block, column tile)."""

    depth: int  # W
    num_blocks: int
    values: np.ndarray  # (num_blocks * W, 128): slot rows of each block, lane = row % 128
    local_idx: np.ndarray  # (num_blocks * W, 128) int32, column % 128, in [0, 128)
    col_tile: np.ndarray  # (num_blocks,) int32: x window id
    row_block: np.ndarray  # (num_blocks,) int32: y block id
    flush: np.ndarray  # (num_blocks,) int32: 1 on the last block of its row block
    nnz: int  # real elements in this bucket


@dataclasses.dataclass(frozen=True)
class TilePlan:
    buckets: Tuple[TileBucket, ...]
    num_row_blocks: int
    num_col_tiles: int
    rows: int
    cols: int
    nnz: int
    fill_efficiency: float  # real elements / padded slots
    touched: Dict[int, np.ndarray]  # depth -> (num_row_blocks,) bool: blocks of that bucket


def build_tile_plan(row_ptr, col_idx, values, shape) -> TilePlan:
    """The tile plan of a CSR matrix whose rows are column-sorted."""
    rp = np.asarray(row_ptr).astype(np.int64)
    ci = np.asarray(col_idx).astype(np.int64)
    v = np.asarray(values)
    m, n = shape
    nnz = int(rp[-1])
    mrb = max(1, -(-m // LANES))
    nct = max(1, -(-n // COL_WINDOW))

    if nnz == 0:
        return TilePlan((), mrb, nct, m, n, 0, 1.0, {})

    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    lane = rows % LANES
    lc = (ci % COL_WINDOW).astype(np.int32)

    from ..io.native import tile_analyze_native

    native = tile_analyze_native(rp, ci, m, nct)
    if native is not None:
        block_key, slot, blk_uniq, depth = native
        slot = slot.astype(np.int64)
    else:
        rb = rows // LANES
        ct = ci // COL_WINDOW
        # slot within the (row, column tile) run: rows are column-sorted, so a
        # run's elements are consecutive
        key_rc = rows * nct + ct
        new_group = np.concatenate(([True], key_rc[1:] != key_rc[:-1]))
        group_id = np.cumsum(new_group) - 1
        group_start = np.flatnonzero(new_group)
        slot = np.arange(nnz, dtype=np.int64) - group_start[group_id]
        # a block's depth: its longest run
        block_key = rb * nct + ct
        group_sizes = np.diff(np.concatenate([group_start, [nnz]]))
        group_block = block_key[group_start]
        order = np.argsort(group_block, kind="stable")
        blk_uniq, blk_first = np.unique(group_block[order], return_index=True)
        depth = np.maximum.reduceat(group_sizes[order], blk_first)
    bidx = np.minimum(np.searchsorted(BUCKETS, depth), len(BUCKETS) - 1)
    bucket = np.asarray(BUCKETS, dtype=np.int64)[bidx]

    elem_bucket = bucket[np.searchsorted(blk_uniq, block_key)]

    buckets: List[TileBucket] = []
    touched: Dict[int, np.ndarray] = {}
    padded_total = 0
    for b in BUCKETS:
        sel_blocks = np.flatnonzero(bucket == b)
        if len(sel_blocks) == 0:
            continue
        bkeys = blk_uniq[sel_blocks]  # sorted: by (row block, column tile)
        rb_arr = (bkeys // nct).astype(np.int32)
        ct_arr = (bkeys % nct).astype(np.int32)
        nb = len(bkeys)
        vals_slab = np.zeros((nb * b, LANES), dtype=v.dtype)
        idx_slab = np.zeros((nb * b, LANES), dtype=np.int32)
        esel = np.flatnonzero(elem_bucket == b)
        srow = np.searchsorted(bkeys, block_key[esel]) * b + slot[esel]
        vals_slab[srow, lane[esel]] = v[esel]
        idx_slab[srow, lane[esel]] = lc[esel]
        flush = np.concatenate([(rb_arr[1:] != rb_arr[:-1]), [True]]).astype(np.int32)
        tmask = np.zeros(mrb, dtype=bool)
        tmask[rb_arr] = True
        touched[b] = tmask
        buckets.append(TileBucket(depth=b, num_blocks=nb, values=vals_slab, local_idx=idx_slab,
                                  col_tile=ct_arr, row_block=rb_arr, flush=flush,
                                  nnz=len(esel)))
        padded_total += nb * b * LANES

    return TilePlan(buckets=tuple(buckets), num_row_blocks=mrb, num_col_tiles=nct, rows=m,
                    cols=n, nnz=nnz, fill_efficiency=nnz / max(padded_total, 1),
                    touched=touched)


def build_tile_schedule(blk_depth, rb_ptr, max_rows: int | None = None) -> ChunkSchedule:
    """Cut the row blocks of a tile layout (blocks in row-block order, depths
    ``blk_depth``, row block rb owning blocks ``rb_ptr[rb] .. rb_ptr[rb+1]-1``)
    into runs of whole blocks, greedily from each row block's first: a run
    takes blocks while their depths sum to at most ``max_rows`` (default
    ``TILE_CHUNK_ROWS``), and always at least one."""
    max_rows = TILE_CHUNK_ROWS if max_rows is None else int(max_rows)
    if max_rows < 1:
        raise ValueError(f"max_rows must be at least 1, got {max_rows}")
    rb_ptr = np.asarray(rb_ptr, dtype=np.int64)
    mrb = len(rb_ptr) - 1
    cum = np.concatenate([[0], np.cumsum(np.asarray(blk_depth, dtype=np.int64))])
    pos, end = rb_ptr[:-1].copy(), rb_ptr[1:]
    active = np.arange(mrb, dtype=np.int64)
    starts, rbs = [pos.copy()], [active]  # every row block's first chunk
    while active.size:
        p = pos[active]
        nxt = np.searchsorted(cum, cum[p] + max_rows, side="right") - 1
        pos[active] = np.minimum(np.maximum(nxt, p + 1), end[active])
        active = active[pos[active] < end[active]]
        starts.append(pos[active])
        rbs.append(active)
    starts, rbs = np.concatenate(starts), np.concatenate(rbs)
    order = np.lexsort((starts, rbs))
    return chunk_schedule(max_rows, np.append(starts[order], cum.size - 1), rbs[order], mrb)
