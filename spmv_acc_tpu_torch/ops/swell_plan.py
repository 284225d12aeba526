"""Analyze pass for the swell (Sliced-Window ELL) SpMV kernel, laid out for a GPU.

The slab decomposition is the JAX package's (``spmv_acc_tpu/ops/swell_plan.py``
``build_swell_plan`` up to its ``_finish_swell_plan`` call), with the same
results nnz by nnz:

* each 128-row **row-block**'s nnz are greedily clustered by column into
  **window instances**: a window opens at the first uncovered column c and claims
  every block nnz with col < 128*(c>>7) + 256 (128 when c's aligned slot is the
  last of its 16384-col chunk), so an in-window index fits a uint8;
* each instance is split at slot 128 and sliced into **layers** whose depths are
  the binary decomposition of its max per-row count (5 -> 4 + 1);
* a **slab** is one layer: depth D = 2^k slots x 128 lanes, lane = row in block.

A global column shift ``delta`` (scored on a block sample) aligns the dominant
block phase to a window start, and sparse (out-window, x-chunk) cells may spill
to a COO tail under the reference's economic rule, so tails match too.

The same decomposition runs on a BSR node pattern (``ops.bsr_block``): values
of shape ``(nnzb, r*r)``, one r x r cell block per node nnz.  As in the
reference, such a plan never spills to a tail.

What the TPU did next (step packing, one-hot scatter tables, out-tile copies,
the cost model) is replaced by :func:`build_swell_layout`: slabs grouped by
row-block, each stored slot-major at a flat offset, ``[off + slot*128 + lane]``,
which a CUDA thread block reads coalesced, and by :func:`build_swell_schedule`,
which cuts each row-block's slot rows into chunks of at most
``SWELL_CHUNK_ROWS // r``, one thread block each.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np

from ..config import LANES  # rows per row-block

__all__ = ["SwellSlabs", "SwellLayout", "ChunkSchedule", "SWELL_CHUNK_ROWS", "swell_slabs",
           "build_swell_layout", "build_swell_schedule", "chunk_schedule"]

CW = 128             # columns per window
CHUNK_W = 128        # windows per x-chunk (chunk = 16384 columns)
ROUT = 128           # row-blocks per TPU output window; only the spill rule reads it

# Most slot rows one thread block of the swell kernel walks in a scalar plan;
# an r x r plan (r*r cells a slot) takes SWELL_CHUNK_ROWS // r.  A row-block
# with more is cut into chunks of at most that many; each writes an FP64
# partial and a fix-up pass adds them in chunk order.  No corpus main-path
# matrix has a row-block past 50 (boneS10) or 33 (af23560); Ga41As41H72-SPD has
# one of 9,742.  Set from the chunk-cap sweep on an H100 (PERF.md): at r = 1,
# 64 was best or near it on Ga41As41H72-SPD and TSOPF_RS_b2383 and leaves
# boneS10 unsplit (32 splits it and costs 8-64 %); at r = 4, TSOPF_RS_b2383
# was fastest near 16.
SWELL_CHUNK_ROWS = 64


@dataclasses.dataclass
class SwellSlabs:
    """The slab decomposition: per kept nnz, which slab/slot/lane it occupies and
    its in-window index; per slab, its row-block, window base and layer k."""

    rows: int
    cols: int
    nnz: int                   # total nnz, kernel + tail
    delta: int                 # column phase shift: window w covers cols 128*w - delta + [0, 256)
    nchunks: int               # ceil((n + delta) / 16384)
    slab_of_nnz: np.ndarray    # (nkept,) int64
    lidx: np.ndarray           # (nkept,) uint8 — col + delta - 128*slab_w
    slot_in_slab: np.ndarray   # (nkept,) int64, < 2^k
    lane: np.ndarray           # (nkept,) int64 — row & 127
    values: np.ndarray         # (nkept,) or (nkept, r*r) BSR cells, source dtype
    slab_rb: np.ndarray        # (nslabs,) int64
    slab_w: np.ndarray         # (nslabs,) int64
    slab_k: np.ndarray         # (nslabs,) int64 — depth = 2^k
    tail_rows: np.ndarray      # (tnnz,) int32 — COO tail of spilled cells, row-sorted
    tail_ci: np.ndarray        # (tnnz,) int32
    tail_v: np.ndarray         # (tnnz,) source dtype

    @property
    def r(self) -> int:
        """Micro-block size: 1 for scalar values, r for (nnzb, r*r) cells."""
        return 1 if self.values.ndim == 1 else int(round(self.values.shape[1] ** 0.5))

    @property
    def padded_slots(self) -> int:
        """Slots the layout will hold, sum of 128 * 2^k over slabs; each holds r*r values."""
        return int((np.int64(LANES) << self.slab_k.astype(np.int64)).sum())


@dataclasses.dataclass
class SwellLayout:
    """Slabs laid out for the Hopper swell kernel (host numpy arrays; ``ops.swell``
    moves them to the device).

    Slab s of row-block rb (``rb_slab_ptr[rb] <= s < rb_slab_ptr[rb+1]``) holds
    ``2**slab_log2d[s]`` slots of 128 lanes; slot t of lane l sits at
    ``p = slab_off[s] + t*128 + l`` in ``lidx`` and multiplies its r x r cells
    by rows ``c*r .. c*r+r-1`` of x, ``c = slab_col_base[s] + lidx[p]``, into
    rows ``(rb*128 + l)*r + i``.  Cell (i, j) of slot p sits at
    ``vals[((p - l)*r*r + i*r + j)*128 + l]``: each 128-slot row stores its
    cells as r*r lane-contiguous planes (for r = 1, ``vals[p]``).  Rows and
    columns count nodes (r rows or columns each); padded slots are zeros."""

    rows: int
    cols: int
    r: int
    nnz: int                   # total nnz, kernel + tail (node nnz for r > 1)
    delta: int                 # the slabs' column phase shift (node columns)
    nchunks: int               # x chunks of 16384 node columns, ceil((cols + delta) / 16384)
    vals: np.ndarray           # (slots*r*r,) source dtype
    lidx: np.ndarray           # (slots,) uint8
    slab_off: np.ndarray       # (nslabs,) int64
    slab_log2d: np.ndarray     # (nslabs,) int8
    slab_col_base: np.ndarray  # (nslabs,) int32 = 128*slab_w - delta
    rb_slab_ptr: np.ndarray    # (mrb+1,) int64
    tail_rows: np.ndarray      # (tnnz,) int32
    tail_ci: np.ndarray        # (tnnz,) int32
    tail_v: np.ndarray         # (tnnz,)
    kernel_nnz: int
    fill: float                # kernel nnz / padded slots

    @property
    def slots(self) -> int:
        return int(self.vals.shape[0])

    @property
    def nslabs(self) -> int:
        return int(self.slab_off.shape[0])

    @property
    def mrb(self) -> int:
        return int(self.rb_slab_ptr.shape[0]) - 1


@dataclasses.dataclass(frozen=True)
class ChunkSchedule:
    """The work split of a layout's row-blocks over kernel thread blocks.

    Chunk c walks units ``[ptr[c], ptr[c+1])`` of row-block ``rb[c]`` in layout
    order: slot rows of the swell layout, tile blocks of the tile layout.  A
    row-block's chunks are consecutive and cover its units once; a row-block
    without units has one empty chunk, which writes zeros.  ``part[c]`` is -1
    for a row-block's only chunk, which stores y itself, else the chunk's FP64
    partial slot: the partials of split row-block ``split_rb[i]`` are the
    slots ``split_ptr[i] .. split_ptr[i+1] - 1``, in chunk order, and a fix-up
    pass adds them in that order.  ``slab[c]`` (swell only, else empty) is the
    slab holding the chunk's first slot row, and ``slab[nchunks]`` the slab
    count, so a row-block's only chunk walks the slabs ``slab[c] ..
    slab[c+1] - 1``."""

    max_rows: int
    ptr: np.ndarray        # (nchunks+1,) int64
    rb: np.ndarray         # (nchunks,) int64
    part: np.ndarray       # (nchunks,) int64
    split_rb: np.ndarray   # (nsplit,) int64
    split_ptr: np.ndarray  # (nsplit+1,) int64
    slab: np.ndarray       # (nchunks+1,) int64, or (0,)

    @property
    def nchunks(self) -> int:
        return len(self.rb)

    @property
    def nsplit(self) -> int:
        return len(self.split_rb)

    @property
    def nparts(self) -> int:
        return int(self.split_ptr[-1])

    def packed(self) -> np.ndarray:
        """The arrays as the kernels read them, one int64 array:
        ``ptr | rb | part | split_ptr | split_rb | slab``."""
        return np.concatenate([self.ptr, self.rb, self.part, self.split_ptr, self.split_rb,
                               self.slab]).astype(np.int64)


def chunk_schedule(max_rows: int, ptr, rb, mrb: int, slab=None) -> ChunkSchedule:
    """The :class:`ChunkSchedule` of chunks given by their unit pointer ``ptr``
    and row-block ``rb`` (chunks in layout order): partial slots for the
    chunks of row-blocks cut in more than one, in chunk order."""
    rb = np.asarray(rb, dtype=np.int64)
    nch = np.bincount(rb, minlength=mrb)
    split = nch > 1
    in_split = split[rb]
    part = np.full(len(rb), -1, dtype=np.int64)
    part[in_split] = np.arange(int(in_split.sum()), dtype=np.int64)
    split_ptr = np.zeros(int(split.sum()) + 1, dtype=np.int64)
    np.cumsum(nch[split], out=split_ptr[1:])
    return ChunkSchedule(
        max_rows=int(max_rows), ptr=np.asarray(ptr, dtype=np.int64), rb=rb, part=part,
        split_rb=np.flatnonzero(split).astype(np.int64), split_ptr=split_ptr,
        slab=np.zeros(0, np.int64) if slab is None else np.asarray(slab, dtype=np.int64))


def _greedy_windows(cb, bb):
    """Greedy unaligned window clustering over block-sorted (bb, cb) nnz.

    Returns (w_sorted, inst_sorted, inst_rb, inst_w, n_inst): per-nnz window base
    and instance id (in the sorted order), plus per-instance row-block and base.
    """
    nnz = len(cb)
    blk_new = np.empty(nnz, dtype=bool)
    blk_new[0] = True
    np.not_equal(bb[1:], bb[:-1], out=blk_new[1:])
    blk_start = np.flatnonzero(blk_new)
    blk_end = np.concatenate([blk_start[1:], [nnz]])
    KB = np.int64(1) << 36  # > any column bound
    key_sorted = bb * KB + cb
    w_sorted = np.empty(nnz, dtype=np.int64)
    inst_sorted = np.empty(nnz, dtype=np.int64)
    inst_rb_parts: List[np.ndarray] = []
    inst_w_parts: List[np.ndarray] = []
    ptr = blk_start.copy()
    n_inst = 0
    while True:
        act = np.flatnonzero(ptr < blk_end)
        if len(act) == 0:
            break
        p0 = ptr[act]
        c0 = cb[p0]
        w = c0 >> 7
        width = np.where((w & 127) == 127, 128, 256)
        bound = (w << 7) + width
        new_ptr = np.searchsorted(key_sorted, bb[p0] * KB + bound)
        lens = new_ptr - p0
        total = int(lens.sum())
        pos = np.repeat(p0, lens) + (
            np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(lens) - lens, lens)
        )
        w_sorted[pos] = np.repeat(w, lens)
        inst_sorted[pos] = n_inst + np.repeat(np.arange(len(act), dtype=np.int64), lens)
        inst_rb_parts.append(bb[p0])
        inst_w_parts.append(w)
        n_inst += len(act)
        ptr[act] = new_ptr
    return (w_sorted, inst_sorted, np.concatenate(inst_rb_parts),
            np.concatenate(inst_w_parts), n_inst)


def _cluster_score(cb, bb, rows_bc) -> int:
    """Padded-slot count (sum of per-instance max row counts) for a candidate
    clustering — the delta-selection objective, evaluated on a block sample."""
    _, inst, _, _, _ = _greedy_windows(cb, bb)
    key = inst * (np.int64(rows_bc.max()) + 2) + rows_bc
    ks = np.sort(key)
    new = np.empty(len(ks), dtype=bool)
    new[0] = True
    np.not_equal(ks[1:], ks[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    cnt = np.diff(np.concatenate([starts, [len(ks)]]))
    inst_of_run = ks[starts] // (np.int64(rows_bc.max()) + 2)
    order = np.argsort(inst_of_run, kind="stable")
    _, ifirst = np.unique(inst_of_run[order], return_index=True)
    return int(np.maximum.reduceat(cnt[order], ifirst).sum())


def _canonicalize(rp, ci, v, m):
    """Sort each row's columns and sum duplicates.  The slab encodings (uint8
    slot and in-window index, <= 256 nnz per (row, window)) require per-row
    sorted UNIQUE columns, so malformed input is repaired here rather than
    silently corrupting the plan."""
    nnz = int(rp[-1])
    if nnz == 0:
        return rp, ci, v
    row_start = np.zeros(nnz, dtype=bool)
    row_start[rp[1:-1][rp[1:-1] < nnz]] = True
    bad = (ci[1:] <= ci[:-1]) & ~row_start[1:]
    if not bad.any():
        return rp, ci, v
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    order = np.lexsort((ci, rows))
    rs, cs, vs = rows[order], ci[order], v[order]
    key_new = np.ones(nnz, dtype=bool)
    key_new[1:] = (rs[1:] != rs[:-1]) | (cs[1:] != cs[:-1])
    starts = np.flatnonzero(key_new)
    uid = np.cumsum(key_new) - 1
    v2 = np.zeros((len(starts),) + v.shape[1:], dtype=np.float64)
    np.add.at(v2, uid, vs.astype(np.float64))
    r2, c2 = rs[starts], cs[starts]
    rp2 = np.zeros(m + 1, dtype=np.int64)
    np.add.at(rp2, r2 + 1, 1)
    np.cumsum(rp2, out=rp2)
    return rp2, c2, v2.astype(v.dtype)


def _choose_delta(rp, ci, rows, rb, m) -> int:
    """Column phase shift: the mode of the blocks' first-column phase, kept only
    if it beats 0 on a block sample (so the shift never hurts)."""
    rp_blocks = rp[np.minimum(np.arange(0, m + 128, 128), m)]
    blk_start_all = rp_blocks[:-1]
    blk_end_all = rp_blocks[1:]
    nonempty = blk_start_all < blk_end_all
    ne_start = blk_start_all[nonempty]
    ne_end = blk_end_all[nonempty]
    phases = (ci[ne_start] & 127).astype(np.int64)
    cand = {0, int((128 - np.bincount(phases, minlength=128).argmax()) & 127)}
    if len(cand) == 1:
        return 0
    nblocks = len(ne_start)
    stride = max(1, nblocks // 384)
    sb = np.arange(0, nblocks, stride)
    lens_s = ne_end[sb] - ne_start[sb]
    idx_s = np.repeat(ne_start[sb], lens_s) + (
        np.arange(int(lens_s.sum()), dtype=np.int64)
        - np.repeat(np.cumsum(lens_s) - lens_s, lens_s)
    )
    bb_s = rb[idx_s]
    order_s = np.lexsort((ci[idx_s], bb_s))
    cb_s = ci[idx_s][order_s]
    bb_s = bb_s[order_s]
    rows_s = rows[idx_s][order_s]
    best = None
    for d in sorted(cand):
        sc = _cluster_score(cb_s + d, bb_s, rows_s)
        if best is None or sc < best[0]:
            best = (sc, d)
    return best[1]


def _spill_mask(rb, ci, delta, tile_rb, nchunks):
    """The JAX package's economic COO-tail rule: spill whole (out-window,
    x-chunk) cells holding fewer than SPMV_TPU_SPILL nnz.  Unset means AUTO
    (threshold 16, only when >= 64 such cells hold <= 2% of the nnz); 0 means
    never.  Returns a per-nnz bool mask or None."""
    spill_env = os.environ.get("SPMV_TPU_SPILL")
    spill_thr = -1 if spill_env is None else int(spill_env)
    if spill_thr == 0:
        return None
    out_of = (rb // tile_rb).astype(np.int64)
    chunk_of = (ci + delta) >> 14  # CW * CHUNK_W = 16384
    cell = out_of * np.int64(nchunks) + chunk_of
    _, inv_c, cnt_c = np.unique(cell, return_inverse=True, return_counts=True)
    if spill_thr < 0:
        sparse_c = cnt_c < 16
        nsc = int(sparse_c.sum())
        frac = float(cnt_c[sparse_c].sum()) / max(len(ci), 1)
        spill_thr = 16 if (nsc >= 64 and frac <= 0.02) else 0
    spill = cnt_c[inv_c] < spill_thr
    return spill if spill_thr > 0 and spill.any() else None


def _numpy_analyze(ci, rows, rb, nnz, delta):
    """The portable slab decomposition (equal to the native pass's, nnz by nnz).
    Returns (slab_of_nnz, lidx, slot_in_slab, slab_rb, slab_w, slab_k)."""
    order_bc = np.lexsort((ci, rb))
    cb = ci[order_bc] + delta
    bb = rb[order_bc]
    w_sorted, inst_sorted, inst_rb, inst_w, n_inst = _greedy_windows(cb, bb)
    w_of = np.empty(nnz, dtype=np.int64)
    w_of[order_bc] = w_sorted
    inst_of = np.empty(nnz, dtype=np.int64)
    inst_of[order_bc] = inst_sorted
    lc = (ci + delta - (w_of << 7)).astype(np.uint8)  # in-window index, [0, 256)

    # slot within (row, instance): instances partition each row's sorted columns
    # into disjoint ascending ranges -> consecutive CSR runs
    key_rw = rows * np.int64(n_inst + 1) + inst_of
    new_rw = np.empty(nnz, dtype=bool)
    new_rw[0] = True
    np.not_equal(key_rw[1:], key_rw[:-1], out=new_rw[1:])
    rw_start = np.flatnonzero(new_rw)
    rw_id = np.cumsum(new_rw) - 1
    slot_rw = np.arange(nnz, dtype=np.int64) - rw_start[rw_id]

    # split instances at slot 128 so every layer depth stays <= 128
    half = slot_rw >> 7
    gid = inst_of * 2 + half
    s = slot_rw & 127

    # per-group max count (group runs = sub-runs of (row, instance) runs)
    key_rw2 = key_rw * 2 + half
    new2 = np.empty(nnz, dtype=bool)
    new2[0] = True
    np.not_equal(key_rw2[1:], key_rw2[:-1], out=new2[1:])
    rw_start2 = np.flatnonzero(new2)
    rw_gid = gid[rw_start2]
    rw_sizes = np.diff(np.concatenate([rw_start2, [nnz]]))
    order_g = np.argsort(rw_gid, kind="stable")
    g_sorted = rw_gid[order_g]
    c_sorted = rw_sizes[order_g]
    gid_uniq, g_first = np.unique(g_sorted, return_index=True)
    maxc = np.maximum.reduceat(c_sorted, g_first)  # per unique gid, <= 128
    M = maxc[np.searchsorted(gid_uniq, gid)]

    # per-nnz layer bit k: largest set bit k of maxc with (maxc >> k << k) > slot
    layer_k = np.full(nnz, -1, dtype=np.int8)
    for k in range(7, -1, -1):
        pref = (M >> (k + 1)) << (k + 1)  # sum of bits above k
        hit = (layer_k < 0) & (((M >> k) & 1) == 1) & (s >= pref) & (s < pref + (1 << k))
        layer_k[hit] = k
    if (layer_k < 0).any():
        raise RuntimeError("swell layer assignment incomplete")
    lk = layer_k.astype(np.int64)
    slot_in_slab = s - ((M >> (lk + 1)) << (lk + 1))

    # slab enumeration: unique (gid, k)
    slab_uniq, slab_of_nnz = np.unique(gid * 8 + lk, return_inverse=True)
    slab_gid = slab_uniq // 8
    slab_k = slab_uniq % 8
    return (slab_of_nnz.reshape(-1), lc, slot_in_slab,
            inst_rb[slab_gid >> 1], inst_w[slab_gid >> 1], slab_k)


def swell_slabs(row_ptr, col_idx, values, shape) -> SwellSlabs:
    """The slab decomposition of a CSR matrix, or of a BSR node pattern with
    (nnzb, r*r) values (host numpy).  Takes the native analyze pass unless
    SPMV_TPU_NO_NATIVE is set or the library is missing."""
    rp = np.asarray(row_ptr, dtype=np.int64)
    ci = np.asarray(col_idx, dtype=np.int64)
    v = np.asarray(values)
    m, n = int(shape[0]), int(shape[1])
    rp, ci, v = _canonicalize(rp, ci, v, m)
    nnz = int(rp[-1])
    mrb = max(1, -(-m // LANES))
    copies = 1
    while copies < 8 and mrb * copies < ROUT:
        copies *= 2
    tile_rb = ROUT // copies
    nout = max(1, -(-mrb // tile_rb))
    nchunks = max(1, -(-n // (CW * CHUNK_W)))
    i64 = np.zeros(0, np.int64)
    empty = dict(slab_of_nnz=i64, lidx=np.zeros(0, np.uint8), slot_in_slab=i64,
                 lane=i64, values=v[:0], slab_rb=i64, slab_w=i64, slab_k=i64)
    tail = (np.zeros(0, np.int32), np.zeros(0, np.int32), v[:0])
    if nnz == 0:
        return SwellSlabs(m, n, 0, 0, nchunks, **empty,
                          tail_rows=tail[0], tail_ci=tail[1], tail_v=tail[2])

    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    rb = rows >> 7
    delta = _choose_delta(rp, ci, rows, rb, m)
    nchunks = max(nchunks, -(-(n + delta) // (CW * CHUNK_W)))

    # the reference spills scalar plans only (swell_plan.py:294)
    spill = _spill_mask(rb, ci, delta, tile_rb, nchunks) if v.ndim == 1 else None
    if spill is not None:
        tail = (rows[spill].astype(np.int32), ci[spill].astype(np.int32), v[spill])
        keep = ~spill
        rp = np.concatenate([[0], np.cumsum(np.bincount(rows[keep], minlength=m))]
                            ).astype(np.int64)
        ci, v, rows = ci[keep], v[keep], rows[keep]
        rb = rows >> 7
    nkept = int(rp[-1])
    if nkept == 0:
        return SwellSlabs(m, n, nnz, delta, nchunks, **empty,
                          tail_rows=tail[0], tail_ci=tail[1], tail_v=tail[2])

    nat = None
    if not os.environ.get("SPMV_TPU_NO_NATIVE"):
        from ..io.native import swell_analyze_native

        nat = swell_analyze_native(rp, ci, m, delta)
    if nat is not None:
        s32, lc, slot_u8, _, srb, sw, sk8, _ = nat
        dec = (s32.astype(np.int64), lc, slot_u8.astype(np.int64),
               srb.astype(np.int64), sw.astype(np.int64), sk8.astype(np.int64))
    else:
        dec = _numpy_analyze(ci, rows, rb, nkept, delta)
    slab_of_nnz, lc, slot_in_slab, slab_rb, slab_w, slab_k = dec
    return SwellSlabs(
        m, n, nnz, delta, nchunks,
        slab_of_nnz=slab_of_nnz, lidx=lc, slot_in_slab=slot_in_slab,
        lane=rows & 127, values=v, slab_rb=slab_rb, slab_w=slab_w, slab_k=slab_k,
        tail_rows=tail[0], tail_ci=tail[1], tail_v=tail[2],
    )


def build_swell_layout(sl: SwellSlabs) -> SwellLayout:
    """Lay the slabs out for the GPU kernel: grouped by row-block in a fixed
    order (row-block, window, deeper layer first), each slab slot-major at a flat
    offset, zero-padded, values in the source dtype."""
    r = sl.r
    if r > 1 and len(sl.tail_v):
        raise ValueError("a BSR swell plan has no COO tail")
    mrb = max(1, -(-sl.rows // LANES))
    order = np.lexsort((-sl.slab_k, sl.slab_w, sl.slab_rb))
    nslabs = len(order)
    new_id = np.empty(nslabs, dtype=np.int64)
    new_id[order] = np.arange(nslabs, dtype=np.int64)
    k = sl.slab_k[order]
    size = np.int64(LANES) << k
    off = np.zeros(nslabs, dtype=np.int64)
    if nslabs:
        np.cumsum(size[:-1], out=off[1:])
    slots = int(size.sum())
    pos = off[new_id[sl.slab_of_nnz]] + sl.slot_in_slab * LANES + sl.lane
    lane = pos % LANES
    cell0 = (pos - lane) * (r * r) + lane  # cell q of the slot at cell0 + q*128
    vals = np.zeros(slots * r * r, dtype=sl.values.dtype)
    vals[cell0[:, None] + np.arange(r * r) * LANES] = sl.values.reshape(len(pos), r * r)
    lidx = np.zeros(slots, dtype=np.uint8)
    lidx[pos] = sl.lidx
    rb_slab_ptr = np.zeros(mrb + 1, dtype=np.int64)
    np.cumsum(np.bincount(sl.slab_rb, minlength=mrb), out=rb_slab_ptr[1:])
    kernel_nnz = int(len(sl.values))
    return SwellLayout(
        rows=sl.rows, cols=sl.cols, r=r, nnz=sl.nnz, delta=sl.delta, nchunks=sl.nchunks,
        vals=vals, lidx=lidx,
        slab_off=off, slab_log2d=k.astype(np.int8),
        slab_col_base=(sl.slab_w[order] * CW - sl.delta).astype(np.int32),
        rb_slab_ptr=rb_slab_ptr,
        tail_rows=sl.tail_rows, tail_ci=sl.tail_ci, tail_v=sl.tail_v,
        kernel_nnz=kernel_nnz, fill=kernel_nnz / slots if slots else 1.0,
    )


def build_swell_schedule(layout, max_rows: int | None = None) -> ChunkSchedule:
    """Cut every row-block of ``layout`` (anything with ``r`` and with
    ``slab_off``, ``slab_log2d`` and ``rb_slab_ptr`` arrays, as
    :class:`SwellLayout`) into chunks of at most ``max_rows`` slot rows
    (default ``max(1, SWELL_CHUNK_ROWS // r)``).
    Row-block rb owns slot rows ``slab_off[s0] // 128 .. slab_off[s1] // 128``,
    ``s0, s1 = rb_slab_ptr[rb], rb_slab_ptr[rb + 1]``; a cut may fall inside a
    slab."""
    max_rows = max(1, SWELL_CHUNK_ROWS // layout.r) if max_rows is None else int(max_rows)
    if max_rows < 1:
        raise ValueError(f"max_rows must be at least 1, got {max_rows}")
    srow = np.asarray(layout.slab_off, dtype=np.int64) // LANES  # first slot row of each slab
    depth = np.int64(1) << np.asarray(layout.slab_log2d, dtype=np.int64)
    rb_slab_ptr = np.asarray(layout.rb_slab_ptr, dtype=np.int64)
    mrb = len(rb_slab_ptr) - 1
    row_of = np.append(srow, srow[-1] + depth[-1] if len(srow) else 0)  # slab -> first row
    rb_row = row_of[rb_slab_ptr]                                          # (mrb+1,)
    nch = np.maximum(1, -(-np.diff(rb_row) // max_rows))
    rb = np.repeat(np.arange(mrb, dtype=np.int64), nch)
    j = np.arange(len(rb), dtype=np.int64) - np.repeat(np.cumsum(nch) - nch, nch)
    first = rb_row[rb] + j * max_rows
    slab = np.where(first < rb_row[rb + 1], np.searchsorted(srow, first, side="right") - 1,
                    rb_slab_ptr[rb])
    return chunk_schedule(max_rows, np.append(first, rb_row[-1]), rb, mrb,
                          np.append(slab, len(srow)))
