"""The ``adaptive_plus`` strategy on PyTorch: the tile plan's device layout, the
Hopper tile kernel's wrappers and their plain PyTorch version.

Counterpart of ``spmv_acc_tpu/ops/adaptive_plus.py``.  The host plan
(:mod:`.tile_plan`: (128-row x 128-column) blocks bucketed by depth W) is built
once per (matrix, dtype) and laid out for the GPU: every block's W x 128 slots
(values in the source dtype, in-window column indices as ``uint8``) stored
contiguously, the blocks sorted by (row block, bucket, column tile), a
row-block pointer over them, and a chunk schedule that cuts each row block into
runs of whole blocks of at most ``TILE_CHUNK_ROWS`` slot rows, one CUDA thread
block each (``csrc/tile_spmv.cu``).  On a CUDA tensor ``tile_spmv`` launches that
kernel; on a CPU tensor it runs ``tile_spmv_plain``, the same sum in float64
with torch gathers and ``index_add_`` over the slots in layout order.  There is
no fallback from one to the other.

Not carried over from the TPU: the grid-step packing (``_pack_bucket``: P
blocks per step plus dummy sub-blocks), the two-f32 df64 arithmetic, and the
``X_VMEM_LIMIT`` column caps, which existed because x had to fit in a TPU
core's VMEM; the H100 reads x from device memory, so any column count runs.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import numpy as np
import torch

from .swell import _device_schedule, _torch_dtype
from .swell_plan import ChunkSchedule
from .tile_plan import COL_WINDOW, LANES, TilePlan, build_tile_plan, build_tile_schedule
from .xla import axpby_finish

__all__ = ["DeviceTilePlan", "LAUNCHES", "get_tile_plan", "clear_tile_cache", "rescheduled",
           "tile_spmv", "tile_spmv_plain", "tile_spmv_f32", "tile_spmv_df64", "spmv_adaptive_plus"]

# Kernel launches in this process by dtype ("f64", "f32"), and of its fix-up
# pass (a launch whose schedule splits a row block) by (dtype, "fixup"); set to
# 0 (``.clear()``) to count a run.  Only the kernel's launch site adds to it.
LAUNCHES: collections.Counter = collections.Counter()

_DTYPES = {torch.float64: "f64", torch.float32: "f32"}


@dataclasses.dataclass
class DeviceTilePlan:
    """A :class:`TilePlan` laid out on one device for the tile kernel."""

    rows: int
    cols: int
    num_row_blocks: int
    fill_efficiency: float
    vals: torch.Tensor       # (slot rows * 128,) float64 or float32, [slot row * 128 + lane]
    lidx: torch.Tensor       # (slot rows * 128,) uint8 column in the block's window
    blk_off: torch.Tensor    # (blocks,) int64 first slot row of each block
    blk_depth: torch.Tensor  # (blocks,) int32 W
    blk_ct: torch.Tensor     # (blocks,) int32 column tile
    rb_ptr: torch.Tensor     # (num_row_blocks + 1,) int64 blocks of each row block
    schedule: ChunkSchedule  # the row blocks cut into runs of blocks (host arrays)
    sched: torch.Tensor      # schedule.packed() on the device: what the kernel reads
    # (row, column) of every slot, derived at the plain version's first use
    _plain_idx: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def slots(self) -> int:
        return int(self.vals.shape[0])

    @staticmethod
    def from_plan(plan: TilePlan, dtype: torch.dtype, device) -> "DeviceTilePlan":
        npdt = np.float64 if dtype == torch.float64 else np.float32
        bks = plan.buckets
        depth = np.concatenate([np.full(b.num_blocks, b.depth, np.int64) for b in bks]
                               or [np.zeros(0, np.int64)])
        rb = np.concatenate([b.row_block for b in bks] or [np.zeros(0, np.int32)])
        ct = np.concatenate([b.col_tile for b in bks] or [np.zeros(0, np.int32)])
        src_off = np.concatenate([[0], np.cumsum(depth)[:-1]]).astype(np.int64)
        # buckets are concatenated in depth order and sorted by (row block,
        # column tile) inside, so a stable sort on the row block gives the
        # (row block, bucket, column tile) order
        order = np.argsort(rb, kind="stable")
        depth, rb, ct, src_off = depth[order], rb[order], ct[order], src_off[order]
        blk_off = np.concatenate([[0], np.cumsum(depth)[:-1]]).astype(np.int64)
        src_rows = np.repeat(src_off - blk_off, depth) + np.arange(int(depth.sum()))
        empty = [np.zeros((0, LANES))]
        vals = np.concatenate([b.values.astype(npdt, copy=False) for b in bks] or empty)
        lidx = np.concatenate([b.local_idx.astype(np.uint8) for b in bks] or empty)
        rb_ptr = np.zeros(plan.num_row_blocks + 1, np.int64)
        np.cumsum(np.bincount(rb, minlength=plan.num_row_blocks), out=rb_ptr[1:])

        def t(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)

        return DeviceTilePlan(
            rows=plan.rows, cols=plan.cols, num_row_blocks=plan.num_row_blocks,
            fill_efficiency=plan.fill_efficiency,
            vals=t(vals[src_rows].reshape(-1), npdt),
            lidx=t(lidx[src_rows].reshape(-1), np.uint8),
            blk_off=t(blk_off, np.int64), blk_depth=t(depth, np.int32), blk_ct=t(ct, np.int32),
            rb_ptr=t(rb_ptr, np.int64), **_device_schedule(build_tile_schedule(depth, rb_ptr),
                                                           device))


def rescheduled(dp: DeviceTilePlan, max_rows: int) -> DeviceTilePlan:
    """``dp`` with its chunk schedule rebuilt for runs of at most ``max_rows``
    slot rows; every other array is shared."""
    sched = build_tile_schedule(dp.blk_depth.cpu(), dp.rb_ptr.cpu(), max_rows)
    return dataclasses.replace(dp, **_device_schedule(sched, dp.device))


# Plan cache.  Each entry holds the CSR's three tensors and is returned only when
# they are the very objects passed in, so neither a recycled id() nor a CSR that
# shares row_ptr with new values is served a stale plan.  In-place edits of a
# cached CSR's tensors are not seen: build a new CSR (or call clear_tile_cache).
_TILE_CACHE: dict = {}


def clear_tile_cache() -> None:
    _TILE_CACHE.clear()


def get_tile_plan(csr, dtype=None) -> DeviceTilePlan:
    """The tile layout of ``csr`` in ``dtype`` (default: the values' dtype,
    float64 or float32) on ``csr``'s device, built once per (matrix, dtype)."""
    tdtype = csr.values.dtype if dtype is None else _torch_dtype(dtype)
    if tdtype not in _DTYPES:
        raise ValueError(f"adaptive_plus runs float64 and float32, not {dtype}")
    key = (id(csr.row_ptr), id(csr.col_idx), id(csr.values), csr.shape, tdtype)
    hit = _TILE_CACHE.get(key)
    if (hit is not None and hit[0] is csr.row_ptr and hit[1] is csr.col_idx
            and hit[2] is csr.values):
        return hit[3]
    rp, ci, v, shape = csr.to_numpy()
    dp = DeviceTilePlan.from_plan(build_tile_plan(rp, ci, v, shape), tdtype, csr.device)
    _TILE_CACHE[key] = (csr.row_ptr, csr.col_idx, csr.values, dp)
    return dp


def _check(dp: DeviceTilePlan, x, name="tile_spmv") -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} takes a torch.Tensor, got {type(x).__name__}")
    if x.dtype != dp.dtype:
        raise ValueError(f"{name}: x is {x.dtype}, the plan {dp.dtype}")
    if x.dim() != 1 or x.shape[0] != dp.cols:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, the matrix {dp.cols} columns")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.device != dp.device:
        raise ValueError(f"{name}: x is on {x.device}, the plan on {dp.device}")


def _launch(dp: DeviceTilePlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a contiguous CUDA x: one call that launches the kernel
    and, when the schedule splits a row block, its fix-up pass."""
    from ._build import TILE_SRC, load_lib

    lib = load_lib(TILE_SRC)
    y = torch.empty(dp.rows, dtype=dp.dtype, device=x.device)
    sc = dp.schedule
    ptr = ctypes.c_void_p
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # FP64 partials of the split row blocks, on the current stream
        part = (torch.empty(sc.nparts * LANES, dtype=torch.float64, device=x.device)
                if sc.nsplit else None)
        rc = lib.tile_spmv(
            int(dp.dtype == torch.float64), ptr(dp.vals.data_ptr()), ptr(dp.lidx.data_ptr()),
            ptr(dp.blk_off.data_ptr()), ptr(dp.blk_depth.data_ptr()),
            ptr(dp.blk_ct.data_ptr()), ptr(dp.sched.data_ptr()), sc.nchunks, sc.nsplit,
            None if part is None else ptr(part.data_ptr()), ptr(x.data_ptr()),
            ptr(y.data_ptr()), dp.rows, dp.cols, ptr(stream))
    if rc != 0:
        raise RuntimeError(f"tile kernel launch failed: CUDA error {rc}")
    LAUNCHES[_DTYPES[dp.dtype]] += 1
    if sc.nsplit:
        LAUNCHES[(_DTYPES[dp.dtype], "fixup")] += 1
    return y


def _plain(dp: DeviceTilePlan, x: torch.Tensor) -> torch.Tensor:
    if dp._plain_idx is None:
        dev = dp.device
        blk = torch.repeat_interleave(torch.arange(dp.blk_depth.numel(), device=dev),
                                      dp.blk_depth.long() * LANES)
        rb = torch.repeat_interleave(torch.arange(dp.num_row_blocks, device=dev),
                                     torch.diff(dp.rb_ptr))
        lane = torch.arange(dp.slots, device=dev) % LANES
        row = rb[blk] * LANES + lane
        col = dp.blk_ct.long()[blk] * COL_WINDOW + dp.lidx.long()
        dp._plain_idx = (row, col)
    row, col = dp._plain_idx
    xp = torch.zeros(max(1, -(-dp.cols // COL_WINDOW)) * COL_WINDOW, dtype=torch.float64,
                     device=x.device)
    xp[: dp.cols] = x.double()
    y = torch.zeros(dp.num_row_blocks * LANES, dtype=torch.float64, device=x.device)
    y.index_add_(0, row, dp.vals.double() * xp[col])
    return y[: dp.rows].to(dp.dtype)


def tile_spmv_plain(dp: DeviceTilePlan, x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: the same A@x, (m,), as products of
    every slot with its x element (0 past n), summed in float64 by
    ``index_add_`` in layout order and cast to the plan's dtype.  The CPU path
    of ``tile_spmv`` and the kernel's reference."""
    _check(dp, x, "tile_spmv_plain")
    return _plain(dp, x)


def tile_spmv(dp: DeviceTilePlan, x: torch.Tensor) -> torch.Tensor:
    """A@x over the tile layout, (m,) in the plan's dtype.  Launches the Hopper
    kernel for a CUDA ``x`` and runs the plain version for a CPU ``x``; any
    other device raises."""
    _check(dp, x)
    if x.device.type == "cuda":
        return _launch(dp, x)
    if x.device.type == "cpu":
        return _plain(dp, x)
    raise NotImplementedError(f"adaptive_plus has no kernel for device {x.device}")


def tile_spmv_f32(dp: DeviceTilePlan, x: torch.Tensor) -> torch.Tensor:
    """A@x of a float32 plan, (m,) float32 (K-h's counterpart; sums in FP64,
    rounded once)."""
    if dp.dtype != torch.float32:
        raise ValueError(f"tile_spmv_f32 takes a float32 plan, got {dp.dtype}")
    return tile_spmv(dp, x)


def tile_spmv_df64(dp: DeviceTilePlan, x: torch.Tensor) -> torch.Tensor:
    """A@x of a float64 plan, (m,) float64 (K-g's counterpart).  Computes in
    native FP64: the H100 has an FP64 unit, so the TPU's two-f32 df64 words are
    not needed; the name is the reference's."""
    if dp.dtype != torch.float64:
        raise ValueError(f"tile_spmv_df64 takes a float64 plan, got {dp.dtype}")
    return tile_spmv(dp, x)


def spmv_adaptive_plus(alpha, beta, csr, x, y, plan=None):
    """Full strategy entry (dispatch contract): y_out = alpha*A@x + beta*y."""
    return axpby_finish(alpha, beta, tile_spmv(get_tile_plan(csr), x), y)
