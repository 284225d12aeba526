"""The swell SpMV/SpMM strategy on PyTorch: plan caches, the Hopper kernel's
wrappers and their plain PyTorch version.

Counterpart of ``spmv_acc_tpu/ops/swell.py``.  The host plan
(:mod:`.swell_plan`) is built once per (matrix, dtype, r) in a process, or
loaded from the content-hashed disk plan cache that an earlier process wrote,
and moved to the matrix's device with its chunk schedule (row-blocks cut into
chunks of at most ``SWELL_CHUNK_ROWS // r`` slot rows, one CUDA thread block
each); ``swell_ax`` computes A@x and ``swell_amx`` A@X over it, in float64 or
float32, on a scalar plan (r = 1) or on the BSR node pattern of r x r
micro-blocks (r = 2..4, chosen by the reference's detector).  On a CUDA tensor
they launch the hand-written Hopper kernel in ``csrc/swell_spmv.cu``; on a CPU
tensor they run ``swell_amx_plain``, the same sum written with torch gathers and
``index_add_`` in float64.  There is no fallback from one to the other.  Sums
are FP64 for both dtypes, so the reference's host repair of the two-f32 and f32
cancellation floors (``_refine_cancellation``) has nothing to repair and is not
ported.

The default path reads x in its own dtype.  The JAX package's on-chip numerics
read x as bf16 planes instead (its MXU one-hot tables gather nothing else):
``prep_x`` is the counterpart of its plan method ``prep_x`` (K-d,
``_plane_split_kernel``, on a card the kernel in ``csrc/plane_split.cu``), and
``swell_ax_planes`` is A @ x~ with x~ read from those planes (the swell kernel's
plane form).  Neither is on the default path.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import os
import tempfile
import zipfile
import zlib

import numpy as np
import torch

from ..config import LANES, cache_dir
from ..formats.containers import held_by, on_replace_values
from ..utils import profiling
from .bsr_block import bsr_condense, detect_block_size
from .swell_plan import (ChunkSchedule, SwellLayout, _canonicalize, build_swell_layout,
                         build_swell_schedule, swell_slabs)
from .xla import axpby_finish

__all__ = ["DeviceSwellLayout", "SWELL_MAX_SLOTS", "LAUNCHES", "get_swell_plan", "plan_steps",
           "swell_plan_within_cap", "clear_swell_cache", "kernel_group",
           "rescheduled", "swell_ax", "swell_amx", "swell_ax_plain", "swell_amx_plain",
           "swell_sweep", "swell_sweep_plain", "value_map", "revalue", "revalue_plans",
           "in_plan_cache", "prep_x",
           "prep_x_plain", "swell_ax_planes", "swell_ax_planes_plain", "spmv_swell",
           "make_swell_run", "make_swell_amx_run"]

# Cap on the value slots of one layout (padded slots * r*r), checked on the slab
# depths before anything is allocated: 1 << 30 slots are ~9.7 GB in float64, ~25x
# the largest corpus layout (boneS10: 41,218,048 slots).  A matrix past it never
# gets a swell layout: the picker passes swell over, an explicit request raises.
SWELL_MAX_SLOTS = 1 << 30

# Kernel launches in this process: the swell kernel by (dtype, r, k), its plane
# form by (dtype, 1, 1, "planes"), its sweep store by (dtype, r, 1, "sweep"),
# their fix-up pass (a launch whose schedule splits a row-block) by (dtype, r,
# k, "fixup"), (dtype, 1, 1, "planes_fixup") and (dtype, r, 1, "sweep_fixup"),
# the plane split by (dtype, "plane_split"); set to 0 (``.clear()``) to count
# a run.  Only the kernels' launch sites add to it.
LAUNCHES: collections.Counter = collections.Counter()

_DTYPES = {torch.float64: "f64", torch.float32: "f32"}


@dataclasses.dataclass
class DeviceSwellLayout:
    """A :class:`SwellLayout` on one device (see it for the array meanings).
    ``rows``/``cols`` count nodes of r rows/columns; the matrix is
    ``out_rows`` x ``x_rows``."""

    rows: int
    cols: int
    r: int
    out_rows: int
    x_rows: int
    fill: float
    delta: int                   # column phase shift: x planes are front-padded by it
    nchunks: int                 # x chunks of 16384 node columns
    vals: torch.Tensor           # (slots*r*r,) float64 or float32
    lidx: torch.Tensor           # (slots,) uint8
    slab_off: torch.Tensor       # (nslabs,) int64
    slab_log2d: torch.Tensor     # (nslabs,) int8
    slab_col_base: torch.Tensor  # (nslabs,) int32
    rb_slab_ptr: torch.Tensor    # (mrb+1,) int64
    tail_rows: torch.Tensor      # (tnnz,) int64
    tail_ci: torch.Tensor        # (tnnz,) int64
    tail_v: torch.Tensor         # (tnnz,) value dtype
    schedule: ChunkSchedule      # the row-blocks cut into chunks (host arrays)
    sched: torch.Tensor          # schedule.packed() on the device: what the kernel reads
    # (node row, node col) of every slot, derived at the plain version's first use
    _plain_idx: tuple | None = dataclasses.field(default=None, repr=False)
    # value_map of the CSR the layout was cached for, made at its first
    # revalue_plans (() where it has none)
    _value_map: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def mrb(self) -> int:
        return int(self.rb_slab_ptr.shape[0]) - 1

    @property
    def slots(self) -> int:
        return int(self.lidx.shape[0])

    @staticmethod
    def from_host(lay: SwellLayout, device, out_rows: int, x_rows: int,
                  schedule: ChunkSchedule) -> "DeviceSwellLayout":
        """``lay`` and its ``schedule`` (``build_swell_schedule(lay)``) on ``device``."""
        def t(a, dtype=None):
            a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
            return torch.from_numpy(a).to(device)

        return DeviceSwellLayout(
            rows=lay.rows, cols=lay.cols, r=lay.r, out_rows=out_rows, x_rows=x_rows,
            fill=lay.fill, delta=lay.delta, nchunks=lay.nchunks, vals=t(lay.vals), lidx=t(lay.lidx), slab_off=t(lay.slab_off),
            slab_log2d=t(lay.slab_log2d), slab_col_base=t(lay.slab_col_base),
            rb_slab_ptr=t(lay.rb_slab_ptr), tail_rows=t(lay.tail_rows, np.int64),
            tail_ci=t(lay.tail_ci, np.int64), tail_v=t(lay.tail_v),
            **_device_schedule(schedule, device),
        )


def _device_schedule(sched: ChunkSchedule, device) -> dict:
    return {"schedule": sched, "sched": torch.from_numpy(sched.packed()).to(device)}


def rescheduled(layout: DeviceSwellLayout, max_rows: int) -> DeviceSwellLayout:
    """``layout`` with its chunk schedule rebuilt for chunks of at most
    ``max_rows`` slot rows; every other array is shared."""
    host = dataclasses.replace(layout, slab_off=layout.slab_off.cpu(),
                               slab_log2d=layout.slab_log2d.cpu(),
                               rb_slab_ptr=layout.rb_slab_ptr.cpu())
    return dataclasses.replace(
        layout, **_device_schedule(build_swell_schedule(host, max_rows), layout.device))


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float64": torch.float64, "float32": torch.float32}.get(np.dtype(dtype).name)


# Plan cache.  Each entry holds the keyed tensors themselves and is returned only
# when they are the very objects passed in, so a recycled id() can never serve
# another matrix's plan.  In-place edits of a cached CSR's tensors are not seen,
# except new values written by ``formats.containers.replace_values``, which
# calls revalue_plans (its hook).
_SWELL_CACHE: dict = {}


def clear_swell_cache() -> None:
    _SWELL_CACHE.clear()


def plan_steps(before: dict) -> dict:
    """Seconds of each plan step taken since ``before`` (a
    ``utils.profiling.spans()`` copy), by step: the steps of the plans built or
    loaded since, summed."""
    return {k[len("swell.plan."):]: st.seconds for k, st in profiling.since(before).items()
            if k.startswith("swell.plan.")}


def _timed(step: str, fn, *args):
    """``fn(*args)`` in the span ``swell.plan.<step>`` (host_copy, hash, load,
    slabs, layout, save, schedule, h2d), a child of the plan's ``swell.plan``."""
    with profiling.span("swell.plan." + step):
        return fn(*args)


def _slabs(rp, ci, v, shape, dtype: torch.dtype, r):
    """The slab decomposition of the host CSR arrays in ``dtype`` on the scalar
    pattern or, when the block size (``r``, or the reference's detector when
    None) is above 1, on the r x r node pattern (the reference's
    ``get_swell_plan``, swell.py:2037-2058)."""
    m, n = shape
    v = v.astype(np.float64 if dtype == torch.float64 else np.float32, copy=False)
    if r != 1:
        # canonicalise BEFORE condensing: bsr_condense writes each cell once, so
        # a duplicate (row, col) would drop contributions the sum must keep
        rp_c, ci_c, v_c = _canonicalize(rp.astype(np.int64), ci.astype(np.int64), v, m)
        if r is None:
            r = detect_block_size(rp_c, ci_c, (m, n))
    if r == 1:
        return swell_slabs(rp, ci, v, (m, n))
    rp_b, ci_b, vals2d = bsr_condense(rp_c, ci_c, v_c, (m, n), r)
    return swell_slabs(rp_b, ci_b, vals2d, (len(rp_b) - 1, -(-n // r)))


# ---- disk plan cache ---------------------------------------------------------
# The reference's content-hashed plan cache (swell.py:1884-1995) for the port's
# host SwellLayout: a second process on the same matrix loads the layout
# instead of rebuilding it (boneS10: a 7.6 s build).  The chunk schedule is
# rebuilt from the loaded layout, so SWELL_CHUNK_ROWS and ``rescheduled`` act
# on it as on a fresh one.  Consulted for a CSR on a CUDA device, or anywhere
# when SPMV_TPU_PLAN_CACHE is set; SPMV_TPU_NO_PLAN_CACHE turns it off.  Entries
# live in ``config.cache_dir("plans")`` under a prefix of their own, so the JAX
# package's ``plan_v*`` entries there are never read, nor these by it.
# Bump _PLAN_CACHE_ABI with every change to the layout or to what decides it
# (the slab decomposition, the spill rule, the BSR detector).
_PLAN_CACHE_ABI = 1
_LAYOUT_ARRAYS = ("vals", "lidx", "slab_off", "slab_log2d", "slab_col_base", "rb_slab_ptr",
                  "tail_rows", "tail_ci", "tail_v")


def _plan_cache_on(device) -> bool:
    if os.environ.get("SPMV_TPU_NO_PLAN_CACHE"):
        return False
    return torch.device(device).type == "cuda" or bool(os.environ.get("SPMV_TPU_PLAN_CACHE"))


def _plan_cache_path(rp, ci, v, shape, dtype: torch.dtype, r) -> str:
    """The entry of the layout of (rp, ci, v) in the plan dtype ``dtype`` for
    the requested block size ``r`` (None: the detector decides).  The key is a
    crc32 over every byte of the three arrays (a sample once served a stale
    layout for same-pattern matrices with new values, in the reference), the
    values' dtype, and the one variable that changes the layout,
    SPMV_TPU_SPILL (when set).  SPMV_TPU_NO_NATIVE is not in it: the native and
    numpy analyze passes give the same layout, array for array."""
    h = 0
    for a in (rp, ci, v):
        h = zlib.crc32(np.ascontiguousarray(a), h)
    pins = f"values={np.dtype(v.dtype).str}"
    spill = os.environ.get("SPMV_TPU_SPILL")
    if spill is not None:
        pins += f",spill={spill}"
    h = zlib.crc32(pins.encode(), h)
    name = (f"torch_swell_v{_PLAN_CACHE_ABI}_{shape[0]}x{shape[1]}_{len(ci)}_"
            f"{_DTYPES[dtype]}_r{'auto' if r is None else r}_{h:08x}.npz")
    return os.path.join(cache_dir("plans"), name)


def _plan_cache_save(path: str, lay: SwellLayout, cells: int) -> None:
    """Write the layout atomically: a temporary file in the entry's directory,
    then ``os.replace``, so racing writers of one key leave a whole entry."""
    meta = np.array([lay.rows, lay.cols, lay.r, lay.nnz, lay.delta, lay.nchunks,
                     lay.kernel_nnz, cells], dtype=np.int64)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, meta=meta, fill=np.float64(lay.fill),
                     **{name: getattr(lay, name) for name in _LAYOUT_ARRAYS})
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _plan_cache_load(path: str, dtype: torch.dtype):
    """(SwellLayout, value cells) from an entry; raises on one that does not
    hold a whole layout of ``dtype``."""
    with np.load(path, allow_pickle=False) as z:
        rows, cols, r, nnz, delta, nchunks, kernel_nnz, cells = (int(x) for x in z["meta"])
        arrays = {name: z[name] for name in _LAYOUT_ARRAYS}
        fill = float(z["fill"])
    lay = SwellLayout(rows=rows, cols=cols, r=r, nnz=nnz, delta=delta, nchunks=nchunks,
                      kernel_nnz=kernel_nnz, fill=fill, **arrays)
    nslabs = len(lay.slab_off)
    if (lay.vals.dtype != (np.float64 if dtype == torch.float64 else np.float32)
            or len(lay.vals) != len(lay.lidx) * r * r or cells != len(lay.vals)
            or len(lay.slab_log2d) != nslabs or len(lay.slab_col_base) != nslabs
            or lay.rb_slab_ptr[-1] != nslabs):
        raise ValueError(f"{path} does not hold a whole {dtype} swell layout")
    return lay, cells


def _host_layout(csr, tdtype: torch.dtype, r, device=None):
    """(host SwellLayout or None past the cap, value cells): loaded from the
    disk plan cache when it is on (for ``device``, default ``csr``'s) and holds
    the entry, else built (and saved)."""
    rp, ci, v, shape = _timed("host_copy", csr.to_numpy)
    path = _timed("hash", _plan_cache_path, rp, ci, v, shape, tdtype, r) if (
        _plan_cache_on(csr.device if device is None else device)) else None
    if path is not None and os.path.exists(path):
        try:
            lay, cells = _timed("load", _plan_cache_load, path, tdtype)
            return (lay if cells <= SWELL_MAX_SLOTS else None), cells
        except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile):
            pass  # a stale or corrupt entry is rebuilt and replaced below
    sl = _timed("slabs", _slabs, rp, ci, v, shape, tdtype, r)
    cells = sl.padded_slots * sl.r * sl.r
    if cells > SWELL_MAX_SLOTS:
        return None, cells
    lay = _timed("layout", build_swell_layout, sl)
    if path is not None:
        try:
            _timed("save", _plan_cache_save, path, lay, cells)
        except OSError:
            pass  # the cache is best-effort: a failed save leaves the call whole
    return lay, cells


def _plan(csr, dtype, r):
    """(layout or None, value slots): the cached entry, built on a miss."""
    tdtype = csr.values.dtype if dtype is None else _torch_dtype(dtype)
    if tdtype not in _DTYPES:
        raise ValueError(f"swell runs float64 and float32, not {dtype}")
    if tdtype == torch.float64 and csr.values.dtype != torch.float64:
        raise ValueError(f"get_swell_plan(dtype=float64) requires float64 CSR values, "
                         f"got {csr.values.dtype}")
    if r is not None and r not in (1, 2, 3, 4):
        raise ValueError(f"swell micro-block size r must be 1..4, got {r!r}")
    key = (id(csr.row_ptr), id(csr.col_idx), id(csr.values), csr.shape, tdtype, r)
    hit = _SWELL_CACHE.get(key)
    if (hit is not None and hit[0] is csr.row_ptr and hit[1] is csr.col_idx
            and hit[2] is csr.values):
        return hit[3:]
    with profiling.span("swell.plan"):
        lay, cells = _host_layout(csr, tdtype, r)
        layout = None
        if lay is not None:
            sched = _timed("schedule", build_swell_schedule, lay)
            layout = _timed("h2d", DeviceSwellLayout.from_host, lay, csr.device, *csr.shape,
                            sched)
    _SWELL_CACHE[key] = (csr.row_ptr, csr.col_idx, csr.values, layout, cells)
    return layout, cells


def _repeats(rp, ci, m: int, n: int) -> bool:
    """Whether a (row, column) of the CSR pattern repeats."""
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    if not (np.diff(ci)[rows[1:] == rows[:-1]] <= 0).any():
        return False  # columns strictly ascending in every row
    keys = rows * n + ci
    return len(np.unique(keys)) != len(keys)


def value_map(layout: DeviceSwellLayout, row_ptr, col_idx, shape):
    """Where each value of ``layout`` comes from in the CSR pattern it was laid
    out from (host ``row_ptr``, ``col_idx`` and ``shape``): ``(cells, tail)``,
    int32 on the layout's device, for each value cell and COO tail entry the
    CSR position + 1 of the entry it holds, 0 for a padded cell.  Found by
    laying the pattern out again with each entry's position + 1 as its value
    (float64, exact), so the layout's own code places them.  None where a
    (row, column) repeats: a cell then holds a sum.  Host work of the size of
    a plan build, in the span ``swell.value_map``."""
    with profiling.span("swell.value_map"):
        rp = np.asarray(row_ptr, dtype=np.int64)
        ci = np.asarray(col_idx, dtype=np.int64)
        if _repeats(rp, ci, int(shape[0]), int(shape[1])):
            return None
        pos = np.arange(1, int(rp[-1]) + 1, dtype=np.float64)
        lay = build_swell_layout(_slabs(rp, ci, pos, shape, torch.float64, layout.r))
        dev = layout.device
        if (len(lay.vals) != layout.vals.numel() or len(lay.tail_v) != layout.tail_v.numel()
                or not torch.equal(torch.from_numpy(lay.lidx).to(dev), layout.lidx)):
            raise ValueError("value_map: the pattern is not the one the layout was laid out "
                             "from")
        return (torch.from_numpy(lay.vals.astype(np.int32)).to(dev),
                torch.from_numpy(lay.tail_v.astype(np.int32)).to(dev))


def revalue(layout: DeviceSwellLayout, values: torch.Tensor, vmap: tuple) -> None:
    """Write new values into ``layout`` in place, cast to its dtype:
    ``values`` on its device is a 0 and then the CSR's values in CSR order,
    ``vmap`` the CSR's :func:`value_map`.  Every holder of the layout, a
    captured graph too, reads them from then on.  Counts ``swell.revalues``."""
    cells, tail = vmap
    if layout.vals.dtype == values.dtype:
        torch.index_select(values, 0, cells, out=layout.vals)
    else:
        layout.vals.copy_(values.index_select(0, cells))
    if tail.numel():
        layout.tail_v.copy_(values.index_select(0, tail))
    profiling.count("swell.revalues")


def revalue_plans(csr) -> int:
    """After new values were written into ``csr.values`` in place, every
    cached layout of ``csr`` takes them (:func:`revalue`, through a
    :func:`value_map` made at its first call and kept on the layout), or is
    dropped from the cache where it has none.  Returns the entries dropped."""
    padded, pattern, dropped = None, None, 0
    for key in held_by(_SWELL_CACHE, csr):
        layout = _SWELL_CACHE[key][3]
        if layout is None:  # past the cap: nothing laid out
            continue
        if layout._value_map is None:
            if pattern is None:
                pattern = (csr.row_ptr.cpu().numpy(), csr.col_idx.cpu().numpy())
            layout._value_map = value_map(layout, *pattern, csr.shape) or ()
        if not layout._value_map:
            del _SWELL_CACHE[key]
            dropped += 1
            continue
        if padded is None:
            padded = torch.cat([csr.values.new_zeros(1), csr.values])
        revalue(layout, padded, layout._value_map)
    return dropped


on_replace_values(revalue_plans)


def in_plan_cache(layout: DeviceSwellLayout) -> bool:
    """Whether ``layout`` is in the plan cache: after ``replace_values`` on
    its CSR, whether it took the new values (:func:`revalue_plans`)."""
    return any(e[3] is layout for e in _SWELL_CACHE.values())


def swell_plan_within_cap(csr, dtype=None, r=None):
    """The swell layout of ``csr`` on ``csr``'s device, built once per (matrix,
    dtype, r), or None when it would hold more than ``SWELL_MAX_SLOTS`` value
    slots (decided on the slab depths, before the layout is allocated).

    ``dtype`` defaults to the values' dtype; float64 needs float64 values.
    ``r=None`` runs the reference's block-size detection; an explicit r in
    1..4 pins it, as the JAX package's ``SPMV_TPU_BSR`` does."""
    return _plan(csr, dtype, r)[0]


def get_swell_plan(csr, dtype=None, r=None) -> DeviceSwellLayout:
    """:func:`swell_plan_within_cap`, raising ValueError past the cap."""
    layout, cells = _plan(csr, dtype, r)
    if layout is None:
        raise ValueError(f"the swell layout of this {csr.shape[0]}x{csr.shape[1]} matrix "
                         f"would hold {cells} value slots, more than SWELL_MAX_SLOTS = "
                         f"{SWELL_MAX_SLOTS}")
    return layout


def kernel_group(r: int, k: int) -> int:
    """Columns per kernel block: the reference's group max(1, 8 // r)
    (``ops/spmm.py:52``), or the next power of two above k when k is smaller;
    the last group's spare columns are masked."""
    g = max(1, 8 // r)
    while g > 1 and g // 2 >= k:
        g //= 2
    return g


def _check(layout: DeviceSwellLayout, x, ndim: int) -> None:
    _check_vector(layout, "swell_ax" if ndim == 1 else "swell_amx", "x", x, layout.x_rows, ndim)


def _check_vector(layout: DeviceSwellLayout, name: str, what: str, v, rows: int,
                  ndim: int = 1) -> None:
    """``v`` (``rows``,) or (``rows``, k >= 1) as ``ndim`` says, a contiguous
    tensor of the plan's dtype on its device; raises naming ``name``'s ``what``."""
    if not isinstance(v, torch.Tensor):
        raise TypeError(f"{name}: {what} must be a torch.Tensor, got {type(v).__name__}")
    if v.dtype != layout.dtype:
        raise ValueError(f"{name}: {what} is {v.dtype}, the plan {layout.dtype}")
    if v.dim() != ndim or v.shape[0] != rows or (ndim == 2 and v.shape[1] < 1):
        raise ValueError(f"{name}: {what} has shape {tuple(v.shape)}, the plan takes {rows} "
                         f"rows")
    if not v.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
    if v.device != layout.device:
        raise ValueError(f"{name}: {what} is on {v.device}, the plan on {layout.device}")


def _layout_args(layout: DeviceSwellLayout, k: int, device) -> tuple:
    """The kernel's layout and schedule arguments, through the partial buffer
    (FP64, partial slots x r x k x 128, allocated on the current stream; None
    when no row-block is split)."""
    sc = layout.schedule
    part = None
    if sc.nsplit:
        part = torch.empty(sc.nparts * layout.r * k * LANES, dtype=torch.float64, device=device)
    ptr = ctypes.c_void_p
    return (ptr(layout.vals.data_ptr()), ptr(layout.lidx.data_ptr()),
            ptr(layout.slab_off.data_ptr()), ptr(layout.slab_log2d.data_ptr()),
            ptr(layout.slab_col_base.data_ptr()), ptr(layout.sched.data_ptr()), sc.nchunks,
            sc.nsplit, None if part is None else ptr(part.data_ptr())), part


def _launch(layout: DeviceSwellLayout, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a contiguous (n, k) CUDA X: one call that launches the
    kernel and, when the schedule splits a row-block, its fix-up pass."""
    from ._build import SWELL_SRC, load_lib

    lib = load_lib(SWELL_SRC)
    k = int(X.shape[1])
    Y = torch.empty(layout.out_rows, k, dtype=layout.dtype, device=X.device)
    ptr = ctypes.c_void_p
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        args, _part = _layout_args(layout, k, X.device)
        rc = lib.swell_spmm(
            int(layout.dtype == torch.float64), layout.r, kernel_group(layout.r, k), *args,
            ptr(X.data_ptr()), ptr(Y.data_ptr()), layout.out_rows, layout.x_rows, k,
            ptr(stream))
    if rc != 0:
        raise RuntimeError(f"swell kernel launch failed: CUDA error {rc}")
    key = (_DTYPES[layout.dtype], layout.r, k)
    LAUNCHES[key] += 1
    if layout.schedule.nsplit:
        LAUNCHES[(*key, "fixup")] += 1
    return Y


def _add_tail(layout: DeviceSwellLayout, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """COO tail of spilled cells (scalar plans only): a gather and an
    ``index_add_`` (the reference's ``segment_sum``), in Y's dtype."""
    if layout.tail_v.numel():
        Y.index_add_(0, layout.tail_rows,
                     layout.tail_v.to(Y.dtype)[:, None] * X[layout.tail_ci].to(Y.dtype))
    return Y


def _plain_index(layout: DeviceSwellLayout):
    """Node row and node column of every slot (-1 column for padding that would
    fall outside [0, cols)), derived from the layout's offsets."""
    if layout._plain_idx is None:
        dev = layout.device
        depth = torch.ones_like(layout.slab_off) << layout.slab_log2d.long()
        slab = torch.repeat_interleave(
            torch.arange(layout.slab_off.numel(), device=dev), depth * LANES)
        rb = torch.repeat_interleave(
            torch.arange(layout.mrb, device=dev), torch.diff(layout.rb_slab_ptr))
        lane = torch.arange(layout.slots, device=dev) % LANES
        row = rb[slab] * LANES + lane
        col = layout.slab_col_base[slab].long() + layout.lidx.long()
        col = torch.where((col >= 0) & (col < layout.cols), col, -1)
        layout._plain_idx = (row, col)
    return layout._plain_idx


def _amx_plain(layout: DeviceSwellLayout, X: torch.Tensor) -> torch.Tensor:
    r, k = layout.r, int(X.shape[1])
    row, col = _plain_index(layout)
    X64 = X.double()
    Xn = torch.zeros(layout.cols * r, k, dtype=torch.float64, device=X.device)
    Xn[: layout.x_rows] = X64
    g = Xn.view(layout.cols, r, k)[col.clamp(min=0)]                    # (slots, r, k)
    g = torch.where((col >= 0)[:, None, None], g, 0.0)
    cells = layout.vals.double().view(-1, r * r, LANES).transpose(1, 2)  # (slot rows, 128, r*r)
    cells = cells.reshape(-1, r, r)                                      # (slots, r, r)
    prod = (cells[:, :, :, None] * g[:, None, :, :]).sum(2)             # (slots, r, k)
    out = torch.zeros(layout.mrb * LANES, r, k, dtype=torch.float64, device=X.device)
    out.index_add_(0, row, prod)
    out = _add_tail(layout, X64, out.view(-1, k)[: layout.out_rows])
    return out.to(layout.dtype)


def swell_amx_plain(layout: DeviceSwellLayout, X: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, tail included: the same A@X, (m, k),
    with gathers and ``index_add_`` in float64, cast to the plan's dtype.  The
    CPU path of ``swell_ax``/``swell_amx`` and the kernel's reference."""
    _check(layout, X, 2)
    return _amx_plain(layout, X)


def swell_ax_plain(layout: DeviceSwellLayout, x: torch.Tensor) -> torch.Tensor:
    """``swell_amx_plain`` for one column: A@x, (m,)."""
    _check(layout, x, 1)
    return _amx_plain(layout, x[:, None])[:, 0]


def swell_amx(layout: DeviceSwellLayout, X: torch.Tensor) -> torch.Tensor:
    """A@X over the swell layout for X of shape (n, k), (m, k) in the plan's
    dtype.  Launches the Hopper kernel for a CUDA ``X`` (one launch covers all
    k columns in groups of ``kernel_group(r, k)``) and runs the plain version
    for a CPU ``X``; any other device raises."""
    _check(layout, X, 2)
    return _amx(layout, X)


def _amx(layout: DeviceSwellLayout, X: torch.Tensor) -> torch.Tensor:
    if X.device.type == "cuda":
        return _add_tail(layout, X, _launch(layout, X))
    if X.device.type == "cpu":
        return _amx_plain(layout, X)
    raise NotImplementedError(f"swell has no kernel for device {X.device}")


def swell_ax(layout: DeviceSwellLayout, x: torch.Tensor) -> torch.Tensor:
    """A@x over the swell layout, (m,) in the plan's dtype: ``swell_amx`` with
    one column."""
    _check(layout, x, 1)
    return _amx(layout, x[:, None])[:, 0]


# ---------------------------------------------------------------- the sweep store
#
# One Jacobi sweep of the ILU(0) preconditioner (ops/trisolve.py): y = c - A x,
# or (c - A x) * d, in one launch where the product, a subtract and a multiply
# were three passes.


def _check_sweep(layout: DeviceSwellLayout, x, c, d) -> None:
    _check_vector(layout, "swell_sweep", "x", x, layout.x_rows)
    _check_vector(layout, "swell_sweep", "c", c, layout.out_rows)
    if d is not None:
        _check_vector(layout, "swell_sweep", "d", d, layout.out_rows)
    if layout.tail_v.numel():
        raise ValueError("swell_sweep takes no layout with a COO tail: its cells are added "
                         "after the kernel, before the subtraction")


def _sweep_plain(layout: DeviceSwellLayout, x, c, d):
    y = c - _amx_plain(layout, x[:, None])[:, 0]
    return y if d is None else y * d


def swell_sweep_plain(layout: DeviceSwellLayout, x: torch.Tensor, c: torch.Tensor,
                      d: torch.Tensor | None = None) -> torch.Tensor:
    """``(c - swell_ax_plain(layout, x)) * d``, or ``c - swell_ax_plain(layout,
    x)`` without ``d``: the sweep store's plain version, as PyTorch ops.  The
    CPU path of :func:`swell_sweep` and its kernel's reference."""
    _check_sweep(layout, x, c, d)
    return _sweep_plain(layout, x, c, d)


def _launch_sweep(layout: DeviceSwellLayout, x, c, d) -> torch.Tensor:
    from ._build import SWELL_SRC, load_lib

    lib = load_lib(SWELL_SRC)
    y = torch.empty_like(c)
    ptr = ctypes.c_void_p
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args, _part = _layout_args(layout, 1, x.device)
        rc = lib.swell_sweep(
            int(layout.dtype == torch.float64), layout.r, *args, ptr(x.data_ptr()),
            ptr(c.data_ptr()), None if d is None else ptr(d.data_ptr()), ptr(y.data_ptr()),
            layout.out_rows, layout.x_rows, ptr(stream))
    if rc != 0:
        raise RuntimeError(f"swell sweep kernel launch failed: CUDA error {rc}")
    key = (_DTYPES[layout.dtype], layout.r, 1)
    LAUNCHES[(*key, "sweep")] += 1
    if layout.schedule.nsplit:
        LAUNCHES[(*key, "sweep_fixup")] += 1
    return y


def swell_sweep(layout: DeviceSwellLayout, x: torch.Tensor, c: torch.Tensor,
                d: torch.Tensor | None = None) -> torch.Tensor:
    """One sweep's ``(c - A x) * d``, or ``c - A x`` without ``d``, (m,) in the
    plan's dtype, with ``c`` and ``d`` (m,) in that dtype: bit for bit
    :func:`swell_ax` followed by the subtract and the multiply.  A CUDA ``x``
    launches the swell kernel's sweep store (``csrc/swell_spmv.cu``, entry
    ``swell_sweep``: one launch, and a fix-up where the schedule splits a
    row-block), a CPU ``x`` runs :func:`swell_sweep_plain`.  A layout with a
    COO tail raises: the tail has to be added before the subtraction."""
    _check_sweep(layout, x, c, d)
    if x.device.type == "cuda":
        return _launch_sweep(layout, x, c, d)
    if x.device.type == "cpu":
        return _sweep_plain(layout, x, c, d)
    raise NotImplementedError(f"swell_sweep has no kernel for device {x.device}")


# ---------------------------------------------------------------- x as bf16 planes
#
# x (or, for r > 1 or k > 1, its S = r*k slices, slice s = c*r + j holding
# X[j::r, c] at node granularity) front-padded by the plan's column shift delta
# to nchunks * 16384 entries; each f32 "set" (f32 input: x; f64 input: hi =
# f32(x), lo = f32(x - hi)) split into three bf16 planes whose sum is exact,
# c1 = rne(v), c2 = rne(v - c1), c3 = v - c1 - c2, rounding by the reference's
# integer RNE.  Output (nchunks, 128, S * K * 128) bf16, K = 3 * sets: entry q
# of slice s, plane p (sets in order, 3 planes each) at
# [q >> 14, (q >> 7) & 127, (s*K + p)*128 + (q & 127)].

_CHUNK = LANES * LANES  # node columns per x chunk


def _rne_bf16(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to the nearest bf16 value (ties to even) by the
    reference's integer bit operations, as float32.  int64 arithmetic on the
    bits: PyTorch has no uint32 shifts on every backend."""
    u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)


def _bf16_bits(v: torch.Tensor) -> torch.Tensor:
    """The bf16 bits of a bf16-representable float32 ``v``: its top 16 bits."""
    return (v.view(torch.int32) >> 16).to(torch.int16)


def _plane_sets(layout: DeviceSwellLayout, X: torch.Tensor) -> torch.Tensor:
    """The padded slices of X as the float32 sets, (sets, n_pad, S)."""
    r, k = layout.r, int(X.shape[1])
    xs = X.new_zeros(layout.cols * r, k)
    xs[: layout.x_rows] = X
    xs = xs.view(layout.cols, r, k).transpose(1, 2).reshape(layout.cols, r * k)
    xp = X.new_zeros(layout.nchunks * _CHUNK, r * k)
    xp[layout.delta: layout.delta + layout.cols] = xs
    if xp.dtype == torch.float64:
        hi = xp.float()
        return torch.stack([hi, (xp - hi.double()).float()])
    return xp[None]


def _check_prep(layout: DeviceSwellLayout, x) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"prep_x takes a torch.Tensor, got {type(x).__name__}")
    if x.dtype != layout.dtype:
        raise ValueError(f"prep_x: x is {x.dtype}, the plan {layout.dtype}")
    if x.dim() not in (1, 2) or x.shape[0] != layout.x_rows:
        raise ValueError(f"prep_x: x has shape {tuple(x.shape)}, the matrix has "
                         f"{layout.x_rows} columns")
    if not x.is_contiguous():
        raise ValueError("prep_x: x must be contiguous")
    if x.device != layout.device:
        raise ValueError(f"prep_x: x is on {x.device}, the plan on {layout.device}")


def prep_x_plain(layout: DeviceSwellLayout, x: torch.Tensor) -> torch.Tensor:
    """The bf16 chunk planes of x, (n,) or (n, k), for ``layout`` (layout
    above): the JAX package's ``_prep_x_pure(native=False)`` in plain PyTorch,
    bit for bit.  The CPU path of :func:`prep_x`, the plane-split kernel's
    reference, and on any device the r x k slice layout."""
    _check_prep(layout, x)
    X = x[:, None] if x.dim() == 1 else x
    sets = _plane_sets(layout, X)                    # (sets, n_pad, S)
    planes = []
    for v in sets:
        c1 = _rne_bf16(v)
        r1 = v - c1
        c2 = _rne_bf16(r1)
        planes += [c1, c2, r1 - c2]
    st = _bf16_bits(torch.stack(planes))             # (K, n_pad, S)
    K, S = st.shape[0], st.shape[2]
    st = st.permute(2, 0, 1).reshape(S, K, layout.nchunks, LANES, LANES)
    return st.permute(2, 3, 0, 1, 4).reshape(layout.nchunks, LANES, S * K * LANES).view(
        torch.bfloat16)


def _launch_plane_split(layout: DeviceSwellLayout, x: torch.Tensor) -> torch.Tensor:
    from ._build import PLANE_SRC, load_lib

    lib = load_lib(PLANE_SRC)
    sets = 2 if layout.dtype == torch.float64 else 1
    out = torch.empty(layout.nchunks, LANES, 3 * sets * LANES, dtype=torch.bfloat16,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.plane_split(int(sets == 2), ctypes.c_void_p(x.data_ptr()),
                             ctypes.c_void_p(out.data_ptr()), layout.x_rows, layout.delta,
                             layout.nchunks * _CHUNK, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"plane-split kernel launch failed: CUDA error {rc}")
    LAUNCHES[(_DTYPES[layout.dtype], "plane_split")] += 1
    return out


def prep_x(layout: DeviceSwellLayout, x: torch.Tensor) -> torch.Tensor:
    """The bf16 chunk planes of x for ``layout`` (counterpart of the JAX plan
    method ``DeviceSwellPlan.prep_x``).  For a scalar plan and one column, a
    CUDA ``x`` launches the plane-split kernel (``csrc/plane_split.cu``) and a
    CPU ``x`` runs :func:`prep_x_plain`; the r x k slice layout, plain XLA ops
    in the JAX package, is :func:`prep_x_plain` on any device."""
    _check_prep(layout, x)
    if x.device.type == "cuda" and layout.r == 1 and x.dim() == 1:
        return _launch_plane_split(layout, x)
    if x.device.type in ("cpu", "cuda"):
        return prep_x_plain(layout, x)
    raise NotImplementedError(f"prep_x has no kernel for device {x.device}")


def _check_planes(layout: DeviceSwellLayout, planes) -> None:
    if layout.r != 1:
        raise ValueError(f"swell_ax_planes runs scalar plans (r = 1), not r = {layout.r}")
    if not isinstance(planes, torch.Tensor) or planes.dtype != torch.bfloat16:
        raise TypeError("swell_ax_planes takes the bfloat16 planes of prep_x")
    sets = 2 if layout.dtype == torch.float64 else 1
    want = (layout.nchunks, LANES, 3 * sets * LANES)
    if tuple(planes.shape) != want or not planes.is_contiguous():
        raise ValueError(f"swell_ax_planes: planes of shape {tuple(planes.shape)}, the plan "
                         f"takes contiguous {want}")
    if planes.device != layout.device:
        raise ValueError(f"swell_ax_planes: planes on {planes.device}, the plan on "
                         f"{layout.device}")


def _planes_x(layout: DeviceSwellLayout, planes: torch.Tensor, cols: torch.Tensor):
    """x~ at node columns ``cols``, in the plan's dtype: the sum of each set's
    three planes (exact in float32), hi + lo in float64 for a float64 plan."""
    q = cols.long() + layout.delta
    K = planes.shape[2] // LANES
    v = planes.view(-1, K, LANES)[q >> 7, :, q & (LANES - 1)].float()   # (len, K)
    hi = (v[:, 0] + v[:, 1]) + v[:, 2]
    if K == 3:
        return hi
    return hi.double() + ((v[:, 3] + v[:, 4]) + v[:, 5]).double()


def swell_ax_planes_plain(layout: DeviceSwellLayout, planes: torch.Tensor) -> torch.Tensor:
    """A @ x~ for the x~ the planes hold: :func:`swell_ax_plain` of x~ rebuilt
    from the planes.  The CPU path of :func:`swell_ax_planes` and its kernel's
    reference."""
    _check_planes(layout, planes)
    cols = torch.arange(layout.x_rows, device=planes.device)
    return swell_ax_plain(layout, _planes_x(layout, planes, cols))


def swell_ax_planes(layout: DeviceSwellLayout, planes: torch.Tensor) -> torch.Tensor:
    """A @ x~, (m,) in the plan's dtype, x~ read from the bf16 planes of
    :func:`prep_x` (scalar plans).  On a CUDA tensor the swell kernel's plane
    form (one launch; the COO tail by ``index_add_``); on a CPU tensor
    :func:`swell_ax_planes_plain`.  In float32 x~ == x, so the result equals
    :func:`swell_ax` bit for bit."""
    _check_planes(layout, planes)
    if planes.device.type == "cpu":
        return swell_ax_planes_plain(layout, planes)
    if planes.device.type != "cuda":
        raise NotImplementedError(f"swell_ax_planes has no kernel for device {planes.device}")
    from ._build import SWELL_SRC, load_lib

    lib = load_lib(SWELL_SRC)
    y = torch.empty(layout.out_rows, dtype=layout.dtype, device=planes.device)
    ptr = ctypes.c_void_p
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        args, _part = _layout_args(layout, 1, planes.device)
        rc = lib.swell_spmv_planes(
            int(layout.dtype == torch.float64), *args, ptr(planes.data_ptr()),
            ptr(y.data_ptr()), layout.out_rows, layout.x_rows, layout.delta, ptr(stream))
    if rc != 0:
        raise RuntimeError(f"plane-form swell kernel launch failed: CUDA error {rc}")
    LAUNCHES[(_DTYPES[layout.dtype], 1, 1, "planes")] += 1
    if layout.schedule.nsplit:
        LAUNCHES[(_DTYPES[layout.dtype], 1, 1, "planes_fixup")] += 1
    if layout.tail_v.numel():
        xt = _planes_x(layout, planes, layout.tail_ci)
        y.index_add_(0, layout.tail_rows, layout.tail_v * xt)
    return y


def spmv_swell(alpha, beta, csr, x, y, plan=None):
    """Full strategy entry (dispatch contract): y_out = alpha*A@x + beta*y."""
    return axpby_finish(alpha, beta, swell_ax(get_swell_plan(csr), x), y)


def make_swell_run(csr, alpha=1.0, beta=1.0):
    """Bench helper: ``run(x, y, n)`` executes n chained SpMV iterations and
    returns the final x (a new tensor).  Each step is ``swell_ax`` and the
    feedback F-1 (:func:`.feedback.feedback_`): x is scaled in place by a
    multiplier that depends on every output element and perturbs it by ~1e-30
    relatively, so no iteration can be skipped and magnitudes stay put.  On a
    CUDA x the chain runs as replays of captured CUDA graphs (the JAX package's
    one device program, ``utils.graphs.Loop``), captured at the first call and
    kept with ``run``; on the CPU the same step runs eagerly."""
    from ..utils.graphs import Loop
    from .feedback import feedback_

    layout = get_swell_plan(csr)
    ybuf, loop = [], []  # the chain's y and its Loop, made at the first call

    def step(x):
        return feedback_(x, swell_ax(layout, x), ybuf[0], alpha, beta)

    def run(x, y, n):
        if y.shape != (layout.out_rows,):
            raise ValueError(f"run takes y of shape ({layout.out_rows},), got {tuple(y.shape)}")
        if not loop:
            ybuf.append(torch.empty(layout.out_rows, dtype=layout.dtype, device=x.device))
            loop.append(Loop(step, x))
        ybuf[0].copy_(y)
        return loop[0].run(x, n)

    return run


def make_swell_amx_run(csr, k: int):
    """Bench helper: ``run(X, n)`` executes n chained k-column SpMM iterations
    (square matrices: X feeds back through the result's scale, F-1 without y,
    as in ``make_swell_run``; captured CUDA graphs on the card, eager on the
    CPU)."""
    from ..utils.graphs import Loop
    from .feedback import feedback_

    layout = get_swell_plan(csr)
    if layout.out_rows != layout.x_rows:
        raise ValueError("make_swell_amx_run needs a square matrix")
    loop = []

    def step(X):
        return feedback_(X, swell_amx(layout, X))

    def run(X, n):
        if X.dim() != 2 or X.shape[1] != k:
            raise ValueError(f"run takes X of shape (n, {k}), got {tuple(X.shape)}")
        if not loop:
            loop.append(Loop(step, X))
        return loop[0].run(X, n)

    return run
