"""The swell SpMV/SpMM strategy on PyTorch: plan cache, the Hopper kernel's
wrappers and their plain PyTorch version.

Counterpart of ``spmv_acc_tpu/ops/swell.py``.  The host plan
(:mod:`.swell_plan`) is built once per (matrix, dtype, r) and moved to the
matrix's device; ``swell_ax`` computes A@x and ``swell_amx`` A@X over it, in
float64 or float32, on a scalar plan (r = 1) or on the BSR node pattern of r x r
micro-blocks (r = 2..4, chosen by the reference's detector).  On a CUDA tensor
they launch the hand-written Hopper kernel in ``csrc/swell_spmv.cu``; on a CPU
tensor they run ``swell_amx_plain``, the same sum written with torch gathers and
``index_add_`` in float64.  There is no fallback from one to the other.  Sums
are FP64 for both dtypes, so the reference's host repair of the two-f32 and f32
cancellation floors (``_refine_cancellation``) has nothing to repair and is not
ported.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import numpy as np
import torch

from ..config import LANES
from .bsr_block import bsr_condense, detect_block_size
from .swell_plan import SwellLayout, _canonicalize, build_swell_layout, swell_slabs
from .xla import axpby_finish

__all__ = ["DeviceSwellLayout", "SWELL_MAX_SLOTS", "LAUNCHES", "get_swell_plan",
           "swell_plan_within_cap", "clear_swell_cache", "kernel_group", "swell_ax",
           "swell_amx", "swell_ax_plain", "swell_amx_plain", "spmv_swell", "make_swell_run",
           "make_swell_amx_run"]

# Cap on the value slots of one layout (padded slots * r*r), checked on the slab
# depths before anything is allocated: 1 << 30 slots are ~9.7 GB in float64, ~25x
# the largest corpus layout (boneS10: 41,218,048 slots).  A matrix past it never
# gets a swell layout: the picker passes swell over, an explicit request raises.
SWELL_MAX_SLOTS = 1 << 30

# Kernel launches in this process by (dtype, r, k); set to 0 (``.clear()``) to
# count a run.  Only the kernel's launch site adds to it.
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
    vals: torch.Tensor           # (slots*r*r,) float64 or float32
    lidx: torch.Tensor           # (slots,) uint8
    slab_off: torch.Tensor       # (nslabs,) int64
    slab_log2d: torch.Tensor     # (nslabs,) int8
    slab_col_base: torch.Tensor  # (nslabs,) int32
    rb_slab_ptr: torch.Tensor    # (mrb+1,) int64
    tail_rows: torch.Tensor      # (tnnz,) int64
    tail_ci: torch.Tensor        # (tnnz,) int64
    tail_v: torch.Tensor         # (tnnz,) value dtype
    # (node row, node col) of every slot, derived at the plain version's first use
    _plain_idx: tuple | None = dataclasses.field(default=None, repr=False)

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
    def from_host(lay: SwellLayout, device, out_rows: int, x_rows: int) -> "DeviceSwellLayout":
        def t(a, dtype=None):
            a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
            return torch.from_numpy(a).to(device)

        return DeviceSwellLayout(
            rows=lay.rows, cols=lay.cols, r=lay.r, out_rows=out_rows, x_rows=x_rows,
            fill=lay.fill, vals=t(lay.vals), lidx=t(lay.lidx), slab_off=t(lay.slab_off),
            slab_log2d=t(lay.slab_log2d), slab_col_base=t(lay.slab_col_base),
            rb_slab_ptr=t(lay.rb_slab_ptr), tail_rows=t(lay.tail_rows, np.int64),
            tail_ci=t(lay.tail_ci, np.int64), tail_v=t(lay.tail_v),
        )


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float64": torch.float64, "float32": torch.float32}.get(np.dtype(dtype).name)


# Plan cache.  Each entry holds the keyed tensors themselves and is returned only
# when they are the very objects passed in, so a recycled id() can never serve
# another matrix's plan.  In-place edits of a cached CSR's tensors are not seen:
# build a new CSR (or call clear_swell_cache) after changing one.
_SWELL_CACHE: dict = {}


def clear_swell_cache() -> None:
    _SWELL_CACHE.clear()


def _slabs(csr, dtype: torch.dtype, r):
    """The slab decomposition in ``dtype`` on the scalar pattern or, when the
    block size (``r``, or the reference's detector when None) is above 1, on the
    r x r node pattern (the reference's ``get_swell_plan``, swell.py:2037-2058)."""
    rp, ci, v, (m, n) = csr.to_numpy()
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
    sl = _slabs(csr, tdtype, r)
    cells = sl.padded_slots * sl.r * sl.r
    layout = None
    if cells <= SWELL_MAX_SLOTS:
        layout = DeviceSwellLayout.from_host(build_swell_layout(sl), csr.device, *csr.shape)
    _SWELL_CACHE[key] = (csr.row_ptr, csr.col_idx, csr.values, layout, cells)
    return layout, cells


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
    name = "swell_ax" if ndim == 1 else "swell_amx"
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} takes a torch.Tensor, got {type(x).__name__}")
    if x.dtype != layout.dtype:
        raise ValueError(f"{name}: x is {x.dtype}, the plan {layout.dtype}")
    if x.dim() != ndim or x.shape[0] != layout.x_rows or (ndim == 2 and x.shape[1] < 1):
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, the matrix has "
                         f"{layout.x_rows} columns")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.device != layout.device:
        raise ValueError(f"{name}: x is on {x.device}, the plan on {layout.device}")


def _launch(layout: DeviceSwellLayout, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a contiguous (n, k) CUDA X: one kernel launch."""
    from ._build import SWELL_SRC, load_lib

    lib = load_lib(SWELL_SRC)
    k = int(X.shape[1])
    Y = torch.empty(layout.out_rows, k, dtype=layout.dtype, device=X.device)
    ptr = ctypes.c_void_p
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.swell_spmm(
            int(layout.dtype == torch.float64), layout.r, kernel_group(layout.r, k),
            ptr(layout.vals.data_ptr()), ptr(layout.lidx.data_ptr()),
            ptr(layout.slab_off.data_ptr()), ptr(layout.slab_log2d.data_ptr()),
            ptr(layout.slab_col_base.data_ptr()), ptr(layout.rb_slab_ptr.data_ptr()),
            ptr(X.data_ptr()), ptr(Y.data_ptr()),
            layout.out_rows, layout.x_rows, k, layout.mrb, ptr(stream))
    if rc != 0:
        raise RuntimeError(f"swell kernel launch failed: CUDA error {rc}")
    LAUNCHES[(_DTYPES[layout.dtype], layout.r, k)] += 1
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


def spmv_swell(alpha, beta, csr, x, y, plan=None):
    """Full strategy entry (dispatch contract): y_out = alpha*A@x + beta*y."""
    return axpby_finish(alpha, beta, swell_ax(get_swell_plan(csr), x), y)


def make_swell_run(csr, alpha=1.0, beta=1.0):
    """Bench helper: ``run(x, y, n)`` executes n chained SpMV iterations.  The
    feedback multiplier depends on every output element and perturbs x by
    ~1e-30 relatively, so no iteration can be skipped and magnitudes stay put."""
    layout = get_swell_plan(csr)

    def run(x, y, n):
        for _ in range(n):
            s = axpby_finish(alpha, beta, swell_ax(layout, x), y).float()
            x = x * (1.0 + (s * s).mean().to(x.dtype) * 1e-30)
        return x

    return run


def make_swell_amx_run(csr, k: int):
    """Bench helper: ``run(X, n)`` executes n chained k-column SpMM iterations
    (square matrices: X feeds back through the result's scale, as in
    ``make_swell_run``)."""
    layout = get_swell_plan(csr)
    if layout.out_rows != layout.x_rows:
        raise ValueError("make_swell_amx_run needs a square matrix")

    def run(X, n):
        if X.dim() != 2 or X.shape[1] != k:
            raise ValueError(f"run takes X of shape (n, {k}), got {tuple(X.shape)}")
        for _ in range(n):
            s = swell_amx(layout, X).float()
            X = X * (1.0 + (s * s).mean().to(X.dtype) * 1e-30)
        return X

    return run
