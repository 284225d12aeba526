"""The swell SpMV strategy on PyTorch: plan cache, the H1 kernel wrapper and its
plain PyTorch version.

Counterpart of ``spmv_acc_tpu/ops/swell.py``.  The host plan
(:mod:`.swell_plan`) is built once per matrix and moved to the matrix's device;
``swell_ax`` computes A@x over it.  On a CUDA tensor it launches H1, the
hand-written Hopper kernel in ``csrc/swell_spmv.cu``; on a CPU tensor it runs
``swell_ax_plain``, the same sum written with torch gathers and ``index_add_``.
There is no fallback from one to the other.  Sums are native FP64, so the
reference's host repair of the two-f32 cancellation floor
(``_refine_cancellation``) has nothing to repair and is not ported.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..config import LANES
from .swell_plan import SwellLayout, build_swell_plan
from .xla import axpby_finish

__all__ = ["DeviceSwellLayout", "get_swell_plan", "clear_swell_cache", "swell_ax",
           "swell_ax_plain", "spmv_swell", "make_swell_run"]


@dataclasses.dataclass
class DeviceSwellLayout:
    """A :class:`SwellLayout` on one device (see it for the array meanings)."""

    rows: int
    cols: int
    fill: float
    vals: torch.Tensor           # (slots,) float64
    lidx: torch.Tensor           # (slots,) uint8
    slab_off: torch.Tensor       # (nslabs,) int64
    slab_log2d: torch.Tensor     # (nslabs,) int8
    slab_col_base: torch.Tensor  # (nslabs,) int32
    rb_slab_ptr: torch.Tensor    # (mrb+1,) int64
    tail_rows: torch.Tensor      # (tnnz,) int64
    tail_ci: torch.Tensor        # (tnnz,) int64
    tail_v: torch.Tensor         # (tnnz,) float64
    # (row, col) index of every slot, derived at the plain version's first use
    _plain_idx: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def mrb(self) -> int:
        return int(self.rb_slab_ptr.shape[0]) - 1

    @property
    def slots(self) -> int:
        return int(self.vals.shape[0])

    @staticmethod
    def from_host(lay: SwellLayout, device) -> "DeviceSwellLayout":
        def t(a, dtype=None):
            a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
            return torch.from_numpy(a).to(device)

        return DeviceSwellLayout(
            rows=lay.rows, cols=lay.cols, fill=lay.fill,
            vals=t(lay.vals), lidx=t(lay.lidx), slab_off=t(lay.slab_off),
            slab_log2d=t(lay.slab_log2d), slab_col_base=t(lay.slab_col_base),
            rb_slab_ptr=t(lay.rb_slab_ptr), tail_rows=t(lay.tail_rows, np.int64),
            tail_ci=t(lay.tail_ci, np.int64), tail_v=t(lay.tail_v, np.float64),
        )


def _is_f64(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float64
    return np.dtype(dtype) == np.float64


# Plan cache.  Each entry holds the keyed tensors themselves and is returned only
# when they are the very objects passed in, so a recycled id() can never serve
# another matrix's plan.  In-place edits of a cached CSR's tensors are not seen:
# build a new CSR (or call clear_swell_cache) after changing one.
_SWELL_CACHE: dict = {}


def clear_swell_cache() -> None:
    _SWELL_CACHE.clear()


def get_swell_plan(csr, dtype=None) -> DeviceSwellLayout:
    """The swell layout of ``csr`` on ``csr``'s device, built once per matrix."""
    dtype = csr.values.dtype if dtype is None else dtype
    if not _is_f64(dtype):
        raise NotImplementedError(
            f"swell in {dtype}: only float64 is ported; the float32 kernel (the "
            f"TPU's _make_f32_kernel) comes in a later PR")
    if csr.values.dtype != torch.float64:
        raise ValueError(f"get_swell_plan(dtype=float64) requires float64 CSR values, "
                         f"got {csr.values.dtype}")
    key = (id(csr.row_ptr), id(csr.col_idx), id(csr.values), csr.shape)
    hit = _SWELL_CACHE.get(key)
    if (hit is not None and hit[0] is csr.row_ptr and hit[1] is csr.col_idx
            and hit[2] is csr.values):
        return hit[3]
    rp, ci, v, shape = csr.to_numpy()
    layout = DeviceSwellLayout.from_host(build_swell_plan(rp, ci, v, shape), csr.device)
    _SWELL_CACHE[key] = (csr.row_ptr, csr.col_idx, csr.values, layout)
    return layout


def _check(layout: DeviceSwellLayout, x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"swell_ax takes a torch.Tensor x, got {type(x).__name__}")
    if x.dtype != torch.float64:
        raise NotImplementedError(
            f"swell_ax in {x.dtype}: only float64 is ported; float32 comes in a later PR")
    if x.dim() != 1 or x.shape[0] != layout.cols:
        raise ValueError(f"swell_ax: x has shape {tuple(x.shape)}, the matrix has "
                         f"{layout.cols} columns")
    if not x.is_contiguous():
        raise ValueError("swell_ax: x must be contiguous")
    if x.device != layout.device:
        raise ValueError(f"swell_ax: x is on {x.device}, the plan on {layout.device}")


def _add_tail(layout: DeviceSwellLayout, x: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """COO tail of spilled cells: a gather and an ``index_add_`` (the reference's
    ``segment_sum``)."""
    if layout.tail_v.numel():
        ax.index_add_(0, layout.tail_rows, layout.tail_v * x[layout.tail_ci])
    return ax


def _launch_h1(layout: DeviceSwellLayout, x: torch.Tensor) -> torch.Tensor:
    from ._build import load_swell_lib

    lib = load_swell_lib()
    ax = torch.empty(layout.rows, dtype=torch.float64, device=x.device)
    ptr = ctypes.c_void_p
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.swell_spmv_f64(
            ptr(layout.vals.data_ptr()), ptr(layout.lidx.data_ptr()),
            ptr(layout.slab_off.data_ptr()), ptr(layout.slab_log2d.data_ptr()),
            ptr(layout.slab_col_base.data_ptr()), ptr(layout.rb_slab_ptr.data_ptr()),
            ptr(x.data_ptr()), ptr(ax.data_ptr()),
            layout.rows, layout.cols, layout.mrb, ptr(stream))
    if rc != 0:
        raise RuntimeError(f"swell H1 launch failed: CUDA error {rc}")
    swell_ax.launches += 1
    return ax


def _plain_index(layout: DeviceSwellLayout):
    """Output row and x column of every slot (-1 column for padding that would
    fall outside [0, n)), derived from the layout's offsets."""
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


def _slab_ax_plain(layout: DeviceSwellLayout, x: torch.Tensor) -> torch.Tensor:
    row, col = _plain_index(layout)
    prod = torch.where(col >= 0, layout.vals * x[col.clamp(min=0)], 0.0)
    out = torch.zeros(layout.mrb * LANES, dtype=torch.float64, device=x.device)
    out.index_add_(0, row, prod)
    return out[: layout.rows]


def swell_ax_plain(layout: DeviceSwellLayout, x: torch.Tensor) -> torch.Tensor:
    """H1's plain PyTorch version, tail included: the same A@x with gathers and
    ``index_add_``.  The CPU path of ``swell_ax`` and the kernel's reference."""
    _check(layout, x)
    return _add_tail(layout, x, _slab_ax_plain(layout, x))


def swell_ax(layout: DeviceSwellLayout, x: torch.Tensor) -> torch.Tensor:
    """A@x over the swell layout, (m,) float64.  Launches H1 for a CUDA ``x``
    (adding one to ``swell_ax.launches``) and runs the plain version for a CPU
    ``x``; any other device raises."""
    _check(layout, x)
    if x.device.type == "cuda":
        ax = _launch_h1(layout, x)
    elif x.device.type == "cpu":
        ax = _slab_ax_plain(layout, x)
    else:
        raise NotImplementedError(f"swell_ax has no kernel for device {x.device}")
    return _add_tail(layout, x, ax)


swell_ax.launches = 0  # H1 launches in this process; set to 0 to count a run


def spmv_swell(alpha, beta, csr, x, y, plan=None):
    """Full strategy entry (dispatch contract): y_out = alpha*A@x + beta*y."""
    layout = get_swell_plan(csr, csr.values.dtype)
    return axpby_finish(alpha, beta, swell_ax(layout, x), y)


def make_swell_run(csr, alpha=1.0, beta=1.0):
    """Bench helper: ``run(x, y, n)`` executes n chained SpMV iterations.  The
    feedback multiplier depends on every output element and perturbs x by
    ~1e-30 relatively, so no iteration can be skipped and magnitudes stay put."""
    layout = get_swell_plan(csr, csr.values.dtype)

    def run(x, y, n):
        for _ in range(n):
            s = axpby_finish(alpha, beta, swell_ax(layout, x), y).float()
            x = x * (1.0 + (s * s).mean().to(x.dtype) * 1e-30)
        return x

    return run
