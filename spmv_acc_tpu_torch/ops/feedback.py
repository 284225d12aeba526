"""F-1, the chained loop's feedback step: ``x *= 1 + mean(f32(s)^2) * 1e-30``
with ``s = alpha * ax + beta * y`` (SpMV) or ``s = AX`` (SpMM).

The JAX package runs this body inside ``lax.fori_loop`` and XLA fuses it
(``spmv_acc_tpu/ops/swell.py::_swell_power_run``, ``_swell_amx_power_run``);
the port's counterpart of that fusion is the hand-written kernel in
``csrc/feedback.cu``: one cooperative launch of a persistent grid, a
deterministic reduction (per-block float32 sums in a fixed order, a
grid-wide barrier, then every block folds them into the mean and scales its
share of x in place).  :func:`feedback_` launches it for CUDA tensors and
runs :func:`feedback_plain`, the eager expression, for CPU tensors; there is
no fallback from one to the other.

The multiplier depends on every element of the product, so no step of a
chain can be skipped, and it perturbs x by ~1e-30 relatively: with the
bench's data it rounds to exactly 1 in float64, so x comes out the same bits
whatever order the mean was summed in.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from .xla import axpby_finish

__all__ = ["LAUNCHES", "feedback_plain", "feedback_"]

# Calls of the kernel in this process by dtype ("f64", "f32"); each call is one
# cooperative launch.  Only the launch site adds to it (and a captured graph's replays,
# utils/graphs.py); set to 0 with ``.clear()`` to count a run.
LAUNCHES: collections.Counter = collections.Counter()

_DTYPES = {torch.float64: "f64", torch.float32: "f32"}
_PARTIALS = 1024  # csrc/feedback.cu kMaxBlocks: one float32 partial sum per block


def feedback_plain(x: torch.Tensor, ax: torch.Tensor, y=None, alpha=1.0,
                   beta=1.0) -> torch.Tensor:
    """The eager expression, out of place: ``x * (1 + mean(s * s) * 1e-30)``
    with ``s`` cast to float32 (``s = ax`` when ``y`` is None)."""
    s = (ax if y is None else axpby_finish(alpha, beta, ax, y)).float()
    return x * (1.0 + (s * s).mean().to(x.dtype) * 1e-30)


def _check(x, ax, y) -> None:
    named = [("x", x), ("ax", ax)] + ([] if y is None else [("y", y)])
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"feedback_: {name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != x.dtype:
            raise ValueError(f"feedback_: {name} is {t.dtype}, x {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"feedback_: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"feedback_: {name} must be contiguous")
    if x.dtype not in _DTYPES:
        raise ValueError(f"feedback_ runs float64 and float32, not {x.dtype}")
    if ax.numel() == 0:
        raise ValueError("feedback_: ax is empty (the mean of nothing)")
    if y is not None and y.shape != ax.shape:
        raise ValueError(f"feedback_: y has shape {tuple(y.shape)}, ax {tuple(ax.shape)}")


def _launch(x, ax, y, alpha, beta) -> None:
    from ._build import FEEDBACK_SRC, load_lib

    for name, t in (("x", x), ("ax", ax), ("y", y)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"feedback_: {name} must be 16-byte aligned (the kernel's loads)")
    lib = load_lib(FEEDBACK_SRC)
    partials = torch.empty(_PARTIALS, dtype=torch.float32, device=x.device)
    ptr = ctypes.c_void_p
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.feedback(int(x.dtype == torch.float64), int(y is not None), ptr(ax.data_ptr()),
                          ptr(None if y is None else y.data_ptr()), float(alpha), float(beta),
                          ax.numel(), ptr(x.data_ptr()), x.numel(), ptr(partials.data_ptr()),
                          ptr(stream))
    if rc != 0:
        raise RuntimeError(f"feedback kernel launch failed: CUDA error {rc}")
    LAUNCHES[_DTYPES[x.dtype]] += 1


def feedback_(x: torch.Tensor, ax: torch.Tensor, y=None, alpha=1.0, beta=1.0) -> torch.Tensor:
    """Scale ``x`` in place by ``1 + mean(f32(s)^2) * 1e-30`` (``s = alpha * ax
    + beta * y``, or ``s = ax`` without ``y``) and return it.  Launches the
    kernel of ``csrc/feedback.cu`` for CUDA tensors and runs
    :func:`feedback_plain` for CPU tensors; any other device raises."""
    _check(x, ax, y)
    if x.device.type == "cuda":
        _launch(x, ax, y, alpha, beta)
        return x
    if x.device.type == "cpu":
        return x.copy_(feedback_plain(x, ax, y, alpha, beta))
    raise NotImplementedError(f"feedback_ has no kernel for device {x.device}")
