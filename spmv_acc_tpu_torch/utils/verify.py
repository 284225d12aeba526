"""Verification gates, reproducing the reference's tolerance semantics.

The same gates, report fields and printed strings as the JAX package's
``spmv_acc_tpu/utils/verify.py``:
  * ``verify`` (cli/verification.cpp:43-54) — pass/fail with the reference's
    messages; guarded near zero unless ``strict_relative``.
  * ``verify_y`` (cli/verification.cpp:15-38) — full forensic scan returning
    ``{max_error, first_failed_at, failed_count}`` with mixed tolerance: absolute
    >= 1e-14 when |golden| <= 1e-12, else relative >= 1e-7.
Tensors are read back to the host first.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import ABS_TOL, ABS_TOL_F32, NEAR_ZERO, NEAR_ZERO_F32, REL_TOL, REL_TOL_F32
from .host import host_array

__all__ = ["VerifyReport", "verify", "verify_y", "tolerances_for"]


@dataclasses.dataclass
class VerifyReport:
    """The benchmark CSV's verification triple (statistics_logger.cpp:28-30)."""

    max_error: float
    first_failed_at: int  # -1 when all pass
    failed_count: int

    @property
    def ok(self) -> bool:
        return self.failed_count == 0


def tolerances_for(dtype):
    """(rel, abs, near_zero) gates by compute dtype; f64 uses the reference's values."""
    if np.dtype(dtype) == np.float32:
        return REL_TOL_F32, ABS_TOL_F32, NEAR_ZERO_F32
    return REL_TOL, ABS_TOL, NEAR_ZERO


def verify_y(y, golden, dtype=np.float64) -> VerifyReport:
    """Forensic compare (cli/verification.cpp:15-38)."""
    y = host_array(y).astype(np.float64, copy=False)
    golden = host_array(golden).astype(np.float64, copy=False)
    rel_tol, abs_tol, near_zero = tolerances_for(dtype)
    abs_err = np.abs(y - golden)
    near = np.abs(golden) <= near_zero
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_err = np.where(golden != 0, abs_err / np.abs(golden), np.inf)
    err = np.where(near, abs_err, rel_err)
    failed = np.where(near, abs_err >= abs_tol, rel_err >= rel_tol)
    idx = np.flatnonzero(failed)
    return VerifyReport(
        max_error=float(err.max()) if err.size else 0.0,
        first_failed_at=int(idx[0]) if idx.size else -1,
        failed_count=int(idx.size),
    )


def verify(y, golden, dtype=np.float64, strict_relative: bool = False, quiet: bool = False) -> bool:
    """Pass/fail gate printing the reference's messages (cli/verification.cpp:43-54).

    ``strict_relative=True`` reproduces the reference quirk of dividing by |golden|
    with no near-zero guard (verification.cpp:46).
    """
    y = host_array(y).astype(np.float64, copy=False)
    golden = host_array(golden).astype(np.float64, copy=False)
    rel_tol, _, _ = tolerances_for(dtype)
    if strict_relative:
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.abs((y - golden) / golden)
        idx = np.flatnonzero(rel >= rel_tol)
        first = int(idx[0]) if idx.size else -1
    else:
        first = verify_y(y, golden, dtype=dtype).first_failed_at
    if first >= 0:
        if not quiet:
            print(f"failed at {first}, y: {y[first]}, hy: {golden[first]}")
        return False
    if not quiet:
        print(f"Congratulation, pass {len(y)} validation!")
    return True
