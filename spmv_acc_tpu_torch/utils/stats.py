"""Benchmark statistics: the reference's 18-column CSV schema and derived metrics.

The same columns, formulas and printed rows as the JAX package's
``spmv_acc_tpu/utils/stats.py`` (benchmark/utils/statistics_logger.cpp:11-57):
``bytes = sizeof(T)*(2m+nnz) + sizeof(int)*(m+1+nnz)`` (:43), ``flops = 2*nnz``
(:46,49), times in microseconds.  The roofline fraction divides by the peak
device-memory bandwidth of the CUDA card, read from the card itself (memory
clock x bus width); there is no table of chips, and no peak without a card.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["CSV_HEADER", "bytes_moved", "flops", "roofline_fraction", "chip_peak_gbs",
           "print_statistics", "BenchTimes", "median_times"]

CSV_HEADER = (
    "PERFORMANCE,matrix,strategy,rows,cols,nnz,nnz/row,GB/s(calc),GFLOPS(calc),"
    "GB/s(total),GFLOPS(total),pre(us),calc(us),fixup(us),destroy(us),total(us),"
    "first_failed_at,failed_count,max_error"
)


def chip_peak_gbs(device=None) -> float:
    """Peak device-memory bandwidth in GB/s of a CUDA ``device`` (default: the
    current one): 2 transfers per memory clock x the bus width.  Raises
    RuntimeError without a CUDA device or when the card does not report them."""
    if not torch.cuda.is_available():
        raise RuntimeError("chip_peak_gbs needs a CUDA device")
    props = torch.cuda.get_device_properties(
        torch.cuda.current_device() if device is None else device)
    clock_khz = getattr(props, "memory_clock_rate", 0)
    bus_bits = getattr(props, "memory_bus_width", 0)
    if not clock_khz or not bus_bits:
        raise RuntimeError(f"{props.name} reports no memory clock or bus width")
    return 2 * clock_khz * 1e3 * bus_bits / 8 / 1e9


def bytes_moved(rows: int, nnz: int, value_bytes: int = 8, index_bytes: int = 4) -> int:
    """statistics_logger.cpp:43 — T*(2m+nnz) + I*(m+1+nnz)."""
    return value_bytes * (2 * rows + nnz) + index_bytes * (rows + 1 + nnz)


def flops(nnz: int) -> int:
    """statistics_logger.cpp:46 — 2*nnz (one mul + one add per stored element)."""
    return 2 * nnz


def roofline_fraction(rows: int, nnz: int, time_us: float, value_bytes=8, peak_gbs=None) -> float:
    """Reference-model bytes over ``time_us``, as a share of ``peak_gbs``
    (default: the card's, ``chip_peak_gbs``)."""
    if time_us <= 0:
        return 0.0
    peak = peak_gbs or chip_peak_gbs()
    gbs = bytes_moved(rows, nnz, value_bytes) / (time_us * 1e-6) / 1e9
    return gbs / peak


@dataclasses.dataclass
class BenchTimes:
    """Phase times in µs (reference benchmark/utils/benchmark_time.h:12-41)."""

    pre: float = 0.0
    calc: float = 0.0
    fixup: float = 0.0  # 'calc2' in the reference
    destroy: float = 0.0

    @property
    def total(self) -> float:
        return self.pre + self.calc + self.fixup + self.destroy


def median_times(times: list) -> "BenchTimes":
    """Median-of-N by calc time (benchmark/utils/benchmark_time.cpp:23-43)."""
    order = sorted(range(len(times)), key=lambda i: times[i].calc)
    return times[order[len(times) // 2]]


def print_statistics(matrix: str, strategy: str, rows: int, cols: int, nnz: int,
                     times: "BenchTimes", report, value_bytes: int = 8, file=None):
    """Emit one CSV row in the reference schema (statistics_logger.cpp:11-57)."""
    calc_s = times.calc * 1e-6
    total_s = times.total * 1e-6
    b = bytes_moved(rows, nnz, value_bytes)
    f = flops(nnz)
    gbs_calc = b / calc_s / 1e9 if calc_s > 0 else 0.0
    gflops_calc = f / calc_s / 1e9 if calc_s > 0 else 0.0
    gbs_total = b / total_s / 1e9 if total_s > 0 else 0.0
    gflops_total = f / total_s / 1e9 if total_s > 0 else 0.0
    row = (
        f"PERFORMANCE,{matrix},{strategy},{rows},{cols},{nnz},{nnz / max(rows, 1):.3f},"
        f"{gbs_calc:.3f},{gflops_calc:.3f},{gbs_total:.3f},{gflops_total:.3f},"
        f"{times.pre:.3f},{times.calc:.3f},{times.fixup:.3f},{times.destroy:.3f},"
        f"{times.total:.3f},{report.first_failed_at},{report.failed_count},"
        f"{report.max_error:.6e}"
    )
    print(row, file=file)
    return row
