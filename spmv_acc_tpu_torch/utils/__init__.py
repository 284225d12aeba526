"""Verification gates, host read-back, timers, statistics and profiling."""

from .host import host_array
from .stats import (
    CSV_HEADER,
    BenchTimes,
    bytes_moved,
    chip_peak_gbs,
    flops,
    print_statistics,
    roofline_fraction,
)
from .timer import WallTimer, cuda_time_us, sync, time_device_loop, time_fn
from .verify import VerifyReport, tolerances_for, verify, verify_y

__all__ = [
    "host_array",
    "CSV_HEADER",
    "BenchTimes",
    "bytes_moved",
    "chip_peak_gbs",
    "flops",
    "print_statistics",
    "roofline_fraction",
    "WallTimer",
    "cuda_time_us",
    "sync",
    "time_fn",
    "time_device_loop",
    "VerifyReport",
    "tolerances_for",
    "verify",
    "verify_y",
]
