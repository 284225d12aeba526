"""Tracing and profiling utilities: the JAX package's ``utils/profiling.py`` on
PyTorch (SURVEY.md §5 lists the reference's three mechanisms: wall timers,
device event timers, per-phase API profiling).

``trace`` records a ``torch.profiler`` trace (CPU activity, and CUDA activity
when a card is present) and exports it as a Chrome trace; ``PhaseTimer`` and
``bandwidth_report`` print the reference package's text, the peak taken from
the card (``stats.chip_peak_gbs``).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from .stats import bytes_moved, chip_peak_gbs

__all__ = ["trace", "PhaseTimer", "bandwidth_report"]


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Record a ``torch.profiler`` trace around a code region and write it to
    ``log_dir/trace_<pid>_<ns>.json`` (default ``log_dir``: ``spmv_trace`` in
    the temporary directory; Chrome trace format: open it in
    ``chrome://tracing`` or Perfetto).  Yields the profiler, whose
    ``key_averages()`` lists the kernels the region ran."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "spmv_trace")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class PhaseTimer:
    """Named phase accumulation (analyze/kernel/fixup/destroy — handle.h analog).
    Wall time of the host: synchronise the device inside a phase to count its
    work."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (time.perf_counter() - t0) * 1e6

    def report(self) -> str:
        total = sum(self.phases.values())
        parts = ", ".join(f"{k}={v:.1f}us" for k, v in self.phases.items())
        return f"{parts}, total={total:.1f}us"


def bandwidth_report(rows: int, nnz: int, time_us: float, value_bytes: int = 8,
                     peak_gbs: Optional[float] = None) -> str:
    """The mem_bandwidth.hpp:19-38 printout: reference-model bytes, their rate
    over ``time_us``, and its share of ``peak_gbs`` (default: the card's)."""
    peak = peak_gbs or chip_peak_gbs()
    b = bytes_moved(rows, nnz, value_bytes)
    gbs = b / (time_us * 1e-6) / 1e9 if time_us > 0 else 0.0
    return (
        f"bytes={b} time={time_us:.1f}us bandwidth={gbs:.1f}GB/s "
        f"peak={peak:.0f}GB/s roofline={gbs / peak:.3f}"
    )
