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

__all__ = ["trace", "Trace", "PhaseTimer", "bandwidth_report"]


class Trace:
    """What :func:`trace` yields: the trace file's ``path`` and, once the
    region has ended, the ``key_averages()`` of the kernels and ops it ran."""

    def __init__(self, path: str):
        self.path = path
        self._averages = []

    def key_averages(self):
        return self._averages


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Record a ``torch.profiler`` trace around a code region and write it to
    ``log_dir/trace_<pid>_<ns>.json`` (default ``log_dir``: ``spmv_trace`` in
    the temporary directory; Chrome trace format: open it in
    ``chrome://tracing`` or Perfetto).  Yields a :class:`Trace`.

    The profiler runs one warm-up step (a small kernel on the card, not
    recorded) before the region and records the region alone as its active
    step.  On an H100 (torch 2.11) a session that was not the process's first
    often recorded none of a one-launch region's kernels; the first session
    of a process recorded them."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "spmv_trace")
    os.makedirs(log_dir, exist_ok=True)
    out = Trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))

    def ready(prof):
        prof.export_chrome_trace(out.path)
        out._averages = prof.key_averages()

    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        if cuda:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        prof.step()
        yield out
        if cuda:
            torch.cuda.synchronize()
        prof.step()


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
