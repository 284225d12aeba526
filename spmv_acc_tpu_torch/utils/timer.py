"""Timers — wall-clock (reference cli/timer.h:11-19) and CUDA events.

PyTorch returns before the device finishes, so ``WallTimer`` synchronises the
device it is given at start and at stop.  ``cuda_time_us`` is the reference's
benchmark protocol (benchmark/csr_spmv.hpp:48-74): ``WARMUP_ITERS`` warmup
calls, then the median of ``BENCHMARK_ARRAY_SIZE`` single-call repetitions,
each bracketed by CUDA events.
"""

from __future__ import annotations

import statistics
import time

import torch

from ..config import BENCHMARK_ARRAY_SIZE, WARMUP_ITERS

__all__ = ["WallTimer", "sync", "cuda_time_us"]


def sync(device) -> None:
    """Wait for ``device``'s work; a no-op for the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class WallTimer:
    """gettimeofday-style microsecond wall timer (cli/timer.h), device-synchronised."""

    def __init__(self, device="cpu"):
        self.device = device
        self._t0 = None
        self.elapsed_us = 0.0

    def start(self):
        sync(self.device)
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        sync(self.device)
        self.elapsed_us = (time.perf_counter() - self._t0) * 1e6
        return self.elapsed_us


def cuda_time_us(fn, warmups: int = WARMUP_ITERS, reps: int = BENCHMARK_ARRAY_SIZE) -> float:
    """Median device time of ``fn()`` in µs over ``reps`` event-timed calls after
    ``warmups`` untimed ones.  Raises when there is no card: a device time is
    never taken from the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_us needs a CUDA device")
    for _ in range(warmups):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) * 1e3)
    return statistics.median(times)
