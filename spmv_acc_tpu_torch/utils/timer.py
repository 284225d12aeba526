"""Timers — wall-clock (reference cli/timer.h:11-19) and CUDA events.

PyTorch returns before the device finishes, so ``WallTimer`` synchronises the
device it is given at start and at stop.  ``cuda_time_us`` is the reference's
benchmark protocol (benchmark/csr_spmv.hpp:48-74): ``WARMUP_ITERS`` warmup
calls, then the median of ``BENCHMARK_ARRAY_SIZE`` single-call repetitions,
each bracketed by CUDA events.  ``time_fn`` is the JAX package's wall-clock
``time_fn``, synchronising the device of the result instead of
``jax.block_until_ready``.  ``time_device_loop`` is the JAX package's: the
per-iteration time of a chained loop run as one device program, here the
replays of a captured CUDA graph (``utils.graphs.Loop``).  ``graph_us`` is
the device time of one call inside a captured graph.
"""

from __future__ import annotations

import statistics
import time

import torch

from ..config import BENCHMARK_ARRAY_SIZE, WARMUP_ITERS

__all__ = ["WallTimer", "sync", "cuda_time_us", "graph_us", "time_fn", "time_device_loop",
           "least_times"]

# Rounds of runs a host-clock slope takes at most: a round whose longer loop
# reads no slower than its shorter one (host noise above the difference, as on
# a loaded CPU) is followed by another, the least of every round kept.
SLOPE_ROUNDS = 4


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


def graph_us(fn, calls: int = 20, replays: int = 5) -> float:
    """Device µs a call of ``fn`` in a captured CUDA graph of ``calls`` calls,
    over ``replays`` replays between two CUDA events after one untimed: what
    a call costs inside a captured loop, launch gaps included, without the
    host.  Raises when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("graph_us needs a CUDA device")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) * 1e3 / (replays * calls)


def _result_devices(out) -> set:
    """The devices of the tensors in ``out`` (a tensor, or a tuple, list or
    dict of them, nested)."""
    if isinstance(out, torch.Tensor):
        return {out.device}
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return set().union(*(_result_devices(o) for o in out))
    return set()


def time_fn(fn, *args, iters: int = 1, block=True):
    """Time ``fn(*args)`` over ``iters`` calls after one untimed call; returns
    (result, per-call µs of wall time).  With ``block`` the devices of the
    result are synchronised before the clock starts and before it stops, so
    the time covers the device work too."""
    def wait(out):
        if block:
            for dev in _result_devices(out):
                sync(dev)

    out = fn(*args)
    wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    wait(out)
    dt = (time.perf_counter() - t0) / max(iters, 1)
    return out, dt * 1e6


def least_times(short, long, reps: int = 3):
    """The least seconds of ``reps`` calls of ``short()`` and of ``long()``
    (each returns (seconds, result)): ``(least short, (least long, its
    result))``.  While the least long is no longer than the least short,
    ``reps`` more calls of each, up to ``SLOPE_ROUNDS`` rounds in all."""
    lo = hi = (float("inf"), None)
    for _ in range(SLOPE_ROUNDS):
        lo = min([lo] + [short() for _ in range(reps)], key=lambda tc: tc[0])
        hi = min([hi] + [long() for _ in range(reps)], key=lambda tc: tc[0])
        if hi[0] > lo[0]:
            break
    return lo[0], hi


def time_device_loop(step, init, iters: int = 64, reps: int = 3):
    """Per-iteration time of ``carry = step(carry)`` with the loop on the
    device (the JAX package's ``utils/timer.py::time_device_loop``): the loop
    runs as replays of captured CUDA graphs (:class:`~.graphs.Loop`; eagerly on
    the CPU), 1 and ``1 + iters`` steps from ``init`` are timed on the host
    clock with the device synchronised at both ends, after one warm run of
    each, and the slope between the least of ``reps`` runs of each
    (:func:`least_times`) is the result.  Returns (per-iteration µs, the carry
    after ``1 + iters`` steps)."""
    from .graphs import Loop

    loop = Loop(step, init)
    dev = (init[0] if isinstance(init, tuple) else init).device

    def once(n):
        sync(dev)
        t0 = time.perf_counter()
        out = loop.run(init, n)
        sync(dev)
        return time.perf_counter() - t0, out

    once(1)
    once(1 + iters)
    lo, (hi, carry) = least_times(lambda: once(1), lambda: once(1 + iters), reps)
    return max(hi - lo, 0.0) / iters * 1e6, carry
