"""Tracing and profiling utilities: the JAX package's ``utils/profiling.py`` on
PyTorch (SURVEY.md §5 lists the reference's three mechanisms: wall timers,
device event timers, per-phase API profiling).

``trace`` records a ``torch.profiler`` trace (CPU activity, and CUDA activity
when a card is present) and exports it as a Chrome trace; ``PhaseTimer`` and
``bandwidth_report`` print the reference package's text, the peak taken from
the card (``stats.chip_peak_gbs``).

``span`` and ``count`` are the program's own record, always on: each span's
exits, seconds and self seconds (less the spans nested in it on the same
thread), and each counter's sum, in one table per process that ``spans``
copies and ``reset`` clears.  The solver, the captured loops and the plans
open spans where their work happens (``cg.solve``, ``cg.eager``,
``cg.blocks``, ``graphs.capture``, ``swell.plan`` and its steps, ``ilu0``,
``dist.shard``, ``mg.setup``, ``mg.apply``, ``csr.replace_values``,
``ilu0.refactor`` with ``ilu0.refactor.setup``, ``swell.value_map``), never
one an iteration of a kernel loop; the multigrid preconditioner counts its
V-cycles and triangular solves as it launches them (``mg.vcycles``,
``mg.tri_solves``); new values on a pattern count the layouts refreshed
(``swell.revalues``), the cache entries and solvers dropped
(``csr.revalue.dropped``), and the refactors, those on the host, and their
rows and nnz (``ilu.refactors``, ``ilu.refactor.host``,
``ilu.refactor.rows``, ``ilu.refactor.nnz``); ``cg_solve`` and
``dist_swell_cg_solve`` count the solvers they keep and build
(``cg.solvers.hit``, ``cg.solvers.built``, ``dist.solvers.hit``,
``dist.solvers.built``), and the distributed solve the bytes its halo
exchange receives (``dist.halo_bytes``).  While a ``torch.profiler`` session records, a span
also enters ``record_function``, so the trace shows it on the kernels'
clock; otherwise it does not (a bare ``record_function`` cost 6.1 µs on
the H100 machine's host with no profiler running, a span 0.92 µs:
``scripts/torch_probe_spans.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import threading
import time
from typing import Dict, NamedTuple, Optional

import torch

from .stats import bytes_moved, chip_peak_gbs

__all__ = ["trace", "Trace", "kernels_in", "span", "count", "spans", "since", "reset", "Stat",
           "PhaseTimer", "bandwidth_report"]


class Stat(NamedTuple):
    """An entry of the span table: a span's exits (``count``), ``seconds`` and
    ``self_seconds``; or a counter's adds (``count``) and their sum
    (``total``)."""

    count: int
    seconds: float
    self_seconds: float
    total: float


_TABLES: list = []  # each thread's table: name -> [count, ns, self ns, total]
_LOCK = threading.Lock()


class _Local(threading.local):
    """A thread's open spans (innermost last) and its table, which
    :func:`spans` merges with the other threads'."""

    def __init__(self):
        self.open = []
        self.table = {}
        with _LOCK:
            _TABLES.append(self.table)


_LOCAL = _Local()
_recording = torch.autograd._profiler_enabled  # 0.08 µs; False in a schedule's warm-up
_now = time.perf_counter_ns


def _entry(table: dict, name: str) -> list:
    e = table.get(name)
    if e is None:
        e = table[name] = [0, 0, 0, 0]
    return e


class span:
    """``with span(name):`` adds the block's exit, wall seconds
    (``time.perf_counter_ns``) and self seconds to ``name``'s entry, and is
    ``torch.profiler.record_function(name)`` too while a profiler records."""

    __slots__ = ("name", "_t0", "_inner", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = None
        if _recording():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._inner = 0
        _LOCAL.open.append(self)
        self._t0 = _now()
        return self

    def __exit__(self, *exc):
        ns = _now() - self._t0
        local = _LOCAL
        stack = local.open
        stack.pop()
        if stack:
            stack[-1]._inner += ns
        e = _entry(local.table, self.name)
        e[0] += 1
        e[1] += ns
        e[2] += ns - self._inner
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def count(name: str, n=1) -> None:
    """Add the quantity ``n`` to the counter ``name``."""
    e = _entry(_LOCAL.table, name)
    e[0] += 1
    e[3] += n


def spans() -> Dict[str, Stat]:
    """A copy of the table, every thread's merged: name -> :class:`Stat`."""
    merged: Dict[str, list] = {}
    with _LOCK:
        for table in _TABLES:
            for name, e in list(table.items()):
                m = _entry(merged, name)
                for i, x in enumerate(e):
                    m[i] += x
    return {k: Stat(c, ns / 1e9, own / 1e9, total) for k, (c, ns, own, total) in merged.items()}


def since(before: Dict[str, Stat]) -> Dict[str, Stat]:
    """What the table gained after ``before`` (an earlier :func:`spans`): the
    entries that grew, each less what it held then."""
    zero = Stat(0, 0.0, 0.0, 0)
    return {k: Stat(*(a - b for a, b in zip(s, before.get(k, zero))))
            for k, s in spans().items() if s.count != before.get(k, zero).count}


def reset() -> None:
    """Empty the table."""
    with _LOCK:
        for table in _TABLES:
            table.clear()


class Trace:
    """What :func:`trace` yields: the trace file's ``path`` and, once the
    region has ended, the ``key_averages()`` of the kernels and ops it ran
    and ``kernels``, the device kernels in the exported trace."""

    def __init__(self, path: str):
        self.path = path
        self._averages = []
        self.kernels = 0

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
    of a process recorded them.  So a card session that exported no kernel
    says so on standard error."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "spmv_trace")
    os.makedirs(log_dir, exist_ok=True)
    out = Trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))

    def ready(prof):
        prof.export_chrome_trace(out.path)
        out._averages = prof.key_averages()
        out.kernels = kernels_in(out.path)

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
    if cuda:
        warn_if_empty(out)


def kernels_in(path: str) -> int:
    """The device kernels (events of category ``kernel``) in a Chrome trace
    file."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return sum(str(e.get("cat", "")).lower() == "kernel" for e in events)


def warn_if_empty(out: Trace) -> None:
    """Say on standard error that a card session recorded no kernel."""
    if out.kernels == 0:
        print(f"trace: the profiler recorded no kernel in {out.path}", file=sys.stderr)


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
