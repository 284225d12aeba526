#!/usr/bin/env python3
"""What a span of ``utils.profiling`` costs the host, and whether
``utils.profiling.trace`` records the kernels of session after session.

    python3 scripts/torch_probe_spans.py [--sessions 20]

1. µs a ``with span(name): pass`` takes with no profiler, beside an empty
   context manager, ``torch.autograd._profiler_enabled()`` and a bare
   ``record_function`` (what a span would pay if it entered one always);
   then a span's µs while a ``torch.profiler`` session records (the span
   then enters ``record_function``).
2. On a card: ``--sessions`` sessions of ``trace`` in one process over a
   one-launch region and over a 64-launch region, each session's
   ``Trace.kernels``.

Prints one JSON line, with the card's name and power limit when there is a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def _us(fn, n: int) -> float:
    """Least µs a call of ``fn`` over 5 rounds of ``n`` calls."""
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter_ns()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter_ns() - t) / n / 1e3)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spmv_acc_tpu_torch.utils import profiling

    class Empty:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def empty():
        with Empty():
            pass

    def one_span():
        with profiling.span("probe"):
            pass

    def bare_record_function():
        with torch.profiler.record_function("probe"):
            pass

    n = 100_000
    out = {
        "empty_cm_us": _us(empty, n),
        "profiler_enabled_us": _us(torch.autograd._profiler_enabled, n),
        "span_us": _us(one_span, n),
        "record_function_us": _us(bare_record_function, n // 10),
    }
    with profile(activities=[ProfilerActivity.CPU]):
        out["span_profiled_us"] = _us(one_span, n // 100)
    cuda = torch.cuda.is_available()
    if cuda:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        x = torch.ones(1 << 20, device="cuda", dtype=torch.float64)
        logs = tempfile.mkdtemp(prefix="spans_probe_")
        for label, launches in (("one_launch", 1), ("64_launches", 64)):
            counts = []
            for _ in range(args.sessions):
                with profiling.trace(logs) as t:
                    for _ in range(launches):
                        x.mul_(1.0)
                counts.append(t.kernels)
            out[f"trace_kernels_{label}"] = counts
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
