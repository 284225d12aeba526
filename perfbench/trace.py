"""The traced segment: ``torch.profiler`` over a few requests after the window,
reduced to device busy time, idle share, kernel count and a breakdown.

The profiler's first step is a warm-up that is not read (on an H100 a cold
step recorded 2-4 of 5 launches); the second is read from its Chrome trace,
which stays at ``path`` until the next traced run of the cell.
Device time is the union of the intervals of every kernel, copy and fill in
the step, so work reads the same whatever kernels carry it.  Each idle gap is
labelled with what the host was doing across it: the innermost operator and
the innermost CUDA runtime call that span the gap's middle.  A session that
recorded no kernel is tried again, up to ``TRIES`` sessions; then the run
fails: no share is ever read from an empty trace.
"""

from __future__ import annotations

import collections
import heapq
import json
import os
import sys

import torch

TRIES = 3
_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def short(name: str) -> str:
    """A kernel's name without its return type, namespaces and arguments."""
    for noise in ("void ", "(anonymous namespace)::", "at::native::", "binary_internal::"):
        name = name.replace(noise, "")
    return name.split("(", 1)[0][:160]


def _labels(host, mids):
    """For each of the sorted ``mids``: the innermost host operator and
    runtime call that span it, by a sweep over ``host`` (sorted by start)."""
    out, active, k = [], [], 0
    for mid in mids:
        while k < len(host) and host[k][0] <= mid:
            heapq.heappush(active, (host[k][1], k))
            k += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        op = rt = None
        for _, j in active:
            s, e, cat, name = host[j]
            if cat in ("cuda_runtime", "cuda_driver"):
                if rt is None or e - s < rt[0]:
                    rt = (e - s, name)
            elif op is None or e - s < op[0]:
                op = (e - s, name)
        parts = [p[1] for p in (op, rt) if p is not None]
        out.append(" > ".join(parts) if parts else "host (no recorded op)")
    return out


def summarize(events) -> dict:
    """Busy and window seconds, kernel count and breakdown of the last
    ``ProfilerStep`` in a Chrome trace's ``traceEvents``."""
    # the step's host-side span (the device timeline carries an annotation of it too)
    steps = [e for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith(
        "ProfilerStep#") and str(e.get("cat", "")).lower() in ("user_annotation", "cpu_op")]
    dev = [e for e in events if e.get("ph") == "X" and str(e.get("cat", "")).lower() in _DEVICE]
    if steps:
        last = max(steps, key=lambda e: e["ts"])
        w0, w1 = float(last["ts"]), float(last["ts"]) + float(last["dur"])
    elif dev:
        w0 = min(float(e["ts"]) for e in dev)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in dev)
    else:
        return {"kernels": 0}
    spans, by_name, kernels = [], collections.Counter(), 0
    for e in dev:
        s, t = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        spans.append((s, t))
        by_name[short(str(e["name"]))] += (t - s) * 1e-6
        kernels += str(e.get("cat", "")).lower() == "kernel"
    merged = _union(spans)
    busy = sum(t - s for s, t in merged)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e.get("cat", "")).lower(),
                   str(e["name"])) for e in events
                  if e.get("ph") == "X" and str(e.get("cat", "")).lower() in _HOST
                  and not str(e.get("name", "")).startswith("ProfilerStep#"))
    edges = [w0] + [x for s, t in merged for x in (s, t)] + [w1]
    holes = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps = collections.Counter()
    for (a, b), label in zip(holes, _labels(host, [(a + b) / 2 for a, b in holes])):
        gaps[label] += (b - a) * 1e-6
    return {
        "kernels": kernels,
        "busy_s": busy * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
    }


def traced(run, path: str) -> dict:
    """Profile ``run(warm)``: once with ``warm=True`` (the unread warm-up
    step), then with ``warm=False``, whose return value (the units of work it
    did) goes into the summary under ``units``.  Up to ``TRIES`` sessions."""
    from torch.profiler import ProfilerActivity, profile, schedule

    os.makedirs(os.path.dirname(path), exist_ok=True)
    for attempt in range(1, TRIES + 1):
        done = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            run(True)
            torch.cuda.synchronize()
            prof.step()
            done["units"] = run(False)
            torch.cuda.synchronize()
            prof.step()
        events = []
        if os.path.exists(path):  # no file: the session never reached its active step
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        summary = summarize(events)
        if summary["kernels"]:
            summary.update(done)
            return summary
        print(f"trace: profiler session {attempt} of {TRIES} recorded no kernel",
              file=sys.stderr)
    raise RuntimeError(f"the profiler recorded no kernel in {TRIES} sessions")
