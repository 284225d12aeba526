#!/usr/bin/env python3
"""F-1 (``csrc/feedback.cu``, the chained loop's feedback) of this tree
against another tree's, on one card, in one process.

    python3 scripts/torch_ab_feedback.py --parent build/ab_parent [--out FILE]
        [--matrices boneS10,poli_large,dw4096,epb1,rajat03,af23560] [--no-times]

``--parent`` is an unpacked copy of another commit (``git archive``); its
``feedback.cu`` is built beside this tree's and loaded under the same C
entry, and the wrapper ``ops.feedback.feedback_`` is pointed at one library
or the other in turns (parent, change, change, parent), so that both run the
same Python path, the same inputs and, inside a chain, the same graphs.
``--variant label=path`` adds another ``feedback.cu`` (a tuning of this
tree's) to the turns.

1. ``check``: each kernel against the plain version (float64 and float32;
   SpMV below one block, at a length no multiple of the 16-B vector, at
   boneS10's m and rectangular; SpMM k = 8): x bit for bit where the
   multiplier rounds to 1, within 1e-5 of the multiplier's move plus 4 ulps
   where x moves (alpha 2, beta -0.5, |s| ~ 1e11 in float64, 1e15 in
   float32); two calls the same bits.  A library that fails a check is left
   out of the timings.
2. ``alone``: device µs of one call at boneS10's shape (914,898) and
   Hardesty3's (8,217,820 x 7,591,564), float64 SpMV: CUDA events around the
   call after a 256 MB read (the median of 21; inputs from HBM), and a call
   in a replayed graph of 20 chained calls (the median of 5 replays; inputs
   L2-warm where they fit), beside the bound (16 m + 16 n bytes over
   3352.32 GB/s) and the eager PyTorch sequence from HBM.
3. ``replay``: the bench's captured chain (``make_swell_run``) on each of
   ``--matrices``: µs an iteration at the bench's loop lengths
   (``bench._slope_us``, the loop grown as ``bench_matrix`` grows it), and in
   a profiled replay of ``UNROLL`` steps (``torch.profiler``, one warm-up
   step) F-1's device µs a step and the swell kernel's, where F-1 follows
   the swell kernel.  A new chain is captured for each turn.

Every record is one JSON line (also appended to ``--out``); the last line is
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_GBS = 3352.32  # H100 SXM HBM3 (utils.stats.chip_peak_gbs)
OUT = None


def emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if OUT:
        with open(OUT, "a") as f:
            f.write(line + "\n")


def card_text() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def libraries(parent: str | None, variants=()) -> dict:
    """{"parent": the parent's F-1 library, "change": this tree's, and each
    variant's (label=source)}, built at once, in that order."""
    from spmv_acc_tpu_torch.ops import _build

    srcs = {}
    if parent:
        srcs["parent"] = os.path.join(parent, "spmv_acc_tpu_torch", "csrc", "feedback.cu")
    srcs["change"] = _build.FEEDBACK_SRC
    for v in variants:
        label, src = v.split("=", 1)
        srcs[label] = src
    libs = {}
    for label, so in zip(srcs, _build.build_all(list(srcs.values()))):
        lib = ctypes.CDLL(so)
        lib.feedback.argtypes = _build.SOURCES[_build.FEEDBACK_SRC]["feedback"]
        lib.feedback.restype = ctypes.c_int
        libs[label] = lib
    return libs


def turns(libs) -> list:
    """Every library once, then in the reverse order (parent, change, change,
    parent with two)."""
    return list(libs) + list(reversed(libs))


def use(lib) -> None:
    """Point ``ops.feedback.feedback_`` at ``lib`` (the loaded-library cache)."""
    from spmv_acc_tpu_torch.ops import _build

    _build._libs[_build.FEEDBACK_SRC] = lib


def check(libs, dev, card) -> set:
    """The labels of the libraries that failed a check (or a launch)."""
    from spmv_acc_tpu_torch.ops import feedback

    failed = set()
    for dtype in (torch.float64, torch.float32):
        eps = torch.finfo(dtype).eps
        for label, m, n, k in (("below one block", 3, 5, 1), ("odd length", 100003, 99999, 1),
                               ("boneS10 m", 914898, 914898, 1), ("rect", 70001, 33, 1),
                               ("spmm k=8", 30011, 30011, 8)):
            for moves in (False, True):
                scale = (1e11 if dtype == torch.float64 else 1e15) if moves else 1.0
                rng = np.random.default_rng(m + k)
                shape_ax, shape_x = ((m,), (n,)) if k == 1 else ((m, k), (n, k))
                ax = torch.from_numpy(rng.uniform(-1, 1, shape_ax) * scale).to(dev, dtype)
                y = (torch.from_numpy(rng.uniform(-1, 1, shape_ax) * scale).to(dev, dtype)
                     if k == 1 else None)
                x = torch.from_numpy(rng.uniform(-1, 1, shape_x)).to(dev, dtype)
                plain = feedback.feedback_plain(x, ax, y, 2.0, -0.5)
                s = (ax if y is None else 2.0 * ax - 0.5 * y).float()
                moved = float((s * s).mean()) * 1e-30
                for which, lib in libs.items():
                    if which in failed:
                        continue
                    use(lib)
                    try:
                        a = feedback.feedback_(x.clone(), ax, y, 2.0, -0.5)
                        b = feedback.feedback_(x.clone(), ax, y, 2.0, -0.5)
                        torch.cuda.synchronize()
                    except RuntimeError as e:
                        failed.add(which)
                        emit({"probe": "check", "kernel": which, "case": label, "ok": False,
                              "error": str(e), "card": card})
                        continue
                    repeat = bool(torch.equal(a.view(torch.uint8), b.view(torch.uint8)))
                    gap = (a - plain).abs()
                    if moves:
                        ok = moved > 1e-9 and bool((gap <= (1e-5 * moved + 4 * eps)
                                                    * plain.abs()).all())
                    else:
                        ok = bool(torch.equal(a, plain)) and bool(torch.equal(plain, x))
                    ok = ok and repeat and bool(torch.isfinite(a).all())
                    if not ok:
                        failed.add(which)
                    emit({"probe": "check", "kernel": which, "dtype": str(dtype), "case": label,
                          "moves": moves, "m": m, "n": n, "k": k, "multiplier_minus_1": moved,
                          "max_abs_err": float(gap.max()), "bits_equal": bool(torch.equal(a, plain)),
                          "two_calls_equal": repeat, "ok": ok, "card": card})
    return failed


def alone(libs, dev, card) -> None:
    from spmv_acc_tpu_torch.ops import feedback
    from spmv_acc_tpu_torch.utils.graphs import Loop

    flush = torch.empty(32 << 20, dtype=torch.float64, device=dev)  # 256 MB, 5x the L2

    def cold_us(fn, n=21):
        fn()
        times = []
        for _ in range(n):
            flush.sum()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) * 1e3)
        return sorted(times)[n // 2]

    def graph_us(step, x, n=20):
        """Device µs a call in a replayed graph of ``n`` chained calls (the
        inputs L2-warm where they fit, as in the chain)."""
        loop = Loop(step, x, unroll=n)
        loop.run(x, n)  # the warm-up and the capture
        times = []
        for _ in range(5):
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            loop.advance(n)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) * 1e3 / n)
        return sorted(times)[2]

    rng = np.random.default_rng(4)
    for label, m, n in (("boneS10", 914898, 914898), ("Hardesty3", 8217820, 7591564)):
        ax = torch.from_numpy(rng.uniform(-1, 1, m)).to(dev)
        y = torch.from_numpy(rng.uniform(-1, 1, m)).to(dev)
        x = torch.from_numpy(rng.uniform(-1, 1, n)).to(dev)
        got = {k: {"hbm_us": [], "graph_us": []} for k in libs}
        for which in turns(libs):
            use(libs[which])
            fn = lambda: feedback.feedback_(x, ax, y)  # noqa: E731  (the multiplier is 1)
            got[which]["hbm_us"].append(cold_us(fn))
            got[which]["graph_us"].append(graph_us(lambda v: feedback.feedback_(v, ax, y), x))
        eager = [cold_us(lambda: feedback.feedback_plain(x, ax, y)) for _ in range(2)]
        emit({"probe": "alone", "shape": label, "m": m, "n": n, **got, "eager_hbm_us": eager,
              "bound_us": (16 * m + 16 * n) / (PEAK_GBS * 1e9) * 1e6, "card": card})
        del ax, y, x


def replay_profile(run, n):
    """(F-1 device µs a step, swell kernel µs a step, device busy µs a step)
    of ``run(n)``, in the second of two profiler steps."""
    from torch.profiler import ProfilerActivity, profile, schedule

    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.key_averages())) as prof:
        for _ in range(2):
            run(n)
            torch.cuda.synchronize()
            prof.step()
    f1 = sw = busy = 0.0
    for e in events:
        if "CUDA" not in str(getattr(e, "device_type", "")) or e.key.startswith("ProfilerStep"):
            continue
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        busy += t
        if "feedback" in e.key:
            f1 += t
        elif "swell_kernel" in e.key:
            sw += t
    return f1 / n, sw / n, busy / n


def replay(libs, names, dev, card) -> None:
    from spmv_acc_tpu_torch import bench
    from spmv_acc_tpu_torch.formats.generate import example_like, random_x_y
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.utils.graphs import UNROLL

    for name in names:
        csr = example_like(name).to(dev)
        x, y = (torch.from_numpy(a).to(dev) for a in random_x_y(csr.cols, csr.rows, seed=42))
        swell.get_swell_plan(csr)
        got = {k: {"us": [], "f1_us": [], "swell_us": [], "busy_us": []} for k in libs}
        outs = {}
        for which in turns(libs):
            use(libs[which])
            run = swell.make_swell_run(csr)
            it = bench._iters_for(csr.nnz)
            per = 0.0
            for _ in range(3):  # bench_matrix's loop growth
                per = bench._slope_us(lambda nn: run(x, y, nn), 1 + it // 4, 1 + it, dev)
                if per > 0 and per * (it - it // 4) > 20e3:
                    break
                it = min(it * 4, 65536)
            f1, sw, busy = replay_profile(lambda nn: run(x, y, nn), UNROLL)
            outs[which] = run(x, y, 1 + it)
            for key, v in (("us", per), ("f1_us", f1), ("swell_us", sw), ("busy_us", busy)):
                got[which][key].append(v)
            del run
        ref = next(iter(outs.values()))
        same = all(bool(torch.equal(ref, o)) for o in outs.values())
        emit({"probe": "replay", "name": name, "m": csr.rows, "n": csr.cols, "nnz": csr.nnz,
              **got, "x_equal_all": same, "card": card})
        del csr, x, y, outs
        swell.clear_swell_cache()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    global OUT
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", default=None)
    p.add_argument("--variant", action="append", default=[],
                   help="label=path of another feedback.cu to build and time beside them")
    p.add_argument("--matrices", default="boneS10,poli_large,dw4096,epb1,rajat03,af23560")
    p.add_argument("--no-times", action="store_true", help="the checks only")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    OUT = args.out
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_text()
    libs = libraries(args.parent, args.variant)
    failed = check(libs, dev, card)
    libs = {k: v for k, v in libs.items() if k not in failed}
    if not args.no_times and libs:
        alone(libs, dev, card)
        replay(libs, [m for m in args.matrices.split(",") if m], dev, card)
    print(card)
    return 1 if "change" in failed else 0


if __name__ == "__main__":
    sys.exit(main())
