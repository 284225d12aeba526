#!/usr/bin/env python3
"""The port's chained loops as captured CUDA graphs against the eager loops
they replace, on one card.

    python3 scripts/torch_probe_graphs.py tune [--out FILE]
    python3 scripts/torch_probe_graphs.py corpus [NAME ...] [--out FILE]
    python3 scripts/torch_probe_graphs.py check [NAME ...] [--out FILE]
    python3 scripts/torch_probe_graphs.py solve [systems] [cli] [exact] [--root DIR] [--label L]
                                                [--out FILE]
    python3 scripts/torch_probe_graphs.py iteration [--root DIR] [--label L] [--out FILE]

``tune`` holds F-1 (``ops/feedback.py``, the chain's feedback kernel)
against its plain version (float64 and float32; SpMV square and
rectangular, SpMM; the bench's data, where the multiplier rounds to 1 and x
must come out bit for bit, and data large enough that it does not), then
sweeps the graph length ``unroll`` of ``utils.graphs.Loop`` on the bench's
swell chain (rajat03, TSOPF_RS_b2383, boneS10: µs an iteration at the bench's
loop lengths, capture seconds, graph memory) and the CG block ``block`` of
``models.cg.CGBlocks`` (Jacobi and ILU on Ga41As41H72-SPD and 512^2
anisotropic diffusion: iterations, x bit for bit against the eager loop, wall
seconds of the solve).  These set ``graphs.UNROLL`` and ``cg.CG_BLOCK``.

``corpus`` runs, for each matrix of the bench's corpus (default: all 20, large
set first), the bench's chained loop eagerly (the loop the port ran before
graphs: ``swell_ax``, then the feedback as PyTorch ops, every launch from the
host) and captured (``make_swell_run``), in turns eager, captured, captured,
eager, at the bench's loop lengths (``bench._slope_us``, the loop grown as
``bench_matrix`` grows it), and x after the loop, bit for bit; then SpMM k = 8
on TSOPF_RS_b2383 and boneS10, and CG on Ga41As41H72-SPD and 512^2 aniso
(Jacobi, ILU with 3 sweeps) eager against captured: iterations, x, the
solve's wall seconds (``cg_solve`` as called, any capture included; then a
``CGBlocks`` whose graphs are kept, in turns with the eager loop) and, on
aniso, µs an iteration of the fixed-trip loops (``bench.ANISO_TRIPS``); and
F-1's device µs (``torch.profiler``) beside its bound and the eager
sequence's.  Run it in three calls for the spread between calls.

``check`` runs, for each matrix of the corpus and the SpMM chains, the
captured chain on data that moves x (x and y scaled until the multiplier is
1 + 1e-9 a step, so that x after ``UNROLL + 3`` steps depends on every
product): x bit for bit the same steps launched from the host, and within
n·(1e-5·(multiplier - 1) + 4 ulps) relative of the eager PyTorch chain.

``solve`` times the solver as a user calls it, on the tree at ``--root``
(default: this one; an unpacked ``git archive`` of another commit to compare
two: run it once a tree, in turns, in one call, each line tagged
``--label``), in sections (default: all three):

* **systems**: ``cg_solve`` three times on Ga41As41H72-SPD, 512^2 aniso,
  af23560-SPD and dw4096-SPD (Jacobi; ILU(0) with 3 sweeps, the last two with
  ``ilu0``'s default: 6 sweeps on af23560, the exact solves on dw4096): wall
  seconds and iterations.  Where ``models.cg`` has ``CGBlocks``, also the
  capture's cost: a ``CGBlocks`` captured from the first iteration, its
  first solve against its second, beside the eager loop's seconds an
  iteration;
* **cli**: ``spmv-solve`` as a process on Ga41As41H72, af23560 and dw4096
  (Jacobi, ``ilu0``): wall seconds and iterations;
* **exact**: the exact ILU(0) (``ilu0(sweeps=0)``) on 512^2 aniso,
  dw4096-SPD and af23560-SPD: one apply (``ILU0.solve``, device ms a call
  in a host-launched loop of 3, the middle of three loops), the first call
  of a ``CGBlocks`` of 8 iterations captured from the first (seconds with
  the capture, graph memory, x against the eager loop's), and on dw4096-SPD
  and af23560-SPD ``cg_solve`` as called at tol 1e-8, four walls.

``iteration`` times a CG iteration of the tree at ``--root`` (default: this
one; an unpacked ``git archive`` of another commit to compare two: run it
once a tree, in turns, in one call, each line tagged ``--label``).  Only
entry points both trees have are called:

* **aniso jacobi** and **aniso ilu** (``--nx``^2 anisotropic diffusion,
  512^2 by default, ILU with 3 sweeps on the swell kernel): ``cg_solve`` as called at tol 1e-8
  (iterations, wall seconds, the first call with its capture), and
  ``CGBlocks`` captured from the first iteration at tol 0: µs an iteration
  as the bench's ``timed_cg`` takes it (``bench._slope_us`` over fixed trips
  of 65 and 513), the eager loop (``_cg_loop``) the same way, and in a
  profiled captured solve of 64 iterations the device µs an iteration by
  kernel (``torch.profiler``) and the kernels launched an iteration;
* **f2** (a tree with ``ops/cg_update.py`` only): each F-2 phase alone at
  the aniso system's n and at 23,560 (Jacobi form; the latter is mostly the
  launch's fixed cost) and at ``--dist-rows`` (identity), and
  where the tree has it the fused ``cg_step``: device µs a call in a loop of
  20 (L2-warm, as in the CG loop), in a replayed graph of 20
  (``utils.timer.graph_us``) and after a 256 MB write (from HBM, the median
  of 21; the three phases also in sequence), its plain version's, and the eager PyTorch
  sequence F-2 replaces (``cg_update.eager_step``) host-launched and in a
  graph, beside the bound (the vectors the iteration must read and write
  once, over 3352.32 GB/s);
* **Ga41As41H72-SPD solve**: ``cg_solve`` as called (Jacobi, ILU with 3
  sweeps), six times each: its 10 / 4 iterations all in the plain start,
  every F-2 call launched from the host (wall seconds);
* **dist swell**: ``dist_swell_cg_solve`` at world size 1 (an NCCL group
  joined through a file under ``build/``) on the dry run's SPD recipe at
  ``--dist-rows`` rows as called at tol 1e-8, and its ``dist_cg_blocks``
  captured from the first iteration at tol 0: µs an iteration over fixed
  trips of 9 and 73, and the profiled split.

Every line is one JSON object (also appended to ``--out``); the last line is
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_GBS = 3352.32  # H100 SXM HBM3 (utils.stats.chip_peak_gbs)
OUT = None
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the tree imported


def emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if OUT:
        with open(OUT, "a") as f:
            f.write(line + "\n")


def card_text() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def eager_feedback(x, ax, y=None):
    """The feedback as the port ran it before graphs: PyTorch ops, out of place."""
    s = (ax if y is None else 1.0 * ax + 1.0 * y).float()
    return x * (1.0 + (s * s).mean().to(x.dtype) * 1e-30)


def eager_chain(layout, x, y, n):
    from spmv_acc_tpu_torch.ops import swell

    for _ in range(n):
        x = eager_feedback(x, swell.swell_ax(layout, x), y)
    return x


def eager_amx_chain(layout, X, n):
    from spmv_acc_tpu_torch.ops import swell

    for _ in range(n):
        X = eager_feedback(X, swell.swell_amx(layout, X))
    return X


def device_us(fn, n=20):
    """Device µs per call of ``fn``: every CUDA kernel's time by
    torch.profiler over ``n`` calls, summed, over ``n``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if "CUDA" in str(getattr(e, "device_type", "")):
            total += getattr(e, "device_time_total", 0.0) or e.cuda_time_total
    return total / n


def measured_slope(run, nnz, dev):
    """``bench_matrix``'s measurement: the slope at 1 + it // 4 and 1 + it,
    the loop grown until it spans 20 ms."""
    from spmv_acc_tpu_torch import bench

    it = bench._iters_for(nnz)
    per = 0.0
    for _ in range(3):
        per = bench._slope_us(run, 1 + it // 4, 1 + it, dev)
        if per > 0 and per * (it - it // 4) > 20e3:
            break
        it = min(it * 4, 65536)
    return per, it


def captured_first(fn):
    """(seconds, bytes of device memory the call added at its peak) of ``fn()``."""
    gc.collect()  # what an earlier loop left in reference cycles is freed here, not inside
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base


def check_feedback(dev):
    """F-1 against its plain version; bits where the multiplier is 1."""
    from spmv_acc_tpu_torch.ops import feedback

    rng = np.random.default_rng(3)
    for dtype in (torch.float64, torch.float32):
        for label, m, n, k, scale, has_y in (("spmv square", 300001, 300001, 1, 1.0, True),
                                             ("spmv rect", 200003, 41, 1, 1.0, True),
                                             ("spmv square big", 300001, 300001, 1, 1e11, True),
                                             ("spmm k=8", 100003, 100003, 8, 1.0, False),
                                             ("spmm k=8 big", 100003, 100003, 8, 1e11, False)):
            shape_ax, shape_x = ((m,), (n,)) if k == 1 else ((m, k), (n, k))
            ax = torch.from_numpy(rng.uniform(-1, 1, shape_ax) * scale).to(dev, dtype)
            y = torch.from_numpy(rng.uniform(-1, 1, shape_ax) * scale).to(dev, dtype) if has_y else None
            x = torch.from_numpy(rng.uniform(-1, 1, shape_x)).to(dev, dtype)
            p = feedback.feedback_plain(x, ax, y, 2.0, -0.5)
            kx = feedback.feedback_(x.clone(), ax, y, 2.0, -0.5)
            torch.cuda.synchronize()
            err = float((kx - p).abs().max())
            rel = float(((kx - p).abs() / p.abs().clamp(min=1e-300)).max())
            emit({"probe": "feedback", "case": label, "dtype": str(dtype), "m": m, "n": n, "k": k,
                  "bits_equal": bool(torch.equal(kx, p)), "moved": bool(not torch.equal(p, x)),
                  "max_abs_err": err, "max_rel_err": rel})


def tune_unroll(dev, card):
    from spmv_acc_tpu_torch import bench
    from spmv_acc_tpu_torch.formats.generate import example_like, random_x_y
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.ops.feedback import feedback_
    from spmv_acc_tpu_torch.utils.graphs import Loop

    for name in ("rajat03", "TSOPF_RS_b2383", "boneS10"):
        host = example_like(name)
        csr = host.to(dev)
        x, y = (torch.from_numpy(a).to(dev) for a in random_x_y(csr.cols, csr.rows, seed=42))
        layout = swell.get_swell_plan(csr)
        it = bench._iters_for(csr.nnz)
        eager = [bench._slope_us(lambda n: eager_chain(layout, x, y, n), 1 + it // 4, 1 + it, dev)
                 for _ in range(2)]
        ref = eager_chain(layout, x, y, 1 + it)
        for unroll in (1, 4, 16, 64, 256):
            loop = Loop(lambda v: feedback_(v, swell.swell_ax(layout, v), y), x, unroll=unroll)
            secs, mem = captured_first(lambda: loop.run(x, unroll))
            per = [bench._slope_us(lambda n: loop.run(x, n), 1 + it // 4, 1 + it, dev)
                   for _ in range(2)]
            same = bool(torch.equal(loop.run(x, 1 + it), ref))
            emit({"probe": "unroll", "name": name, "unroll": unroll, "iters": it,
                  "eager_us": eager, "captured_us": per, "capture_s": secs,
                  "graph_bytes": mem, "bits_equal": same, "card": card})
            del loop
            torch.cuda.empty_cache()
        swell.clear_swell_cache()


def solver_systems(dev):
    """(label, csr, b, x_true, {precond name: preconditioner}) of the bench's two
    solver workloads."""
    from spmv_acc_tpu_torch.cli.solve import spdize
    from spmv_acc_tpu_torch.formats.containers import CSR
    from spmv_acc_tpu_torch.formats.generate import example_like
    from spmv_acc_tpu_torch.models.cg import jacobi_preconditioner
    from spmv_acc_tpu_torch.ops.golden import host_spmv
    from spmv_acc_tpu_torch.ops.trisolve import ilu0

    rp, ci, v, (m, _) = example_like("Ga41As41H72").to_numpy()
    rp2, ci2, v2 = spdize(rp.astype(np.int64), ci.astype(np.int64), v, m)
    ga = CSR.from_numpy(rp2, ci2, v2, (m, m), device=dev)
    x_true = np.random.default_rng(5).standard_normal(m)
    gb = torch.from_numpy(host_spmv(1.0, 0.0, rp2, ci2, v2, x_true, np.zeros(m))).to(dev)
    yield ("Ga41As41H72-SPD", ga, gb, 300,
           {"jacobi": jacobi_preconditioner(ga), "ilu": ilu0(ga, sweeps=3)})
    yield aniso_system(dev)


def aniso_system(dev, nx=512):
    """The bench's aniso solver workload (nx^2 anisotropic diffusion, eps
    1e-4, b from x_true of seed 5), as ``solver_systems`` yields it."""
    from spmv_acc_tpu_torch.formats.generate import aniso_laplacian_csr
    from spmv_acc_tpu_torch.models.cg import jacobi_preconditioner
    from spmv_acc_tpu_torch.ops.golden import host_spmv
    from spmv_acc_tpu_torch.ops.trisolve import ilu0

    host = aniso_laplacian_csr(nx, nx, 1e-4)
    an = host.to(dev)
    arp, aci, av, (am, _) = host.to_numpy()
    ax_true = np.random.default_rng(5).standard_normal(am)
    ab = torch.from_numpy(host_spmv(1.0, 0.0, arp, aci, av, ax_true, np.zeros(am))).to(dev)
    return (f"aniso {nx}^2", an, ab, 4000,
            {"jacobi": jacobi_preconditioner(an), "ilu": ilu0(an, sweeps=3)})


def solve_wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res


def tune_block(dev, card):
    from spmv_acc_tpu_torch.models.cg import CGBlocks, _cg_loop
    from spmv_acc_tpu_torch.ops import swell

    for label, csr, b, max_iters, pres in solver_systems(dev):
        layout = swell.get_swell_plan(csr)

        def matvec(v):
            return swell.swell_ax(layout, v)

        for pname, pre in pres.items():
            M = pre.solve if hasattr(pre, "solve") else pre
            x0 = torch.zeros_like(b)
            walls = [solve_wall(lambda: _cg_loop(matvec, M, b, x0, 1e-8, max_iters))
                     for _ in range(2)]
            ref = walls[-1][1]
            for block in (4, 8, 16, 32, 64):
                solver = CGBlocks(matvec, M, b, block=block)
                first, res = solve_wall(lambda: solver.solve(b, x0, 1e-8, max_iters))
                again = [solve_wall(lambda: solver.solve(b, x0, 1e-8, max_iters))[0]
                         for _ in range(2)]
                emit({"probe": "block", "system": label, "precond": pname, "block": block,
                      "iters": res.iters, "eager_iters": ref.iters,
                      "bits_equal": bool(torch.equal(res.x, ref.x)),
                      "eager_wall_s": [w for w, _ in walls], "first_wall_s": first,
                      "wall_s": again, "card": card})
                del solver
                torch.cuda.empty_cache()
        swell.clear_swell_cache()


def corpus(names, dev, card):
    from spmv_acc_tpu_torch import bench
    from spmv_acc_tpu_torch.formats.generate import example_like, random_x_y
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.utils.stats import bytes_moved

    for name in names:
        host = example_like(name)
        csr = host.to(dev)
        x, y = (torch.from_numpy(a).to(dev) for a in random_x_y(csr.cols, csr.rows, seed=42))
        layout = swell.get_swell_plan(csr)
        run_c = swell.make_swell_run(csr)
        secs, mem = captured_first(lambda: run_c(x, y, 1 + bench._iters_for(csr.nnz)))
        eager, captured = [], []
        for turn in ("eager", "captured", "captured", "eager"):
            if turn == "eager":
                per, it = measured_slope(lambda n: eager_chain(layout, x, y, n), csr.nnz, dev)
                eager.append(per)
            else:
                per, it = measured_slope(lambda n: run_c(x, y, n), csr.nnz, dev)
                captured.append(per)
        same = bool(torch.equal(run_c(x, y, it), eager_chain(layout, x, y, it)))
        nb = bytes_moved(csr.rows, csr.nnz, 8)
        emit({"probe": "corpus", "name": name, "m": csr.rows, "n": csr.cols, "nnz": csr.nnz,
              "r": layout.r, "iters": it, "eager_us": eager, "captured_us": captured,
              "roofline_eager": [nb / (u * 1e-6) / 1e9 / PEAK_GBS for u in eager],
              "roofline_captured": [nb / (u * 1e-6) / 1e9 / PEAK_GBS for u in captured],
              "capture_s": secs, "graph_bytes": mem, "bits_equal": same, "card": card})
        del run_c, layout, csr, host, x, y
        swell.clear_swell_cache()
        torch.cuda.empty_cache()


def spmm(dev, card):
    from spmv_acc_tpu_torch import bench
    from spmv_acc_tpu_torch.formats.generate import example_like
    from spmv_acc_tpu_torch.ops import swell

    for name in bench.SPMM_MATRICES:
        csr = example_like(name).to(dev)
        rng = np.random.default_rng(7)
        X = torch.from_numpy(rng.uniform(-1, 1, size=(csr.cols, bench.SPMM_K))).to(dev)
        layout = swell.get_swell_plan(csr)
        run_c = swell.make_swell_amx_run(csr, bench.SPMM_K)
        iters = max(16, bench._iters_for(csr.nnz) // bench.SPMM_K)
        n0, n1 = 1 + iters // 4, 1 + iters
        secs, mem = captured_first(lambda: run_c(X, n1))
        e1 = bench._slope_us(lambda n: eager_amx_chain(layout, X, n), n0, n1, dev)
        c1 = bench._slope_us(lambda n: run_c(X, n), n0, n1, dev)
        c2 = bench._slope_us(lambda n: run_c(X, n), n0, n1, dev)
        e2 = bench._slope_us(lambda n: eager_amx_chain(layout, X, n), n0, n1, dev)
        same = bool(torch.equal(run_c(X, n1), eager_amx_chain(layout, X, n1)))
        emit({"probe": "spmm", "name": name, "k": bench.SPMM_K, "iters": iters,
              "eager_us": [e1, e2], "captured_us": [c1, c2], "capture_s": secs,
              "graph_bytes": mem, "bits_equal": same, "card": card})
        swell.clear_swell_cache()
        torch.cuda.empty_cache()


def cg(dev, card):
    from spmv_acc_tpu_torch import bench
    from spmv_acc_tpu_torch.models.cg import CGBlocks, _cg_loop, cg_solve
    from spmv_acc_tpu_torch.ops import swell

    for label, csr, b, max_iters, pres in solver_systems(dev):
        layout = swell.get_swell_plan(csr)

        def matvec(v):
            return swell.swell_ax(layout, v)

        for pname, pre in pres.items():
            M = pre.solve if hasattr(pre, "solve") else pre
            x0 = torch.zeros_like(b)
            # cg_solve as a user calls it: plain iterations, then captured blocks
            first, c_res = solve_wall(lambda: cg_solve(csr, b, tol=1e-8, max_iters=max_iters,
                                                       strategy="swell", precond=pre))
            solver = CGBlocks(matvec, M, b)
            secs, mem = captured_first(lambda: solver.solve(b, x0, 1e-8, max_iters))
            e_res = _cg_loop(matvec, M, b, x0, 1e-8, max_iters)
            walls = {"eager": [], "captured": []}  # the captured solver's graphs kept
            for which in ("eager", "captured", "captured", "eager"):
                fn = ((lambda: _cg_loop(matvec, M, b, x0, 1e-8, max_iters)) if which == "eager"
                      else (lambda: solver.solve(b, x0, 1e-8, max_iters)))
                walls[which].append(solve_wall(fn)[0])
            per = {}
            if label.startswith("aniso"):  # Ga41As41H72-SPD's residual reaches 0 before 513
                def eager_run(n):
                    return _cg_loop(matvec, M, b, x0, 0.0, n).residual_norm

                def captured_run(n):
                    return solver.solve(b, x0, 0.0, n).residual_norm

                per = {"eager_us": [], "captured_us": []}
                for key, fn in (("eager_us", eager_run), ("captured_us", captured_run),
                                ("captured_us", captured_run), ("eager_us", eager_run)):
                    per[key].append(bench._slope_us(fn, *bench.ANISO_TRIPS, dev))
            emit({"probe": "cg", "system": label, "precond": pname, "iters": c_res.iters,
                  "eager_iters": e_res.iters, "bits_equal": bool(torch.equal(c_res.x, e_res.x)),
                  "cg_solve_wall_s": first, "solve_wall_s_eager": walls["eager"],
                  "solve_wall_s_captured": walls["captured"], "first_solve_s": secs,
                  "graph_bytes": mem, **per, "card": card})
            del solver
            torch.cuda.empty_cache()
        swell.clear_swell_cache()


def feedback_times(dev, card):
    """F-1's device µs against its bound and the eager sequence, at the
    shapes of the bench's boneS10 and Hardesty3 chains (float64 SpMV)."""
    from spmv_acc_tpu_torch.ops import feedback

    rng = np.random.default_rng(4)
    for label, m, n in (("boneS10", 914898, 914898), ("Hardesty3", 8217820, 7591564)):
        ax = torch.from_numpy(rng.uniform(-1, 1, m)).to(dev)
        y = torch.from_numpy(rng.uniform(-1, 1, m)).to(dev)
        x = torch.from_numpy(rng.uniform(-1, 1, n)).to(dev)
        k_us = device_us(lambda: feedback.feedback_(x, ax, y))
        e_us = device_us(lambda: eager_feedback(x, ax, y))
        p_us = device_us(lambda: feedback.feedback_plain(x, ax, y))
        bound_us = (16 * m + 16 * n) / (PEAK_GBS * 1e9) * 1e6
        emit({"probe": "feedback_time", "shape": label, "m": m, "n": n, "kernel_us": k_us,
              "eager_us": e_us, "plain_us": p_us, "bound_us": bound_us, "card": card})


def moving_check(label, layout, x, y, run, card):
    """``run``'s chain on data that moves x against the eager steps (bits)
    and the eager PyTorch chain (tolerance): one JSON line."""
    from spmv_acc_tpu_torch.ops import feedback, swell
    from spmv_acc_tpu_torch.utils.graphs import UNROLL

    def product(v):
        return swell.swell_ax(layout, v) if y is not None else swell.swell_amx(layout, v)

    def sq_mean(t):
        return float((t.float() ** 2).mean())

    ax = product(x)
    sigma = (1e21 / sq_mean(ax if y is None else ax + y)) ** 0.5
    xm, ym = x * sigma, (None if y is None else y * sigma)
    n = UNROLL + 3
    got = run(xm, ym, n)
    steps = []
    for _ in range(2):
        v = xm.clone()
        for _ in range(n):
            feedback.feedback_(v, product(v), ym)
        steps.append(v)
    plain = xm
    for _ in range(n):
        plain = eager_feedback(plain, product(plain), ym)
    axm = product(xm)
    mult = sq_mean(axm if y is None else axm + ym) * 1e-30
    rel = ((got - plain).abs() / plain.abs().clamp(min=1e-300)).max()
    emit({"probe": "check", "name": label, "steps": n, "multiplier_minus_1": mult,
          "product_share": 1.0 if y is None else sq_mean(axm) / sq_mean(axm + ym),
          "x_moved": float(((got - xm).abs() / xm.abs()).max()),
          "eager_steps_repeat": bool(torch.equal(steps[0], steps[1])),
          "bits_equal_eager_steps": bool(torch.equal(got, steps[0])),
          "max_rel_vs_pytorch_chain": float(rel), "allowed": n * (1e-5 * mult + 4 * 2.0**-52),
          "card": card})


def check(names, dev, card):
    from spmv_acc_tpu_torch import bench
    from spmv_acc_tpu_torch.formats.generate import example_like, random_x_y
    from spmv_acc_tpu_torch.ops import swell

    for name in names:
        csr = example_like(name).to(dev)
        x, y = (torch.from_numpy(a).to(dev) for a in random_x_y(csr.cols, csr.rows, seed=42))
        layout = swell.get_swell_plan(csr)
        moving_check(name, layout, x, y, swell.make_swell_run(csr), card)
        if name in bench.SPMM_MATRICES:
            X = torch.from_numpy(np.random.default_rng(7).uniform(
                -1, 1, size=(csr.cols, bench.SPMM_K))).to(dev)
            run_amx = swell.make_swell_amx_run(csr, bench.SPMM_K)
            moving_check(f"{name} SpMM k={bench.SPMM_K}", layout, X, None,
                         lambda v, _, n: run_amx(v, n), card)
        del layout, csr, x, y
        swell.clear_swell_cache()
        torch.cuda.empty_cache()


def solve_exact(dev, card, tag):
    """The ``exact`` section of ``solve``."""
    from spmv_acc_tpu_torch.cli.solve import spdize
    from spmv_acc_tpu_torch.formats.containers import CSR
    from spmv_acc_tpu_torch.formats.generate import example_like
    from spmv_acc_tpu_torch.models.cg import CGBlocks, _cg_loop, cg_solve
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.ops.golden import host_spmv
    from spmv_acc_tpu_torch.ops.trisolve import ilu0

    def spd_system(name):
        rp, ci, v, (m, _) = example_like(name).to_numpy()
        rp2, ci2, v2 = spdize(rp.astype(np.int64), ci.astype(np.int64), v, m)
        csr = CSR.from_numpy(rp2, ci2, v2, (m, m), device=dev)
        x_true = np.random.default_rng(5).standard_normal(m)
        b = torch.from_numpy(host_spmv(1.0, 0.0, rp2, ci2, v2, x_true, np.zeros(m))).to(dev)
        return f"{name}-SPD", csr, b

    label, an, ab, _, _ = aniso_system(dev)
    for system, csr, b in ((label, an, ab), spd_system("dw4096"), spd_system("af23560")):
        t0 = time.perf_counter()
        fact = ilu0(csr, sweeps=0)
        torch.cuda.synchronize()
        rec = {"probe": "solve exact", "label": tag, "system": system,
               "factor_s": time.perf_counter() - t0,
               "levels": [fact.l_plan.num_levels, fact.u_plan.num_levels],
               "apply_ms": events_us(lambda: fact.solve(b), 3) / 1e3}
        layout = swell.get_swell_plan(csr)

        def mv(v):
            return swell.swell_ax(layout, v)

        x0 = torch.zeros_like(b)
        eager = [_cg_loop(mv, fact.solve, b, x0, 0.0, 8).x for _ in range(2)]
        box = []
        block = CGBlocks(mv, fact.solve, b, eager_iters=0)
        secs, mem = captured_first(lambda: box.append(block.solve(b, x0, 0.0, 8)))
        rec.update({"captured_block_first_call_s": secs, "graph_memory_B": mem,
                    "captured_iters": box[0].iters,
                    "captured_x_equals_eager": torch.equal(box[0].x, eager[0]),
                    "eager_repeats": torch.equal(eager[0], eager[1])})
        del block, box
        if system != label:
            walls = [solve_wall(lambda: cg_solve(csr, b, tol=1e-8, max_iters=1000,
                                                 strategy="swell", precond=fact))
                     for _ in range(4)]
            rec.update({"iters": walls[0][1].iters, "cg_solve_wall_s": [w for w, _ in walls]})
        emit({**rec, "card": card})
        swell.clear_swell_cache()
        torch.cuda.empty_cache()


def solve(dev, card, tag="", sections=("systems", "cli", "exact")):
    import tempfile

    from spmv_acc_tpu_torch.cli.solve import spdize
    from spmv_acc_tpu_torch.formats.containers import CSR
    from spmv_acc_tpu_torch.formats.generate import example_like
    from spmv_acc_tpu_torch.io.binary import write_bin2
    from spmv_acc_tpu_torch.models import cg as cg_mod
    from spmv_acc_tpu_torch.models.cg import _cg_loop, cg_solve, jacobi_preconditioner
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.ops.golden import host_spmv
    from spmv_acc_tpu_torch.ops.trisolve import ILU0, ilu0

    def spd_system(name):
        rp, ci, v, (m, _) = example_like(name).to_numpy()
        rp2, ci2, v2 = spdize(rp.astype(np.int64), ci.astype(np.int64), v, m)
        csr = CSR.from_numpy(rp2, ci2, v2, (m, m), device=dev)
        x_true = np.random.default_rng(5).standard_normal(m)
        b = torch.from_numpy(host_spmv(1.0, 0.0, rp2, ci2, v2, x_true, np.zeros(m))).to(dev)
        return (f"{name}-SPD", csr, b, 1000, {"jacobi": jacobi_preconditioner(csr),
                                              "ilu default": ilu0(csr)})

    if "exact" in sections:
        solve_exact(dev, card, tag)
    systems = ([] if "systems" not in sections else
               list(solver_systems(dev)) + [spd_system("af23560"), spd_system("dw4096")])
    for label, csr, b, max_iters, pres in systems:
        layout = swell.get_swell_plan(csr)

        def matvec(v):
            return swell.swell_ax(layout, v)

        for pname, pre in pres.items():
            walls = [solve_wall(lambda: cg_solve(csr, b, tol=1e-8, max_iters=max_iters,
                                                 strategy="swell", precond=pre))
                     for _ in range(3)]
            rec = {"probe": "solve", "label": tag, "system": label, "precond": pname,
                   "sweeps": pre.sweeps if isinstance(pre, ILU0) else None,
                   "iters": walls[0][1].iters, "cg_solve_wall_s": [w for w, _ in walls]}
            if hasattr(cg_mod, "CG_EAGER_ITERS"):
                M = pre.solve if isinstance(pre, ILU0) else pre
                x0 = torch.zeros_like(b)
                eager = min(solve_wall(lambda: _cg_loop(matvec, M, b, x0, 1e-8, max_iters))[0]
                            for _ in range(2))
                solver = cg_mod.CGBlocks(matvec, M, b, eager_iters=0)
                first, res = solve_wall(lambda: solver.solve(b, x0, 1e-8, max_iters))
                again = min(solve_wall(lambda: solver.solve(b, x0, 1e-8, max_iters))[0]
                            for _ in range(2))
                rec.update({"eager_wall_s": eager, "eager_us_an_iteration":
                            eager / max(res.iters, 1) * 1e6, "captured_first_s": first,
                            "captured_again_s": again, "capture_s": first - again,
                            "block": cg_mod.CG_BLOCK, "eager_iters": cg_mod.CG_EAGER_ITERS})
                del solver
            emit({**rec, "card": card})
            torch.cuda.empty_cache()
        swell.clear_swell_cache()
    if "cli" not in sections:
        return
    with tempfile.TemporaryDirectory() as td:
        for name in ("Ga41As41H72", "af23560", "dw4096"):
            path = os.path.join(td, f"{name}.bin2")
            write_bin2(path, *example_like(name).to_numpy())
            for pre in ("jacobi", "ilu0"):
                t0 = time.perf_counter()
                out = subprocess.run([sys.executable, "-m", "spmv_acc_tpu_torch.cli.solve", path,
                                      "-f", "bin2", "--precond", pre], cwd=ROOT,
                                     capture_output=True, text=True)
                wall = time.perf_counter() - t0
                lines = out.stdout.strip().splitlines()
                emit({"probe": "spmv-solve", "label": tag, "name": name, "precond": pre, "rc": out.returncode,
                      "process_wall_s": wall, "output": lines[-2:] if lines else out.stderr[-400:],
                      "card": card})


def split_us(run, iters):
    """Device µs an iteration by kernel in one profiled ``run()`` of ``iters``
    iterations (after one unprofiled run), the kernels launched an
    iteration, and the busy µs an iteration outside NCCL's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    on_dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(on_dev, key=lambda e: e.self_device_time_total, reverse=True)
    nccl = sum(e.self_device_time_total for e in on_dev if "nccl" in e.key.lower())
    return {"busy us": (sum(e.self_device_time_total for e in on_dev) - nccl) / iters,
            "nccl kernels us": nccl / iters,
            "launches": sum(e.count for e in on_dev) / iters,
            "by kernel (us, launches an iteration)": {
                e.key[:90]: [e.self_device_time_total / iters, e.count / iters]
                for e in top[:12]}}


def events_us(fn, n=20):
    """Device µs a call of ``fn`` in a host-launched loop of ``n`` (CUDA
    events; the middle of three loops)."""
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(3):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        t1.synchronize()
        got.append(t0.elapsed_time(t1) * 1e3 / n)
    return sorted(got)[1]


def guarded(label, fn, tag):
    """Run one section; a failure is recorded and the next section runs."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001  (recorded in the output)
        import traceback

        emit({"probe": "iteration", "label": tag, "loop": label,
              "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-3000:]})


def iteration(dev, card, tag, dist_rows, nx):
    import shutil
    import tempfile

    from spmv_acc_tpu_torch import bench
    from spmv_acc_tpu_torch.models import cg
    from spmv_acc_tpu_torch.ops import _build, swell

    def out(rec):
        emit({"probe": "iteration", "label": tag, **rec, "card": card})

    _build.build_all()
    system, csr, b, _, pres = aniso_system(dev, nx)
    x0 = torch.zeros_like(b)
    layout = swell.get_swell_plan(csr)

    def mv(v):
        return swell.swell_ax(layout, v)

    def aniso(name, pre):
        first, res = solve_wall(lambda: cg.cg_solve(csr, b, tol=1e-8, max_iters=4000,
                                                    strategy="swell", precond=pre))
        again, res2 = solve_wall(lambda: cg.cg_solve(csr, b, tol=1e-8, max_iters=4000,
                                                     strategy="swell", precond=pre))
        M = pre.solve if name == "ilu" else pre
        solver = cg.CGBlocks(mv, M, b, eager_iters=0)
        captured = [bench._slope_us(lambda n: solver.solve(b, x0, 0.0, n).residual_norm, 65, 513,
                                    dev) for _ in range(3)]
        eager = [bench._slope_us(lambda n: cg._cg_loop(mv, M, b, x0, 0.0, n).residual_norm,
                                 65, 513, dev) for _ in range(2)]
        out({"loop": f"{system} {name}", "iters": [res.iters, res2.iters],
             "solve s (first call, capture included)": first, "solve s again": again,
             "captured us an iteration": captured, "eager us an iteration": eager,
             "captured split": split_us(lambda: solver.solve(b, x0, 0.0, 64), 64)})

    guarded("aniso jacobi", lambda: aniso("jacobi", pres["jacobi"]), tag)
    guarded("aniso ilu", lambda: aniso("ilu", pres["ilu"]), tag)

    try:  # F-2 alone: this tree only
        from spmv_acc_tpu_torch.ops import cg_update as cu
        from spmv_acc_tpu_torch.utils.timer import graph_us
    except ImportError:
        cu = None
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)

    def cold_us(fn, n=21):
        fn()
        got = []
        for _ in range(n):
            flush.zero_()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            got.append(t0.elapsed_time(t1) * 1e3)
        return sorted(got)[n // 2]

    def f2(nn, form):
        rng = np.random.default_rng(nn)

        def vec(lo=-1.0, hi=1.0):
            return torch.from_numpy(rng.uniform(lo, hi, nn)).to(dev)

        carry = (vec(), vec(), vec(), torch.tensor(1.0, device=dev, dtype=torch.float64),
                 torch.tensor(1.0, device=dev, dtype=torch.float64),
                 torch.zeros((), dtype=torch.int64, device=dev))
        apv, inv = vec(), (vec(0.5, 2.0) if form == "jacobi" else None)
        work = cu.Work(carry[0])
        tol2 = torch.tensor(0.0, dtype=torch.float64, device=dev)
        mx = torch.tensor(1 << 60, dtype=torch.int64, device=dev)
        phases = {
            "cg_dot": (lambda: cu.cg_dot(carry[2], apv, work, cu.PAP),
                       lambda: cu.cg_dot_plain(carry[2], apv, work, cu.PAP)),
            "cg_xr": (lambda: cu.cg_xr(carry, apv, work, inv, True, tol2, mx),
                      lambda: cu.cg_xr_plain(carry, apv, work, inv, True, tol2, mx)),
            "cg_p": (lambda: cu.cg_p(carry, work, inv, None, tol2, mx),
                     lambda: cu.cg_p_plain(carry, work, inv, None, tol2, mx))}
        rec = {}
        for ph, (kern, plain) in phases.items():
            work.sums.fill_(1e30)  # alpha ~ 0 in cg_xr: x and r stay put over the repeats
            rec[ph] = {"kernel us (loop of 20, L2-warm)": events_us(kern),
                       "kernel us in a graph of 20": graph_us(kern),
                       "kernel us from HBM": cold_us(kern),
                       "plain us (loop of 20)": events_us(plain)}

        # an iteration's worth from HBM: Ap = 1e30 p keeps x, r and the sums bounded
        # over the repeats (p grows by z a call)
        fcarry = tuple(t.clone() for t in carry)
        fap, fwork = 1e30 * fcarry[2], cu.Work(fcarry[0])

        def three():
            cu.cg_dot(fcarry[2], fap, fwork, cu.PAP)
            cu.cg_xr(fcarry, fap, fwork, inv, True, tol2, mx)
            cu.cg_p(fcarry, fwork, inv, None, tol2, mx)

        graphs = []

        def replay_of(fn):
            """``fn``'s launches captured once in a CUDA graph: its replay."""
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            graphs.append(g)
            return g.replay

        rec["the three phases us from HBM (a captured iteration)"] = cold_us(replay_of(three))
        if hasattr(cu, "cg_step"):  # the fused form, on the same data
            def step():
                cu.cg_step(fcarry, fap, fwork, inv, tol2, mx)

            rec["cg_step"] = {"kernel us (loop of 20, L2-warm)": events_us(step),
                              "kernel us in a graph of 20": graph_us(step),
                              "kernel us from HBM": cold_us(step),
                              "kernel us from HBM (a captured call)": cold_us(replay_of(step)),
                              "plain us (loop of 20)": events_us(
                                  lambda: cu.cg_step_plain(fcarry, fap, fwork, inv, tol2, mx))}
        M = (lambda r: r) if inv is None else (lambda r: inv * r)

        def eager_seq():
            return cu.eager_step(carry, apv, M, tol2, mx)

        vecs = 8 if form == "jacobi" else 7
        out({"loop": f"f2 {form} n={nn}", **rec,
             "sum of the phases us (L2-warm)": sum(rec[k]["kernel us (loop of 20, L2-warm)"]
                                                   for k in phases),
             "sum of the phases us in a graph": sum(rec[k]["kernel us in a graph of 20"]
                                                    for k in phases),
             "eager sequence us (loop of 20, host-launched)": events_us(eager_seq),
             "eager sequence us in a graph of 20": graph_us(eager_seq),
             "bound us": vecs * 8 * nn / (PEAK_GBS * 1e9) * 1e6, "bound vectors": vecs})

    if cu is not None:
        guarded("f2 jacobi", lambda: f2(csr.rows, "jacobi"), tag)
        guarded("f2 identity", lambda: f2(dist_rows, "identity"), tag)
        guarded("f2 jacobi small", lambda: f2(23560, "jacobi"), tag)  # af23560's n
    del flush

    def ga_solve():
        """cg_solve as called on Ga41As41H72-SPD: its 10 / 4 iterations all
        run in the plain start, each F-2 call launched from the host."""
        label, gcsr, gb, max_iters, gpres = next(solver_systems(dev))
        for name, pre in gpres.items():
            walls = [solve_wall(lambda: cg.cg_solve(gcsr, gb, tol=1e-8, max_iters=max_iters,
                                                    strategy="swell", precond=pre))
                     for _ in range(6)]
            out({"loop": f"{label} {name} cg_solve as called", "iters": walls[0][1].iters,
                 "wall s": [w for w, _ in walls], "best wall s": min(w for w, _ in walls),
                 "best us an iteration": min(w for w, _ in walls) / walls[0][1].iters * 1e6})
        swell.clear_swell_cache()

    guarded("Ga41As41H72-SPD solve", ga_solve, tag)

    from spmv_acc_tpu_torch.dryrun import _spd_fem
    from spmv_acc_tpu_torch.parallel.dist_spmv import make_mesh
    from spmv_acc_tpu_torch.parallel.dist_swell import (build_dist_swell, dist_swell_cg_solve,
                                                        dist_swell_spmv_fn, pad_global)
    from spmv_acc_tpu_torch.parallel.multihost import init_distributed, shutdown_distributed

    def dist_swell():
        spd = _spd_fem(dist_rows, np.float64)[3].to(dev)
        bd = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, spd.rows)).to(dev)
        mesh = make_mesh(1)
        first, res = solve_wall(lambda: dist_swell_cg_solve(spd, bd, mesh, tol=1e-8,
                                                            max_iters=400)[0])
        dsp = build_dist_swell(spd, 1, mesh=mesh)
        bl = pad_global(dsp, bd)[: dsp.rows_local].contiguous()
        solver = cg.dist_cg_blocks(dist_swell_spmv_fn(dsp, mesh), bl, mesh)
        solver.eager_iters = 0
        xz = torch.zeros_like(bl)
        captured = [bench._slope_us(lambda n: solver.solve(bl, xz, 0.0, n).residual_norm, 9, 73,
                                    dev) for _ in range(3)]
        out({"loop": f"dist swell m={dist_rows} world size 1", "iters": res.iters,
             "residual / |b|": float(res.residual_norm) / float(bd.norm()),
             "solve s (first call, capture included)": first,
             "captured us an iteration": captured,
             "captured split": split_us(lambda: solver.solve(bl, xz, 0.0, 64), 64)})

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    td = tempfile.mkdtemp(prefix="probe_iteration_", dir=_build.BUILD_DIR)
    init_distributed(coordinator_address="file://" + os.path.join(td, "rendezvous"),
                     num_processes=1, process_id=0, device="cuda")
    try:
        guarded("dist swell", dist_swell, tag)
    finally:
        gc.collect()  # the solver's graphs hold NCCL collectives: free them first
        shutdown_distributed()
        shutil.rmtree(td, ignore_errors=True)


def main(argv=None) -> int:
    global OUT, ROOT
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["tune", "corpus", "check", "solve", "iteration"])
    p.add_argument("names", nargs="*")
    p.add_argument("--out", default=None)
    p.add_argument("--root", default=ROOT, help="the tree whose spmv_acc_tpu_torch is imported")
    p.add_argument("--label", default="", help="tags the lines of `iteration` and `solve`")
    p.add_argument("--dist-rows", type=int, default=1_048_576)
    p.add_argument("--nx", type=int, default=512, help="the aniso grid of `iteration`")
    args = p.parse_args(argv)
    OUT, ROOT = args.out, os.path.abspath(args.root)
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import spmv_acc_tpu_torch
    from spmv_acc_tpu_torch import bench

    if not spmv_acc_tpu_torch.__file__.startswith(ROOT + os.sep):
        print(f"imported {spmv_acc_tpu_torch.__file__}, not from {ROOT}", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    card = card_text()
    if args.mode == "tune":
        check_feedback(dev)
        tune_unroll(dev, card)
        tune_block(dev, card)
    elif args.mode == "check":
        check(args.names or bench.LARGE + bench.SMALL, dev, card)
    elif args.mode == "solve":
        bad = set(args.names) - {"systems", "cli", "exact"}
        if bad:
            p.error(f"solve takes the sections systems, cli and exact, not {sorted(bad)}")
        solve(dev, card, args.label, tuple(args.names) or ("systems", "cli", "exact"))
    elif args.mode == "iteration":
        iteration(dev, card, args.label, args.dist_rows, args.nx)
    else:
        corpus(args.names or bench.LARGE + bench.SMALL, dev, card)
        if not args.names:
            spmm(dev, card)
            cg(dev, card)
            feedback_times(dev, card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
