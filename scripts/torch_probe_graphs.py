#!/usr/bin/env python3
"""The port's chained loops as captured CUDA graphs against the eager loops
they replace, on one card.

    python3 scripts/torch_probe_graphs.py tune [--out FILE]
    python3 scripts/torch_probe_graphs.py corpus [NAME ...] [--out FILE]
    python3 scripts/torch_probe_graphs.py check [NAME ...] [--out FILE]
    python3 scripts/torch_probe_graphs.py solve [--out FILE]

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

``solve`` times the solver as a user calls it, on the tree it runs from (run
it from a copy of another commit to compare two): ``cg_solve`` three times
on Ga41As41H72-SPD, 512^2 aniso, af23560-SPD and dw4096-SPD (Jacobi; ILU(0)
with 3 sweeps, the last two with ``ilu0``'s default: 6 sweeps on af23560, the
exact solves on dw4096), and ``spmv-solve`` as a process on Ga41As41H72,
af23560 and dw4096 (Jacobi, ``ilu0``): wall seconds and iterations.  Where ``models.cg`` has ``CGBlocks``, also the capture's cost: a
``CGBlocks`` captured from the first iteration, its first solve against its
second, beside the eager loop's seconds an iteration.

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
    from spmv_acc_tpu_torch.formats.generate import aniso_laplacian_csr, example_like
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
    host = aniso_laplacian_csr(512, 512, 1e-4)
    an = host.to(dev)
    arp, aci, av, (am, _) = host.to_numpy()
    ax_true = np.random.default_rng(5).standard_normal(am)
    ab = torch.from_numpy(host_spmv(1.0, 0.0, arp, aci, av, ax_true, np.zeros(am))).to(dev)
    yield ("aniso 512^2", an, ab, 4000,
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


def solve(dev, card):
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

    systems = list(solver_systems(dev)) + [spd_system("af23560"), spd_system("dw4096")]
    for label, csr, b, max_iters, pres in systems:
        layout = swell.get_swell_plan(csr)

        def matvec(v):
            return swell.swell_ax(layout, v)

        for pname, pre in pres.items():
            walls = [solve_wall(lambda: cg_solve(csr, b, tol=1e-8, max_iters=max_iters,
                                                 strategy="swell", precond=pre))
                     for _ in range(3)]
            rec = {"probe": "solve", "system": label, "precond": pname,
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
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as td:
        for name in ("Ga41As41H72", "af23560", "dw4096"):
            path = os.path.join(td, f"{name}.bin2")
            write_bin2(path, *example_like(name).to_numpy())
            for pre in ("jacobi", "ilu0"):
                t0 = time.perf_counter()
                out = subprocess.run([sys.executable, "-m", "spmv_acc_tpu_torch.cli.solve", path,
                                      "-f", "bin2", "--precond", pre], cwd=root,
                                     capture_output=True, text=True)
                wall = time.perf_counter() - t0
                lines = out.stdout.strip().splitlines()
                emit({"probe": "spmv-solve", "name": name, "precond": pre, "rc": out.returncode,
                      "process_wall_s": wall, "output": lines[-2:] if lines else out.stderr[-400:],
                      "card": card})


def main(argv=None) -> int:
    global OUT
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["tune", "corpus", "check", "solve"])
    p.add_argument("names", nargs="*")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    OUT = args.out
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from spmv_acc_tpu_torch import bench

    dev = torch.device("cuda")
    card = card_text()
    if args.mode == "tune":
        check_feedback(dev)
        tune_unroll(dev, card)
        tune_block(dev, card)
    elif args.mode == "check":
        check(args.names or bench.LARGE + bench.SMALL, dev, card)
    elif args.mode == "solve":
        solve(dev, card)
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
