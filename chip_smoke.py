#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spmv_acc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repo root on a machine with a Hopper card, ``nvcc`` and a C++
compiler.  It builds the seven kernel sources of ``spmv_acc_tpu_torch/csrc``
(swell with its plane form, tile, ELL row sum, plane split, the chain's
feedback F-1, the CG update F-2, the triangular solves F-3; one nvcc each,
all at once), holds every
variant the port launches against its plain PyTorch version (swell at
float64 and float32, BSR r = 1..4, k = 1, 3, 8 columns; the
tile and ELL kernels, the plane split (bit for bit) and the plane-form swell at
both dtypes on every smoke matrix, the ELL kernel at every lane count, also on
a slab without padding and with x[0] = inf; the swell and tile kernels again with their
chunk schedules cut to 1 and 4 slot rows, so that every row block is split and
its partials go through the fix-up pass, two launches equal bit for bit), and
drives the port's main paths at full
size:
``spmv(strategy="adaptive")`` on boneS10 (scalar plan, float64 and float32)
and on TSOPF_RS_b2383 (the detector's r = 4 BSR plan), ``spmm`` and
``make_swell_amx_run`` with k = 8 on both, ``spmv-cli`` in float64 and float32,
``spmv(strategy="adaptive_plus")`` and ``spmv(strategy="vector_row")`` on
boneS10 in both dtypes and adaptive_plus on TSOPF_RS_b2383, every strategy on
af23560, ``spmv-benchmark`` on af23560 (all engines) and boneS10, and the
solver path: ILU(0) and preconditioned CG on Ga41As41H72 (SPD-ized) and on
512^2 anisotropic diffusion, CG with the plane split and the plane-form swell
kernel as its matvec, and ``spmv-solve`` on af23560.  The chained loops run
as captured CUDA graphs (``utils/graphs.py``): the ``graphs`` phase holds
``make_swell_run`` and ``make_swell_amx_run`` on boneS10 and TSOPF_RS_b2383
against the eager chains (x bit for bit, µs an iteration in turns, capture
seconds and graph memory, the launches of every replay counted) and F-1
(``csrc/feedback.cu``) against its plain version, beside its bound; the
``solver`` phase holds ``cg_solve``'s captured blocks against the eager loop
(the recorded iterations 10 / 4 on Ga41As41H72-SPD and 1347 / 417 on aniso,
Jacobi / ILU; x bit for bit; µs an iteration), captures a CG block over
the exact ILU apply (two F-3 launches an apply; x bit for bit the eager
loop's), holds F-2 (``csrc/cg_update.cu``, the
CG update around the matvec: the fused single-device form and the three
phases) against its plain versions at every shape a CG of the smoke runs at
(Ga41As41H72-SPD, aniso, af23560 and the distributed shard of 1 M rows),
times both at the aniso shape beside the bound, and counts F-2's launches
by route in every CG it runs (``cg_solve``, the bench's
``bench_solver_aniso`` and ``spmv-solve``: ``cg_step`` once an iteration,
or ``cg_dot_xr`` and ``cg_dot_p`` around ILU; in the ``dist`` phase
``dist_swell_cg_solve``, 39 iterations at m = 1 M: the three phases).  The
``trisolve`` phase holds F-3 (``csrc/trisolve.cu``: ``tri_levels``, the exact
solve over the level schedule, and ``tri_sweeps``, the Jacobi sweeps) bit
for bit against its plain versions on the exact ILU(0) factors of aniso
512^2, dw4096-SPD and af23560-SPD in both dtypes, times both beside the
bounds and ``torch.triangular_solve`` on the sparse factor, and drives
``cg_solve`` with the exact ILU on dw4096-SPD and af23560-SPD and with
``ilu0(sweeps=3)`` gather sweeps on aniso.  Every swell layout the
run builds goes to the disk plan cache in a fresh directory under ``build/``
that the run deletes at its end: the ``plan-cache`` phase drops the process's
caches and runs boneS10 and TSOPF_RS_b2383 again from the saved layouts (the
kernel over both layouts equal in bytes), then ``spmv-cli`` twice on boneS10
as subprocesses sharing one cache directory (cold, then warm).  The ``spgemm``
phase runs A @ A on af23560, epb1 and dw4096 on the card against the host
golden; ``tools`` runs csr-tool, suitesparse-dl's conv/list/gen, ``trace``
around three boneS10 swell launches and ``bandwidth_report``.  The ``dist`` phase
runs the multi-device layer on the one card: ``dryrun_multichip(1)`` in an
NCCL group joined through a file under ``build/`` (gate 4b reported
skipped), the structural baseline ``dist_swell_serial_fn`` at D = 4 on
``banded_csr(1048576, bandwidth=17, seed=11)`` (one swell-kernel launch a
shard, each held against its plain version and equal to the whole-matrix
``swell_ax``), the all-gather and halo paths at D = 1 (the all-gather is a
real NCCL call; the halo path has no neighbour at world size 1 and issues no
collective, so NCCL's point-to-point exchange runs only on several cards),
the swell CG at D = 1 against ``cg_solve``'s iterations, and the distributed
loops as captured graphs with their collectives inside: both distributed CG
solvers captured from the first iteration against the plain loop, the D = 1
weak-scaling step and the D = 4 serial baseline against their eager chains.
The ``bench``
phase runs the port's benchmark (``python -m spmv_acc_tpu_torch.bench``) as a
user does, on Hardesty3 (rectangular, 8.2 M rows), RM07R (the detector's r =
3), largebasis (a layout at fill 0.59) and rajat03, and fails unless its last
line is whole, both verify flags hold and each large matrix went to the swell
kernel at its r; then ``entry()``'s step against its plain version.  It then times each
kernel against its plain version and PyTorch's CSR product (cuSPARSE), beside
its bound, times the fix-up pass, and sweeps the chunk caps
(``SWELL_CHUNK_ROWS``, ``TILE_CHUNK_ROWS``) on Ga41As41H72-SPD, TSOPF_RS_b2383
and boneS10, and the ELL kernel's lanes a row on boneS10, Ga41As41H72,
TSOPF_RS_b2383 and af23560.  Every phase prints lines tagged
with its name; the first failure exits non-zero.  Without a CUDA device it
fails at once.  The last three lines are the card, the kernels' JSON record and
the device JSON record.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

# element-wise bound on |kernel - plain| and |port - reference| in float64: the
# FP64 summation order differs, so the gap is a few ulps of (|A|·|X|)[row];
# 1e-12 leaves orders of margin.  In float32 both sides round an FP64 sum to
# float32 once, so they may differ by one float32 ulp on top (F32_ULP * |plain|).
ROW_TOL = 1e-12
F32_ULP = 2.0**-23
# peak rates for the bounds: FP64 outside the tensor cores (NVIDIA's H100 SXM
# data sheet; the swell, tile and ELL kernels sum in FP64 FMAs) and float32
# (NVIDIA's data sheet, outside the tensor cores; the plane split's bit operations)
FP64_TFLOPS = 34.0
F32_TFLOPS = 67.0
# the chunk caps the sweep times (slot rows a thread block walks at most)
SWELL_SWEEP = (8, 16, 32, 64, 128, 256)
TILE_SWEEP = (32, 64, 128, 256, 512)
# the ELL kernel's lanes a row, every instantiation
ELL_SWEEP = (2, 4, 8, 16, 32)
# the port's bench in the ``bench`` phase: the large matrices whose shapes no
# other phase has (the record each goes to, the r the detector picks on the
# CPU), then one small matrix
BENCH_LARGE = (("Hardesty3", "swell_rect_f64", 1), ("RM07R", "swell_bsr_r3_f64", 3),
               ("largebasis", "swell_lowfill_f64", 1))
BENCH_SMALL = ("rajat03",)
# cg_solve's iterations at tol 1e-8 on the bench's two solver systems, as the
# eager loop took them on the H100 (scripts/torch_probe_graphs.py tune)
CG_ITERS = {("Ga41As41H72-SPD", "jacobi"): 10, ("Ga41As41H72-SPD", "ilu"): 4,
            ("aniso 512^2", "jacobi"): 1347, ("aniso 512^2", "ilu"): 417}
# dist_swell_cg_solve's iterations at tol 1e-8 on gate 3's SPD recipe at
# 1,048,576 rows, world size 1, as the plain and captured loops took them on
# the H100 (the dist phase, before F-2)
DIST_CG_ITERS = 39


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# Where the run's seconds go: the time up to each message, summed under its
# phase's name, printed with the last one.
_CLOCK = {"last": time.perf_counter(), "secs": {}}


def phase(name: str, msg: str) -> None:
    now = time.perf_counter()
    _CLOCK["secs"][name] = _CLOCK["secs"].get(name, 0.0) + now - _CLOCK["last"]
    _CLOCK["last"] = now
    print(f"[{name}] {msg}", flush=True)
    if name == "done":
        secs = sorted(_CLOCK["secs"].items(), key=lambda kv: -kv[1])
        print("[clock] seconds up to each phase's messages: "
              + ", ".join(f"{k} {v:.1f}" for k, v in secs), flush=True)


def smoke_matrices(gen):
    """The JAX package's swell test shapes (tests/test_swell.py MATRICES) plus two
    corpus matrices at full size."""
    return {
        "banded": lambda: gen.banded_csr(300, bandwidth=5, seed=70),
        "random": lambda: gen.random_csr(150, 260, 1700, seed=71),
        "powerlaw": lambda: gen.powerlaw_csr(180, 180, avg_nnz=6, seed=72),
        "outlier": lambda: gen.dense_row_outlier_csr(140, 140, avg_nnz=3, n_dense=2, seed=73),
        "window_dense": lambda: gen.random_csr(64, 100, 3000, seed=74),
        "tall": lambda: gen.random_csr(40000, 300, 9000, seed=75),
        "wide": lambda: gen.random_csr(300, 40000, 9000, seed=76),
        "single_col": lambda: gen.random_csr(200, 1, 180, seed=77),
        "rajat03": lambda: gen.example_like("rajat03"),
        "af23560": lambda: gen.example_like("af23560"),
    }


def bsr_cases(gen):
    """Forced-r cases: FEM node blocks of 6 rows (m = 3001, so the trailing node
    block is partial for every r) and a band."""
    return {
        "fem_b6": lambda: gen.fem_like_csr(3001, 3001, 90000, block=6, seed=5),
        "banded": lambda: gen.banded_csr(3001, bandwidth=5, seed=70),
    }


def row_bound(csr, X):
    """(|A|·|X|)[row, col], the scale of each element's rounding."""
    import numpy as np

    from spmv_acc_tpu_torch.ops.golden import host_spmm

    rp, ci, v, _ = csr.to_numpy()
    X = np.abs(np.asarray(X, dtype=np.float64).reshape(csr.cols, -1))
    return host_spmm(1.0, 0.0, rp, ci, np.abs(v.astype(np.float64)), X,
                     np.zeros((csr.rows, X.shape[1])))


def compare(name, csr, X, a, p, label="h1-vs-plain"):
    """Kernel output ``a`` against the plain version ``p`` and both against the
    float64 golden, in the gate of the matrix's dtype.  Returns max|a - p|."""
    import numpy as np

    from spmv_acc_tpu_torch.ops.golden import host_spmm
    from spmv_acc_tpu_torch.utils import host_array, verify_y

    rp, ci, v, shape = csr.to_numpy()
    f32 = v.dtype == np.float32
    k = 1 if np.ndim(X) == 1 else X.shape[1]
    a = host_array(a).astype(np.float64).reshape(shape[0], k)
    p = host_array(p).astype(np.float64).reshape(shape[0], k)
    if not np.isfinite(a).all():
        fail(f"{name}: kernel output has non-finite values")
    gap = np.abs(a - p)
    allowed = ROW_TOL * row_bound(csr, X) + (F32_ULP * np.abs(p) if f32 else 0.0)
    worst = float((gap - allowed).max()) if gap.size else -1.0
    golden = host_spmm(1.0, 0.0, rp, ci, v, np.asarray(X, np.float64).reshape(shape[1], k),
                       np.zeros((shape[0], k)))
    dt = np.float32 if f32 else np.float64
    ra, rpl = verify_y(a.ravel(), golden.ravel(), dt), verify_y(p.ravel(), golden.ravel(), dt)
    ok = worst <= 0.0 and ra.ok and rpl.ok
    max_abs = float(gap.max()) if gap.size else 0.0
    bound = f"{ROW_TOL}*(|A||X|)" + (" + 2^-23|plain|" if f32 else "")
    phase(label, f"{name} {shape[0]}x{shape[1]} nnz={csr.nnz} k={k}: "
          f"max|kernel-plain|={max_abs!r} within {bound}: {worst <= 0.0}; verify_y "
          f"max_error/failed kernel {ra.max_error!r}/{ra.failed_count} plain "
          f"{rpl.max_error!r}/{rpl.failed_count}")
    if not ok:
        fail(f"{name}: the kernel disagrees with its plain version or the golden")
    return max_abs


def ptxas_summary(log: str) -> str:
    """One 'swell f64 r1 g1: 31 regs, 0 B spill' item per kernel instantiation."""
    out, cur, spill = [], None, "spill not reported"
    for ln in log.splitlines():
        m = re.search(r"(swell|tile|ell|plane_split|fixup|feedback)"
                      r"(?:_kernel)?I([df])((?:L[ib]\d+E)*)E", ln)
        if m and "Compiling entry function" in ln:
            params = " ".join(re.findall(r"L[ib](\d+)E", m.group(3)))
            cur = f"{m.group(1)} f{'64' if m.group(2) == 'd' else '32'} {params}".strip()
            spill = "spill not reported"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur:
            spill = f"{int(m.group(1)) + int(m.group(2))} B spill"
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            out.append(f"{cur}: {m.group(1)} regs, {spill}")
            cur = None
    return "; ".join(out)


def _dk(dtype) -> str:
    return "f64" if str(dtype).endswith("float64") else "f32"


def launches_of(swell, dtype=None, r=None, k=None) -> int:
    """Launches of the swell kernel's direct form, keyed (dtype, r, k)."""
    return sum(n for key, n in swell.LAUNCHES.items() if len(key) == 3
               and (dtype is None or key[0] == dtype) and (r is None or key[1] == r)
               and (k is None or key[2] == k))


def sched_text(sc) -> str:
    """A chunk schedule's counts, for a phase line."""
    return (f"(chunks of <= {sc.max_rows} rows: {sc.nchunks} chunks, {sc.nsplit} split row "
            f"blocks, {sc.nparts} partials)")


def layouts_equal(a, b) -> bool:
    """Two DeviceSwellLayouts equal tensor for tensor (dtypes and devices too),
    schedule array for array, and in every scalar."""
    import dataclasses

    import numpy as np
    import torch

    for f in dataclasses.fields(a):
        u, v = getattr(a, f.name), getattr(b, f.name)
        if f.name == "_plain_idx":
            continue
        if isinstance(u, torch.Tensor):
            if u.dtype != v.dtype or u.device != v.device or not torch.equal(u, v):
                return False
        elif f.name == "schedule":
            if not all(np.array_equal(getattr(u, g.name), getattr(v, g.name))
                       for g in dataclasses.fields(u)):
                return False
        elif u != v:
            return False
    return True


def dir_bytes(path: str) -> tuple:
    """(files, bytes) under ``path``."""
    sizes = [os.path.getsize(os.path.join(root, f))
             for root, _, files in os.walk(path) for f in files]
    return len(sizes), sum(sizes)


def spmv_bytes(csr, k=1, x_bytes=None) -> int:
    """The bytes that A @ X must move, whatever layout computes it: the CSR's
    values and column indices (4 B each), row_ptr at 4 B a row, X read once (or
    ``x_bytes``) and Y written once."""
    t = csr.values.element_size()
    x_bytes = csr.cols * k * t if x_bytes is None else x_bytes
    return csr.nnz * (t + 4) + 4 * (csr.rows + 1) + x_bytes + csr.rows * k * t


def dist_phase(dev, card, rdzv, records, loop_us, time_us, library, bound_of):
    """The multi-device layer on one card.  One H100 is one device and NCCL
    refuses two ranks on one card, so: the dry run at world size 1 (an NCCL
    group joined through a rendezvous file ``rdzv``), the structural baseline
    at D = 4 on the scaling bench's matrix at full size (four shard layouts,
    one swell-kernel launch each), the all-gather and halo paths at D = 1
    (the swell kernel as the shard's product; the all-gather is a real NCCL
    call, the halo path has no neighbour and issues no collective) and the
    swell CG at D = 1, its dots all-reduced over NCCL; then the distributed
    loops captured: both CG solvers from the first iteration against every
    iteration plain, the D = 1 scaling step and the D = 4 serial baseline
    against their eager chains (the gather CG's comparison with
    ``index_add_``'s deterministic form: with its atomics the eager loop does
    not repeat itself).  Records ``swell_dist_f64``."""
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    from spmv_acc_tpu_torch.dryrun import _spd_fem, dryrun_multichip
    from spmv_acc_tpu_torch.formats import generate as gen
    from spmv_acc_tpu_torch.formats.containers import CSR
    from spmv_acc_tpu_torch.models import cg as cg_mod
    from spmv_acc_tpu_torch.models.cg import _cg_loop, cg_solve
    from spmv_acc_tpu_torch.ops import cg_update, swell
    from spmv_acc_tpu_torch.ops.golden import host_spmv
    from spmv_acc_tpu_torch.parallel import gather_padded, make_mesh, pad_vector, partition_rows
    from spmv_acc_tpu_torch.parallel.dist_spmv import (all_reduced_sum, dist_spmv_fn, gather_mesh,
                                                       shard_partitioned)
    from spmv_acc_tpu_torch.parallel.dist_swell import (build_dist_swell, dist_swell_cg_solve,
                                                        dist_swell_serial_fn, dist_swell_spmv_fn,
                                                        pad_global)
    from spmv_acc_tpu_torch.parallel.multihost import init_distributed, shutdown_distributed
    from spmv_acc_tpu_torch.parallel.scaling_bench import _loop_us, _renormalised
    from spmv_acc_tpu_torch.utils import verify_y
    from spmv_acc_tpu_torch.utils.graphs import Loop

    dsm = sys.modules["spmv_acc_tpu_torch.parallel.dist_spmv"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def same_bytes(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    init_distributed(coordinator_address="file://" + rdzv, num_processes=1, process_id=0,
                     device=dev.type)
    try:
        # the dry run: gates 1-6, gate 4b skipped below two devices
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            dryrun_multichip(1, device=dev.type)
        secs = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        for ln in lines:
            phase("dist", f"dryrun: {ln}")
        skipped = any("gate 4b skipped" in ln for ln in lines)
        phase("dist", f"dryrun_multichip(1) on {dist.get_backend()} passed gates 1-6 in "
              f"{secs:.1f}s; gate 4b reported skipped: {skipped}")
        if not skipped or dist.get_backend() != ("nccl" if dev.type == "cuda" else "gloo"):
            fail("the dry run did not report gate 4b skipped, or ran on another backend")

        # the structural baseline at D = 4, full size: the scaling bench's
        # generator, 4 x 262,144 rows
        t0 = time.perf_counter()
        band = gen.banded_csr(1_048_576, bandwidth=17, seed=11)
        t_gen = time.perf_counter() - t0
        brp, bci, bv, (bm, bn) = band.to_numpy()
        band_dev = band.to(dev)
        t0 = time.perf_counter()
        d4 = build_dist_swell(band_dev, 4)
        t_build = time.perf_counter() - t0
        build_split = ", ".join(f"{k} {t!r} s" for k, t in swell.PLAN_TIMES.items())
        bxn = gen.random_x_y(bn, bm, seed=42)[0]
        bx = torch.from_numpy(bxn).to(dev)
        xp4 = pad_global(d4, bx)
        serial = dist_swell_serial_fn(d4, dev)
        swell.LAUNCHES.clear()
        y4 = serial(xp4)
        sync()
        launches = sum(n for k, n in swell.LAUNCHES.items() if len(k) == 3 and k[0] == "f64")
        launch_keys = dict(swell.LAUNCHES)
        whole_lay = swell.get_swell_plan(band_dev)
        whole = swell.swell_ax(whole_lay, bx)
        sync()
        bound_rows = host_spmv(1.0, 0.0, brp, bci, np.abs(bv), np.abs(bxn), np.zeros(bm))
        gap = (y4[:bm] - whole).abs().cpu().numpy()
        equal = same_bytes(y4[:bm], whole)
        within = bool((gap <= ROW_TOL * bound_rows).all())
        rep = verify_y(y4[:bm], host_spmv(1.0, 0.0, brp, bci, bv, bxn, np.zeros(bm)))
        finite = bool(torch.isfinite(y4).all())
        phase("dist", f"banded_csr(1048576, bandwidth=17, seed=11) f64: nnz={band.nnz} "
              f"(generated in {t_gen:.1f}s); build_dist_swell(., 4) {t_build!r} s ({build_split}): "
              f"r={d4.r}, {d4.blocks_per_shard} row blocks a shard, rows_local={d4.rows_local}, "
              f"halo_ok={d4.halo_ok}, tail {d4.tail_nnz}, slots a shard "
              f"{[len(s.lidx) for s in d4.shards]}; dist_swell_serial_fn: swell kernel launches "
              f"{launches} ({launch_keys}); y == whole-matrix swell_ax bit for bit: {equal}, "
              f"within {ROW_TOL}*(|A||x|): {within}; verify_y {rep}; finite: {finite}")
        if launches < 4 or not finite or not rep.ok or not within or (
                d4.tail_nnz == 0 and not equal):
            fail("the D = 4 serial path is wrong or did not launch the swell kernel per shard")
        records["swell_dist_f64"] = {"launches": launches}

        # each shard's kernel against its plain version, timed beside its
        # bound and PyTorch's CSR product of the shard's rows
        L = d4.rows_local
        lays = [d4.device_layout(d, dev) for d in range(4)]
        xg = torch.cat([xp4.new_zeros(L), xp4, xp4.new_zeros(L)]) if d4.halo_ok else None
        per = []
        for d, lay in enumerate(lays):
            xw = xg[d * L: (d + 3) * L] if d4.halo_ok else xp4[:bn]
            a, p = swell.swell_ax(lay, xw), swell.swell_ax_plain(lay, xw)
            sync()
            r0, r1 = d * L, min((d + 1) * L, bm)
            sgap = (a - p).abs().cpu().numpy()
            ok = (bool((sgap[: r1 - r0] <= ROW_TOL * bound_rows[r0:r1]).all())
                  and not sgap[r1 - r0:].any())
            if not ok or not bool(torch.isfinite(a).all()):
                fail(f"shard {d}: the swell kernel disagrees with its plain version")
            kern = lambda lay=lay, xw=xw: swell.swell_ax(lay, xw)  # noqa: E731
            plain = lambda lay=lay, xw=xw: swell.swell_ax_plain(lay, xw)  # noqa: E731
            t_p1, t_k1, t_k2, t_p2 = time_us(plain), time_us(kern), time_us(kern), time_us(plain)
            rp_d = brp[r0: r1 + 1] - brp[r0]
            shard_csr = CSR.from_numpy(rp_d, bci[brp[r0]: brp[r1]], bv[brp[r0]: brp[r1]],
                                       (r1 - r0, bn), device=dev)
            nbytes = shard_csr.nnz * 12 + 4 * (r1 - r0 + 1) + 8 * L + 8 * (r1 - r0)
            per.append(dict(max_abs=float(sgap.max()), k=(t_k1 + t_k2) / 2, p=(t_p1 + t_p2) / 2,
                            loop=loop_us(kern), nbytes=nbytes, ops=2 * shard_csr.nnz,
                            lib=library(shard_csr, bx), nnz=shard_csr.nnz))
            b = bound_of(nbytes, 2 * shard_csr.nnz, FP64_TFLOPS)
            phase("dist", f"shard {d}: {shard_csr.nnz} nnz, {lay.slots} slots; max|kernel-plain| "
                  f"{per[-1]['max_abs']!r} within {ROW_TOL}*(|A||x|); kernel {t_k1!r} / {t_k2!r}"
                  f" us, plain {t_p1!r} / {t_p2!r} us per call (median of 3 after 10 warmups); "
                  f"loop of 20: {per[-1]['loop']!r} us per launch; bound {b['bound_ms'] * 1e3!r} "
                  f"us by {b['bound_by']} (8(2L+nnz)+4(L+1+nnz) = {nbytes} B); PyTorch CSR "
                  f"product of the shard's rows {per[-1]['lib'][1]!r} us per call in a loop of "
                  f"20, {per[-1]['lib'][0]!r} ms per call; card: {card}")
        mean = lambda key: sum(s[key] for s in per) / len(per)  # noqa: E731
        libs = [s["lib"][0] for s in per]
        records["swell_dist_f64"].update(
            max_abs_err=max(s["max_abs"] for s in per), ms=mean("k") / 1e3,
            plain_ms=mean("p") / 1e3,
            library_ms=None if None in libs else sum(libs) / len(libs),
            **bound_of(mean("nbytes"), mean("ops"), FP64_TFLOPS))

        # the paths at D = 1: all-gather (one NCCL all_gather) and halo (no
        # neighbour, so no collective), each equal to swell_ax bit for bit
        mesh = make_mesh(1)
        per_call = {}
        for halo in (None, False):
            d1 = build_dist_swell(band_dev, 1, halo=halo, mesh=mesh)
            run = dist_swell_spmv_fn(d1, mesh)
            x1 = pad_global(d1, bx)
            swell.LAUNCHES.clear()
            y1 = run(x1)
            sync()
            n_launch, keys1 = sum(swell.LAUNCHES.values()), dict(swell.LAUNCHES)
            label = "halo" if d1.halo_ok else "all-gather"
            per_call[label] = loop_us(lambda: run(x1))
            eq = same_bytes(y1[:bm], whole)
            phase("dist", f"dist_swell_spmv_fn over {dist.get_backend()} at world size 1, "
                  f"{label}: {n_launch} launch(es) {keys1}, equal to the "
                  f"whole-matrix swell_ax bit for bit: {eq}; {per_call[label]!r} us per call "
                  f"(loop of 20); card: {card}")
            if not eq or n_launch < 1:
                fail(f"the D = 1 {label} path differs from swell_ax")
        xl = pad_global(d4, bx)[:L].contiguous()
        t_gather = loop_us(lambda: gather_mesh(xl, mesh))
        t_serial = loop_us(lambda: serial(xp4))
        t_whole = loop_us(lambda: swell.swell_ax(whole_lay, bx))
        phase("dist", f"all_gather at world size 1 of {L} f64 ({8 * L} B): {t_gather!r} us per "
              f"call; serial D = 4 (4 launches) {t_serial!r} us against one whole-matrix "
              f"swell_ax {t_whole!r} us: structural ratio {t_whole / t_serial!r}; per-shard "
              f"launch (loop of 20) {[s['loop'] for s in per]} us; card: {card}")

        # the swell CG at D = 1 on gate 3's recipe at full size
        t0 = time.perf_counter()
        frp, fci, fv, spd = _spd_fem(1_048_576, np.float64)
        t_spd = time.perf_counter() - t0
        fm = spd.rows
        spd_dev = spd.to(dev)
        x_true = np.random.default_rng(7).uniform(-1, 1, size=fm)
        fb = host_spmv(1.0, 0.0, frp, fci, fv, x_true, np.zeros(fm))
        fb_dev = torch.from_numpy(fb).to(dev)
        swell.LAUNCHES.clear()
        cg_update.LAUNCHES.clear()
        t0 = time.perf_counter()
        res, dspc = dist_swell_cg_solve(spd_dev, fb_dev, mesh, tol=1e-8, max_iters=400)
        sync()
        t_cg = time.perf_counter() - t0
        cg_launches = sum(swell.LAUNCHES.values())
        f2 = f2_launches(cg_update, "dist_swell_cg_solve", res.iters, "dist")
        # the phases' path: their record's launches
        records.setdefault("cg_phases_f64", {})["launches"] = sum(f2.values())
        f2_check(dev, records, "dist", "dist_swell_cg_solve's shard", dspc.rows_local)
        xs = gather_padded(res.x, mesh)[:fm].cpu().numpy()
        err = float(np.linalg.norm(xs - x_true) / np.linalg.norm(x_true))
        met = float(res.residual_norm) <= 1e-8 * float(np.linalg.norm(fb))
        ref = cg_solve(spd_dev, fb_dev, tol=1e-8, max_iters=400, strategy="swell")
        sync()
        # µs per iteration from fixed-trip loops (tol 0) of 5 and 25 iterations,
        # short of convergence
        runc = dist_swell_spmv_fn(dspc, mesh)
        Lc = dspc.rows_local
        bc = pad_global(dspc, fb_dev)[:Lc].contiguous()
        whole_c = swell.get_swell_plan(spd_dev)

        reduce = all_reduced_sum(mesh)  # what completes dist_swell_cg_solve's sums

        def trips(n, matvec, b, d):
            """Host seconds of ``n`` plain CG iterations (tol 0)."""
            t = time.perf_counter()
            _cg_loop(matvec, None, b, torch.zeros_like(b), 0.0, n, d)
            sync()
            return time.perf_counter() - t

        it_dist = (trips(25, runc, bc, reduce) - trips(5, runc, bc, reduce)) / 20 * 1e6
        one = lambda v: swell.swell_ax(whole_c, v)  # noqa: E731
        it_one = (trips(25, one, fb_dev, None) - trips(5, one, fb_dev, None)) / 20 * 1e6
        phase("dist", f"gate 3's SPD recipe at m={fm}: nnz={spd.nnz} (made in {t_spd:.1f}s), "
              f"r={dspc.r}, halo_ok={dspc.halo_ok}; dist_swell_cg_solve at world size 1: "
              f"{res.iters} iterations, residual {float(res.residual_norm)!r} (met: {met}), rel "
              f"err against x_true {err!r}, {t_cg!r} s with the build, swell launches "
              f"{cg_launches}, F-2 launches {f2}; cg_solve(strategy='swell'): {ref.iters} "
              f"iterations (recorded {DIST_CG_ITERS}); per iteration "
              f"(fixed-trip loops of 5 and 25, host clock): dist {it_dist!r} us, single-device "
              f"{it_one!r} us; card: {card}")
        if not met or not err < 1e-5 or abs(res.iters - ref.iters) > 1 or cg_launches < res.iters:
            fail("the distributed swell CG did not converge or left cg_solve's iteration count")
        if dev.type == "cuda" and res.iters != DIST_CG_ITERS:  # (a CPU rehearsal shrinks it)
            fail(f"the distributed swell CG took {res.iters} iterations, recorded {DIST_CG_ITERS}")

        # the distributed loops as one device program: both CG solvers
        # captured from the first iteration (their all-reduces, and the
        # all-gather of the gather path, inside the graphs) against every
        # iteration plain, on the same system
        host_part = partition_rows(spd, 1, balance=False)
        part = shard_partitioned(host_part, mesh)
        b_pad = pad_vector(host_part, fb)
        solvers = {
            "dist_swell_cg_solve": lambda: dist_swell_cg_solve(spd_dev, fb_dev, mesh, tol=1e-8,
                                                               max_iters=400)[0],
            "dist_cg_solve (all-gather forced)": lambda: cg_mod.dist_cg_solve(
                part, b_pad, mesh, tol=1e-8, max_iters=400)}
        gather_run, _ = dist_spmv_fn(mesh, part, padded=True)
        matvecs = {"dist_swell_cg_solve": runc,
                   "dist_cg_solve (all-gather forced)": lambda v: gather_run(
                       part.values, part.col_idx_padded, part.row_ids, v)}
        saved = cg_mod.CG_EAGER_ITERS, dsm.halo_feasible
        dsm.halo_feasible = lambda *args, **kw: False  # at world size 1 the halo path has no collective
        b_norm = float(np.linalg.norm(fb))
        try:
            for label, call in solvers.items():
                # the gather path's index_add_ adds with atomics, so its eager
                # loop does not repeat itself (~1e-12..1e-10 apart): its
                # captured and eager solves are compared with index_add_'s
                # deterministic form, bit for bit; the solve as a user runs it
                # (atomics) is timed and held to its tolerance
                atomics = label != "dist_swell_cg_solve"
                with deterministic(atomics):
                    cg_mod.CG_EAGER_ITERS = 10 ** 9  # every iteration plain: the eager loop
                    t0 = time.perf_counter()
                    eager = [call() for _ in range(2)]
                    sync()
                    t_eager = (time.perf_counter() - t0) / 2
                    cg_mod.CG_EAGER_ITERS = 0
                    swell.LAUNCHES.clear()
                    got = []
                    secs, mem = first_call(lambda: got.append(call()))
                    replayed = sum(n for k, n in swell.LAUNCHES.items() if len(k) == 3)
                    got = got[0]
                text = same_or_close(label, got.x, [e.x for e in eager])
                if atomics:
                    got_a = []
                    secs, mem = first_call(lambda: got_a.append(call()))
                    got_a = got_a[0]
                    met = float(got_a.residual_norm) <= 1e-8 * b_norm
                    text += (f" with index_add_ deterministic; as called (atomics): "
                             f"{got_a.iters} iterations, residual met: {met}, x "
                             f"{float((got_a.x - got.x).norm() / got.x.norm())!r} from the "
                             f"deterministic solve")
                    if not met or not bool(torch.isfinite(got_a.x).all()):
                        fail(f"{label}: the captured solve as called did not converge")
                mv = matvecs[label]
                bb = bc if label == "dist_swell_cg_solve" else part_b(part, b_pad, dev)
                blocks = cg_mod.CGBlocks(mv, None, bb, reduce=reduce, eager_iters=0)

                def cap_trips(n, blocks=blocks, bb=bb):
                    t = time.perf_counter()
                    blocks.solve(bb, torch.zeros_like(bb), 0.0, n)
                    sync()
                    return time.perf_counter() - t

                cap_trips(25)  # captures the graphs of 8 and 1 iterations
                cap_trips(5)  # and of 4
                it_cap = (cap_trips(25) - cap_trips(5)) / 20 * 1e6
                it_eager = (trips(25, mv, bb, reduce) - trips(5, mv, bb, reduce)) / 20 * 1e6
                phase("dist", f"{label} at world size 1, every block captured from the first "
                      f"iteration: {got.iters} iterations (eager loop {eager[0].iters}); x "
                      f"against the eager loop {text}; swell launches replayed {replayed}; "
                      f"first captured solve {secs!r} s with its captures (eager solve "
                      f"{t_eager!r} s), device memory above the start at its peak {mem} B; per "
                      f"iteration (fixed-trip loops of 5 and 25, host clock): captured "
                      f"{it_cap!r} us, eager {it_eager!r} us; "
                      f"card: {card}")
                if got.iters != eager[0].iters or eager[0].iters != eager[1].iters:
                    fail(f"{label}: the captured solve left the eager loop's iteration count")
                if label == "dist_swell_cg_solve" and replayed < got.iters:
                    fail(f"{label}: the replays counted fewer swell launches than iterations")
        finally:
            cg_mod.CG_EAGER_ITERS, dsm.halo_feasible = saved

        # the weak-scaling step at D = 1 (halo exchange without a neighbour,
        # swell, an all-reduced max) and the D = 4 serial baseline as captured
        # chains (scaling_bench._loop_us) against the eager chains
        group = mesh.get_group()
        s1 = gen.banded_csr(262_144, bandwidth=17, seed=11).to(dev)
        ds1 = build_dist_swell(s1, 1, mesh=mesh)
        x_s1 = pad_global(ds1, torch.ones(s1.cols, dtype=torch.float64, device=dev))
        for label, step, xs in (
                ("scaling step D = 1, 262144 rows", _renormalised(dist_swell_spmv_fn(ds1, mesh),
                                                                  group), x_s1),
                ("serial baseline D = 4, 1048576 rows", _renormalised(serial, None), xp4)):
            coll = label.startswith("scaling")
            want = xs
            for _ in range(20):
                want = step(want)
            swell.LAUNCHES.clear()
            loop = Loop(step, xs, unroll=20)
            loop.run(xs, 20)  # the warm-up and the capture
            swell.LAUNCHES.clear()
            got = loop.run(xs, 20)
            sync()
            replayed = sum(n for k, n in swell.LAUNCHES.items() if len(k) == 3)
            cap = [_loop_us(step, xs, 20, dev, group if coll else None) for _ in range(3)]
            eag = [eager_chain_us(step, xs, 20) for _ in range(3)]
            equal = same_bytes(got, want)
            phase("dist", f"{label}: captured chain of 20 equal to the eager chain bit for bit: "
                  f"{equal}; swell launches in one replay {replayed}; us a step, captured "
                  f"(scaling_bench._loop_us) {cap!r} (spread {(max(cap) - min(cap)) / min(cap)!r}),"
                  f" eager {eag!r}; card: {card}")
            if not equal or replayed != 20 * (1 if coll else 4):
                fail(f"{label}: the captured chain differs or did not replay its launches")
        del blocks, cap_trips, loop  # graphs with NCCL inside go before the group
    finally:
        shutdown_distributed()


@contextlib.contextmanager
def deterministic(on):
    """``torch.use_deterministic_algorithms(on)`` inside (warnings only where
    an op has no deterministic form), the previous setting after."""
    import torch

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def part_b(part, b_pad, dev):
    """This rank's block of the padded right-hand side, on ``dev``."""
    lr = part.local_rows
    return b_pad[part.shard * lr: (part.shard + 1) * lr].to(dev).contiguous()


def eager_chain_us(step, x, n):
    """Device µs a step of ``n`` chained steps launched from the host (CUDA
    events, after one untimed chain)."""
    import torch

    def chain(v):
        for _ in range(n):
            v = step(v)
        return v

    chain(x)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    chain(x)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) * 1e3 / n


def first_call(fn):
    """(seconds, device bytes above the allocation before it at its peak) of
    ``fn()``: a captured loop's first call, its capture included."""
    import torch

    gc.collect()  # what an earlier loop left in reference cycles is freed here, not inside
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base


def same_or_close(label, got, runs):
    """``got`` against the eager loop's results ``runs`` (two runs): bit for
    bit where the eager loop repeats itself bit for bit, else (index_add_'s
    atomics in a COO tail) within 1e-12 relative.  Returns the phase text."""
    import torch

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-300))

    repeats = torch.equal(runs[0], runs[1])
    apart = rel(got, runs[0])
    if repeats and not torch.equal(got, runs[0]):
        fail(f"{label}: the captured loop differs from the eager loop, which repeats itself")
    if not repeats and not apart <= 1e-12:
        fail(f"{label}: the captured loop is {apart!r} from the eager loop")
    return (f"equal bit for bit: {torch.equal(got, runs[0])} (eager repeats itself: "
            f"{repeats}, its two runs {rel(runs[1], runs[0])!r} apart; relative difference "
            f"{apart!r})")


def graphs_phase(dev, card, records, mats, spmm_X, bound_of, flush_buf):
    """The bench's chained loops as captured CUDA graphs (``utils/graphs.py``)
    against the eager loops they replace, and F-1 (``csrc/feedback.cu``, the
    chain's feedback) against its plain version, on boneS10 and
    TSOPF_RS_b2383 (``mats``: (name, CSR on the card)) and the SpMM chains on
    ``spmm_X``.  Each chain: at the bench's loop length on the bench's data,
    the launches of every replay counted and x bit for bit the same steps run
    eagerly (the step function launched from the host); on data that moves x
    (x and y scaled until the multiplier is 1 + 1e-9 a step, the product
    carrying most of s), x bit for bit the eager steps and within the float32
    mean's rounding of the eager PyTorch chain; µs an iteration at the bench's
    loop lengths, eager PyTorch chain against captured, in three turns each;
    the first call's capture seconds and graph memory.  F-1 alone at
    boneS10's shapes: the bench's data (bit for bit), and s ~ 1e11 from ax and
    y both, alpha 2, beta -0.5, and the SpMM form at k = 8 (within the
    tolerance).  The boneS10 chain is F-1's main path: its counts are read
    from 0.  Records ``feedback_f64``.  No profiler session here (the
    ``tools`` check traces first, in the ``solver`` phase): device times are
    CUDA events."""
    import torch

    from spmv_acc_tpu_torch import bench
    from spmv_acc_tpu_torch.formats.generate import random_x_y
    from spmv_acc_tpu_torch.ops import feedback, swell
    from spmv_acc_tpu_torch.utils import cuda_time_us
    from spmv_acc_tpu_torch.utils.graphs import UNROLL

    eps = 2.0**-52

    def plain_chain(layout, x, y, n):
        """The chain as eager PyTorch ops (the loop before graphs)."""
        for _ in range(n):
            x = (feedback.feedback_plain(x, swell.swell_ax(layout, x), y) if y is not None
                 else feedback.feedback_plain(x, swell.swell_amx(layout, x)))
        return x

    def step_chain(layout, x, y, n):
        """The captured step launched from the host: swell, tail, F-1."""
        x = x.clone()
        for _ in range(n):
            if y is not None:
                feedback.feedback_(x, swell.swell_ax(layout, x), y)
            else:
                feedback.feedback_(x, swell.swell_amx(layout, x))
        return x

    def turns(eager, captured, n0, n1):
        """µs an iteration, eager and captured, in turns e c c e e c."""
        got = {"eager": [], "captured": []}
        for which in ("eager", "captured", "captured", "eager", "eager", "captured"):
            fn = eager if which == "eager" else captured
            got[which].append(bench._slope_us(fn, n0, n1, dev))
        return got

    def spread(v):
        return f"{v!r} (spread {(max(v) - min(v)) / min(v) if min(v) > 0 else 0.0!r})"

    def sq_mean(t):
        return float((t.float() ** 2).mean())

    def moving(label, layout, x, y, run):
        """The chain on data that moves x: ``UNROLL + 3`` steps (the graphs of
        UNROLL, 2 and 1) against the eager steps (bits) and the eager PyTorch
        chain (n·(1e-5·(multiplier - 1) + 4 ulps) relative a step)."""
        ax = swell.swell_ax(layout, x) if y is not None else swell.swell_amx(layout, x)
        s_mean = sq_mean(ax if y is None else ax + y)
        sigma = (1e21 / s_mean) ** 0.5  # mean(s^2) * 1e-30 = 1e-9
        xm = x * sigma
        ym = None if y is None else y * sigma
        n = UNROLL + 3
        got = run(xm, ym, n)
        text = same_or_close(f"{label} moving chain", got,
                             [step_chain(layout, xm, ym, n) for _ in range(2)])
        plain = plain_chain(layout, xm, ym, n)
        axm = swell.swell_ax(layout, xm) if y is not None else swell.swell_amx(layout, xm)
        mult = sq_mean(axm if y is None else axm + ym) * 1e-30
        share = 1.0 if y is None else sq_mean(axm) / sq_mean(axm + ym)
        move = float(((got - xm).abs() / xm.abs().clamp(min=1e-300)).max())
        gap = float(((got - plain).abs() / plain.abs().clamp(min=1e-300)).max())
        allowed = n * (1e-5 * mult + 4 * eps)
        phase("graphs", f"{label} on data that moves x ({n} steps, multiplier - 1 = {mult!r} a "
              f"step, the product's share of mean(s^2) {share!r}): x moved {move!r} relative; "
              f"against the eager steps {text}; against the eager PyTorch chain max relative "
              f"{gap!r} (allowed {allowed!r}); card: {card}")
        if not move > 0.5 * n * mult or not share > 0.01:
            fail(f"{label}: the moving chain did not move x through the product")
        if not gap <= allowed:
            fail(f"{label}: the captured chain is {gap!r} from the eager PyTorch chain")

    f1 = {}
    for name, dcsr in mats:
        layout = swell.get_swell_plan(dcsr)
        x, y = (torch.from_numpy(a).to(dev) for a in random_x_y(dcsr.cols, dcsr.rows, seed=42))
        run = swell.make_swell_run(dcsr)
        it = bench._iters_for(dcsr.nnz)
        secs, mem = first_call(lambda: run(x, y, 1 + it))  # captures the 64- and 1-step graphs
        swell.LAUNCHES.clear()
        feedback.LAUNCHES.clear()
        out = run(x, y, 1 + it)
        torch.cuda.synchronize()
        n_swell, n_f1 = launches_of(swell, "f64", layout.r, 1), feedback.LAUNCHES["f64"]
        if name == "boneS10":
            f1["launches"] = n_f1
        text = same_or_close(f"{name} chain", out, [step_chain(layout, x, y, 1 + it)
                                                     for _ in range(2)])
        per = turns(lambda n: plain_chain(layout, x, y, n), lambda n: run(x, y, n),
                    1 + it // 4, 1 + it)
        phase("graphs", f"{name} make_swell_run, {1 + it} steps replayed: swell launches "
              f"{n_swell}, F-1 launches {n_f1}; x against the eager steps {text}; us an "
              f"iteration (bench loop lengths {1 + it // 4}, {1 + it}): eager PyTorch chain "
              f"{spread(per['eager'])}, captured {spread(per['captured'])}; first call "
              f"(capture of the {UNROLL}- and 1-step graphs) {secs!r} s, graph memory {mem} B; "
              f"card: {card}")
        if n_swell != 1 + it or n_f1 != 1 + it or not torch.isfinite(out).all():
            fail(f"{name}: the replays did not count one swell and one F-1 launch a step")
        moving(f"{name} make_swell_run", layout, x, y, run)
        X = spmm_X[name]
        run_amx = swell.make_swell_amx_run(dcsr, 8)
        n_amx = max(16, it // 8)
        secs, mem = first_call(lambda: run_amx(X, UNROLL))
        text = same_or_close(f"{name} SpMM chain", run_amx(X, 1 + n_amx),
                             [step_chain(layout, X, None, 1 + n_amx) for _ in range(2)])
        per = turns(lambda n: plain_chain(layout, X, None, n), lambda n: run_amx(X, n),
                    1 + n_amx // 4, 1 + n_amx)
        phase("graphs", f"{name} make_swell_amx_run k=8: x against the eager steps {text}; us "
              f"an iteration: eager PyTorch chain {spread(per['eager'])}, captured "
              f"{spread(per['captured'])}; first call {secs!r} s, graph memory {mem} B; "
              f"card: {card}")
        moving(f"{name} make_swell_amx_run k=8", layout, X, None,
               lambda xx, _, n: run_amx(xx, n))

    # F-1 alone at boneS10's chain shapes: the bench's data (the multiplier
    # rounds to 1: x bit for bit), then s ~ 1e11 from ax and y both with alpha
    # 2 and beta -0.5, and the SpMM form (no y) on AX ~ 1e11: within 1e-5 of
    # the multiplier's move plus 4 ulps (the float32 mean summed in another order)
    name, dcsr = mats[0]
    layout = swell.get_swell_plan(dcsr)
    x, y = (torch.from_numpy(a).to(dev) for a in random_x_y(dcsr.cols, dcsr.rows, seed=42))
    ax = swell.swell_ax(layout, x)
    AX = swell.swell_amx(layout, spmm_X[name])
    err = 0.0
    for label, xx, a, yy, alpha, beta in (
            ("bench data", x, ax, y, 1.0, 1.0),
            ("ax, y ~ 1e11, alpha 2, beta -0.5", x, ax * 1e11, y * 1e11, 2.0, -0.5),
            ("SpMM k=8, bench data", spmm_X[name], AX, None, 1.0, 1.0),
            ("SpMM k=8, AX ~ 1e11", spmm_X[name], AX * 1e11, None, 1.0, 1.0)):
        plain = feedback.feedback_plain(xx, a, yy, alpha, beta)
        got = feedback.feedback_(xx.clone(), a, yy, alpha, beta)
        torch.cuda.synchronize()
        s = (a if yy is None else alpha * a + beta * yy).float()
        moved = float((s * s).mean()) * 1e-30
        gap = (got - plain).abs()
        ok = bool((gap <= (1e-5 * moved + 4 * eps) * plain.abs()).all())
        if "bench data" in label:
            ok = ok and torch.equal(got, plain) and torch.equal(plain, xx)
        elif not moved > 1e-9:
            ok = False
        err = max(err, float(gap.max()))
        phase("graphs", f"F-1 {name} f64 m={dcsr.rows} n={dcsr.cols}, {label}: multiplier - 1 = "
              f"{moved!r}; max|kernel - plain| {float(gap.max())!r}; bit for bit: "
              f"{torch.equal(got, plain)}; within the tolerance: {ok}")
        if not ok:
            fail(f"F-1 disagrees with its plain version ({label})")
    xs = x.clone()
    kern = lambda: feedback.feedback_(xs, ax, y)  # noqa: E731  (the multiplier is 1)
    plain = lambda: feedback.feedback_plain(x, ax, y)  # noqa: E731
    t_p1, t_k1, t_k2, t_p2 = (cuda_time_us(plain), cuda_time_us(kern), cuda_time_us(kern),
                              cuda_time_us(plain))

    def cold_us(fn, n=21):
        """Median device µs of ``fn`` between CUDA events, each call after a
        256 MB read (5x the L2: it leaves clean lines, as the swell kernel's
        layout does before F-1 in the chain), so ``fn`` reads its inputs from
        HBM; the read takes long enough that the events and ``fn``'s launches
        are queued before it ends."""
        fn()
        times = []
        for _ in range(n):
            flush_buf.sum()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) * 1e3)
        return sorted(times)[n // 2]

    d_k1, d_e1, d_e2, d_k2 = cold_us(kern), cold_us(plain), cold_us(plain), cold_us(kern)
    m, n = dcsr.rows, dcsr.cols
    b = bound_of(16 * m + 16 * n, 5 * m + n, 34.0)
    records["feedback_f64"] = {"launches": f1["launches"], "max_abs_err": err,
                               "ms": (t_k1 + t_k2) / 2e3, "plain_ms": (t_p1 + t_p2) / 2e3,
                               "library_ms": None, **b}
    phase("graphs", f"F-1 {name} f64: kernel {t_k1!r} / {t_k2!r} us, plain (the eager "
          f"sequence) {t_p1!r} / {t_p2!r} us per call (median of 3 after 10 warmups, CUDA "
          f"events, L2-warm); device time a call from HBM (median of 21, CUDA events after a "
          f"256 MB read): kernel (one cooperative launch) {d_k1!r} / {d_k2!r} us, eager sequence "
          f"{d_e1!r} / {d_e2!r} us; bound {b['bound_ms'] * 1e3!r} us by {b['bound_by']} "
          f"(16m + 16n = {16 * m + 16 * n} B); no single PyTorch call computes it; card: {card}")
    if f1["launches"] < 1:
        fail("the boneS10 chain launched F-1 no time")


# F-2's entries a route launches, each once an iteration: the fused form on
# one device (M = I or Jacobi; any other M), its three phases where a
# distributed solve all-reduces the sums between them
F2_ROUTES = {"step": ("step",), "general": ("dot_xr", "dot_p"), "dist": ("dot", "xr", "p")}


def f2_launches(cg_update, label, iters, route="step"):
    """F-2's launches by entry since its counter was last cleared: exactly
    the route's entries, each the same number of times and at least once an
    iteration, or fail.  Returns them as a dict."""
    got = {k[1]: n for k, n in cg_update.LAUNCHES.items()}
    want = F2_ROUTES[route]
    if (iters < 1 or set(got) != set(want) or len(set(got.values())) != 1
            or got[want[0]] < iters):
        fail(f"{label}: F-2 launches {got} for {iters} iterations, not the {route} route's "
             f"{want} once an iteration")
    return got


def f2_fused_case(cu, carry, ap, inv, z, tol2, mx, sums):
    """The fused form (``cg_step``, or ``cg_dot_xr`` and ``cg_dot_p`` where
    ``z`` is given) against its plain version from one carry: (ok, max|kernel -
    plain| of x, r, p).  The sums within 1e-12 (float64) or 1e-5 (float32) of
    sum|a_i c_i| of the plain version's (p·Ap from the same p and Ap; r·z and
    r·r of the same new r); x, r and p within 1e-12 (|alpha||p| + |x|)
    elementwise plus one float32 ulp of the plain version's given the
    kernel's sums; rz, rr and it the kernel's sums and the count; masked off,
    nothing written; two launches the same bits."""
    import torch

    f32 = carry[0].dtype == torch.float32
    dot_tol = 1e-5 if f32 else 1e-12
    ulp = torch.finfo(torch.float32).eps if f32 else 0.0

    def run():
        c, w = tuple(t.clone() for t in carry), cu.Work(carry[0])
        w.sums.copy_(sums)
        if z is None:
            cu.cg_step(c, ap, w, inv, tol2, mx)
        else:
            cu.cg_dot_xr(c, ap, w, tol2, mx)
            cu.cg_dot_p(c, z, w, tol2, mx)
        return c, w.sums

    (got, ks), (got2, ks2) = run(), run()
    torch.cuda.synchronize()
    ok = all(torch.equal(a, b) for a, b in zip(got + (ks,), got2 + (ks2,)))
    if tol2 is not None and not bool((carry[4] > tol2) & (carry[5] < mx)):
        return ok and all(torch.equal(a, b) for a, b in zip(got + (ks,), carry + (sums,))), 0.0
    want, w = tuple(t.clone() for t in carry), cu.Work(carry[0])
    w.sums.copy_(ks)
    cu.cg_xr_plain(want, ap, w, inv, z is None, tol2, mx)
    rr_plain = w.sums[2].clone()
    w.sums[1:] = ks[1:]
    cu.cg_p_plain(want, w, inv, z, tol2, mx)
    rn = want[1]
    zn = z if z is not None else (rn if inv is None else inv * rn)
    for got_s, want_s, scale in ((ks[0], torch.dot(carry[2], ap), (carry[2] * ap).abs().sum()),
                                 (ks[1], torch.dot(rn, zn), (rn * zn).abs().sum()),
                                 (ks[2], rr_plain, (rn * rn).sum())):
        ok &= abs(float(got_s - want_s)) <= dot_tol * float(scale)
    alpha, beta = (carry[3] / ks[0]).abs(), (ks[1] / carry[3]).abs()
    gaps = []
    for g, wv, scale in ((got[0], want[0], alpha * carry[2].abs() + carry[0].abs()),
                         (got[1], want[1], alpha * ap.abs() + carry[1].abs()),
                         (got[2], want[2], beta * carry[2].abs() + zn.abs())):
        gap = (g - wv).abs()
        gaps.append(float(gap.max()))
        ok &= bool((gap <= 1e-12 * scale + ulp * wv.abs()).all())
    ok &= torch.equal(got[3], ks[1]) and torch.equal(got[4], ks[2]) and int(got[5]) == 6
    return ok, max(gaps)


def f2_check(dev, records, ph, label, n, inv=None):
    """F-2 (``csrc/cg_update.cu``) at one shape the smoke solves at (``n``
    rows; ``inv``: the system's Jacobi vector, else a random one) against
    its plain versions from one random carry, in float64 and float32, in the
    Jacobi, identity and general (z read) forms, unmasked, masked and
    active, masked off (by tol2, by max_iters): the fused form
    (:func:`f2_fused_case`; unmasked also from views that are not 16-B
    aligned), and each of the three phases (x, r and p within 1e-12
    (|alpha||p| + |x|) elementwise plus one float32 ulp from the same sums,
    the dots within 1e-12 (float64) or 1e-5 (float32) of sum|a_i c_i|, rz,
    rr and it equal, nothing written where masked off, two launches the same
    bits).  Fails on any miss; keeps the worst float64 gaps as the
    ``max_abs_err`` of the records ``cg_update_f64`` (the fused form) and
    ``cg_phases_f64``; reports under the smoke's phase ``ph``."""
    import numpy as np
    import torch

    from spmv_acc_tpu_torch.ops import cg_update as cu

    rng0 = np.random.default_rng(n)
    inv = torch.from_numpy(rng0.uniform(0.5, 2.0, n)).to(dev) if inv is None else inv
    recs = {k: records.setdefault(k, {}) for k in ("cg_update_f64", "cg_phases_f64")}
    for rec in recs.values():
        rec.setdefault("max_abs_err", 0.0)
    for dtype in (torch.float64, torch.float32):
        f32 = dtype == torch.float32
        ulp = torch.finfo(torch.float32).eps if f32 else 0.0
        dot_tol = 1e-5 if f32 else 1e-12
        worst, worst_fused, cases = 0.0, 0.0, 0
        for form in ("jacobi", "identity", "read"):
            for mask in ("unmasked", "active", "converged", "at max_iters", "misaligned"):
                rng = np.random.default_rng(len(form) + len(mask) + 2 * f32)
                k = int(mask == "misaligned")

                def vec(lo=-1.0, hi=1.0):
                    return torch.from_numpy(rng.uniform(lo, hi, n + k)).to(dev, dtype)[k:]

                def scalar(v, dt=dtype):
                    return torch.tensor(v, dtype=dt, device=dev)

                carry = (vec(), vec(), vec(), scalar(rng.uniform(0.5, 2.0)),
                         scalar(rng.uniform(0.5, 2.0)), scalar(5, torch.int64))
                ap, z = vec(), (vec() if form == "read" else None)
                iv = None
                if form == "jacobi":
                    iv = inv.to(dtype)
                    if k:  # the same values in a view one element into its storage
                        iv = torch.cat([iv[:1], iv])[1:]
                rr = float(carry[4])
                tol2 = mx = None
                if mask in ("active", "converged", "at max_iters"):
                    tol2 = scalar(rr * (2.0 if mask == "converged" else 0.5))
                    mx = scalar(5 if mask == "at max_iters" else 100, torch.int64)
                sums = torch.from_numpy(rng.uniform(0.5, 2.0, 3)).to(dev, dtype)
                ok, gap = f2_fused_case(cu, carry, ap, iv, z, tol2, mx, sums)
                worst_fused = max(worst_fused, gap)
                if not ok:
                    fail(f"F-2's fused form disagrees with its plain version at {label} n={n} "
                         f"({_dk(dtype)} {form} {mask}): max|kernel - plain| of x, r, p {gap!r}")
                cases += 1
                if k:
                    continue
                active = mask in ("unmasked", "active")

                def work():
                    w = cu.Work(carry[0])
                    w.sums.copy_(sums)
                    return w

                def copy(c):
                    return tuple(t.clone() for t in c)

                errs, ok = [], True

                def close(got, want, scale):
                    gap = (got - want).abs()
                    errs.append(float(gap.max()))
                    return bool((gap <= 1e-12 * scale + ulp * want.abs()).all())

                wk, wk2, wp = work(), work(), work()
                cu.cg_dot(carry[2], ap, wk, cu.PAP)
                cu.cg_dot(carry[2], ap, wk2, cu.PAP)
                cu.cg_dot_plain(carry[2], ap, wp, cu.PAP)
                torch.cuda.synchronize()
                ok &= torch.equal(wk.sums, wk2.sums)
                ok &= abs(float(wk.sums[0] - wp.sums[0])) <= dot_tol * float(
                    (carry[2] * ap).abs().sum())
                with_rz = form != "read"
                ck, ck2, cp = copy(carry), copy(carry), copy(carry)
                wk, wk2, wp = work(), work(), work()
                cu.cg_xr(ck, ap, wk, iv, with_rz, tol2, mx)
                cu.cg_xr(ck2, ap, wk2, iv, with_rz, tol2, mx)
                cu.cg_xr_plain(cp, ap, wp, iv, with_rz, tol2, mx)
                torch.cuda.synchronize()
                ok &= all(torch.equal(a, b) for a, b in zip(ck + (wk.sums,), ck2 + (wk2.sums,)))
                if not active:
                    ok &= all(torch.equal(a, b) for a, b in zip(ck + (wk.sums,), carry + (sums,)))
                alpha = (carry[3] / sums[0]).abs()
                ok &= close(ck[0], cp[0], alpha * carry[2].abs() + carry[0].abs())
                ok &= close(ck[1], cp[1], alpha * ap.abs() + carry[1].abs())
                rn = cp[1]
                zn = rn if iv is None else iv * rn
                for slot, scale in ((cu.RZ, (rn * zn).abs().sum()), (cu.RR, (rn * rn).sum())):
                    if slot == cu.RZ and not with_rz:
                        ok &= torch.equal(wk.sums[slot], sums[slot])
                    else:
                        ok &= abs(float(wk.sums[slot] - wp.sums[slot])) <= (
                            dot_tol * float(scale) + ulp * float(wp.sums[slot].abs()))
                ck, ck2 = copy(cp), copy(cp)
                wk, wk2 = cu.Work(carry[0]), cu.Work(carry[0])
                wk.sums.copy_(wp.sums)
                wk2.sums.copy_(wp.sums)
                cu.cg_p(ck, wk, iv, z, tol2, mx)
                cu.cg_p(ck2, wk2, iv, z, tol2, mx)
                cu.cg_p_plain(cp, wp, iv, z, tol2, mx)
                torch.cuda.synchronize()
                ok &= all(torch.equal(a, b) for a, b in zip(ck, ck2))
                ok &= all(torch.equal(a, b) for a, b in zip(ck[3:], cp[3:]))
                zp = z if z is not None else (ck[1] if iv is None else iv * ck[1])
                beta = (wp.sums[1] / carry[3]).abs()
                ok &= close(ck[2], cp[2], beta * carry[2].abs() + zp.abs())
                ok &= int(ck[5]) == 5 + active
                if not active:
                    ok &= torch.equal(ck[2], carry[2])
                worst = max(worst, *errs)
                if not ok:
                    fail(f"F-2's phases disagree with their plain versions at {label} n={n} "
                         f"({_dk(dtype)} {form} {mask}): max|kernel - plain| of x, r, p "
                         f"{max(errs)!r}")
        if not f32:
            recs["cg_update_f64"]["max_abs_err"] = max(recs["cg_update_f64"]["max_abs_err"],
                                                       worst_fused)
            recs["cg_phases_f64"]["max_abs_err"] = max(recs["cg_phases_f64"]["max_abs_err"],
                                                       worst)
        phase(ph, f"F-2 {_dk(dtype)} at {label} n={n}: {cases} cases (Jacobi, identity, general "
              f"forms; unmasked, active, masked off by tol2 and by max_iters; the fused form "
              f"also from views not 16-B aligned): max|kernel - plain| of x, r, p, the fused "
              f"form {worst_fused!r} (given its own sums), the phases {worst!r}; each within "
              f"the tolerance, two launches the same bits, nothing written where masked off")


def f2_phase(dev, card, records, inv, bound_of, loop_us, main_launches, flush_buf):
    """F-2 at the aniso Jacobi system (``inv``: its Jacobi vector): the
    check of :func:`f2_check`, then device µs a call of the fused
    ``cg_step``, of its plain version, of each of the three phases and their
    plain versions, and of the eager PyTorch sequence F-2 replaced
    (``cg_update.eager_step``), in a replayed graph of 20
    (``utils.timer.graph_us``: L2-warm, what the CG loop sees) and, for the
    fused step and the phases' sequence, from HBM (one iteration's launches
    captured in a graph, each replay after a 256 MB read, the median of 21),
    beside the bound.  Records ``cg_update_f64``
    (the fused step; ``main_launches``, the launches of the aniso Jacobi
    solve) and the times of ``cg_phases_f64``."""
    import numpy as np
    import torch

    from spmv_acc_tpu_torch.ops import cg_update as cu
    from spmv_acc_tpu_torch.utils.timer import graph_us

    n = inv.numel()
    f2_check(dev, records, "solver", "aniso", n, inv)
    rng = np.random.default_rng(1)

    def carry_of():
        return tuple(torch.from_numpy(rng.uniform(-1, 1, n)).to(dev) for _ in range(3)) + (
            torch.tensor(1.0, dtype=torch.float64, device=dev),
            torch.tensor(1.0, dtype=torch.float64, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))

    carry = carry_of()
    ap = torch.from_numpy(rng.uniform(-1, 1, n)).to(dev)
    tol2 = torch.tensor(0.0, dtype=torch.float64, device=dev)
    mx = torch.tensor(1 << 60, dtype=torch.int64, device=dev)
    work = cu.Work(carry[0])
    phases = {"cg_dot": (lambda: cu.cg_dot(carry[2], ap, work, cu.PAP),
                         lambda: cu.cg_dot_plain(carry[2], ap, work, cu.PAP)),
              "cg_xr": (lambda: cu.cg_xr(carry, ap, work, inv, True, tol2, mx),
                        lambda: cu.cg_xr_plain(carry, ap, work, inv, True, tol2, mx)),
              "cg_p": (lambda: cu.cg_p(carry, work, inv, None, tol2, mx),
                       lambda: cu.cg_p_plain(carry, work, inv, None, tol2, mx))}
    times = {}
    for name, (kern, plain) in phases.items():
        work.sums.fill_(1e30)  # alpha ~ 0: x and r stay put over the repeats
        times[name] = (graph_us(kern), graph_us(plain), graph_us(kern), loop_us(kern))
    # the fused step, and the phases in sequence from HBM: Ap = 1e30 p keeps x,
    # r and the sums bounded over the repeats (p grows by z a call)
    fc = carry_of()
    fap, fwork = 1e30 * fc[2], cu.Work(fc[0])

    def step():
        cu.cg_step(fc, fap, fwork, inv, tol2, mx)

    def step_plain():
        cu.cg_step_plain(fc, fap, fwork, inv, tol2, mx)

    def three():
        cu.cg_dot(fc[2], fap, fwork, cu.PAP)
        cu.cg_xr(fc, fap, fwork, inv, True, tol2, mx)
        cu.cg_p(fc, fwork, inv, None, tol2, mx)

    def cold_us(fn, k=21):
        fn()
        got = []
        for _ in range(k):
            flush_buf.sum()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            got.append(t0.elapsed_time(t1) * 1e3)
        return sorted(got)[k // 2]

    def replay_of(fn):
        """``fn``'s launches captured once in a CUDA graph: its replay (one
        host call, so that the launches follow each other on the card)."""
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        graphs.append(g)
        return g.replay

    graphs = []
    t_s1, t_sp, t_s2, t_s_host = graph_us(step), graph_us(step_plain), graph_us(step), loop_us(step)
    c_step, c_three = cold_us(replay_of(step)), cold_us(replay_of(three))

    def eager_seq():
        return cu.eager_step(carry, ap, lambda r: inv * r, tol2, mx)

    t_eager, t_eager_host = graph_us(eager_seq), loop_us(eager_seq)
    k_us = (t_s1 + t_s2) / 2
    ph_us = sum((t[0] + t[2]) / 2 for t in times.values())
    p_us = sum(t[1] for t in times.values())
    nbytes = 8 * 8 * n  # p, Ap, x, r, inv read once; x, r, p written once
    b = bound_of(nbytes, 14 * n, FP64_TFLOPS)
    records["cg_update_f64"].update({"launches": main_launches, "ms": k_us / 1e3,
                                     "plain_ms": t_sp / 1e3, "library_ms": None, **b})
    records["cg_phases_f64"].update({"ms": ph_us / 1e3, "plain_ms": p_us / 1e3,
                                     "library_ms": None, **b})
    phase("solver", f"F-2 f64 n={n} Jacobi, device us a call in a replayed graph of 20: the "
          f"fused cg_step (one cooperative launch) {t_s1!r} / {t_s2!r} (host-launched loop of "
          f"20: {t_s_host!r}), its plain version {t_sp!r}; the phases: " + "; ".join(
              f"{k} kernel {t[0]!r} / {t[2]!r} (host-launched loop of 20: {t[3]!r}), plain "
              f"{t[1]!r}" for k, t in times.items())
          + f"; an iteration: cg_step {k_us!r} us against the three phases {ph_us!r} us, their "
          f"plain versions {p_us!r} us and the eager PyTorch sequence F-2 replaced {t_eager!r} "
          f"us ({t_eager_host!r} us host-launched); from HBM (a captured iteration replayed "
          f"after a 256 MB read, median of 21): cg_step {c_step!r} us, the three phases "
          f"{c_three!r} us; bound "
          f"{b['bound_ms'] * 1e3!r} us by {b['bound_by']} ({nbytes} B: 8 vectors); no single "
          f"PyTorch call computes it; card: {card}")


def trisolve_phase(dev, card, records, bound_of, loop_us, acsr, ab):
    """F-3 (``csrc/trisolve.cu``, the ILU(0) triangular solves) at full size:
    the exact ILU(0) factors of aniso 512^2 (1023 levels a factor), dw4096-SPD
    and af23560-SPD.  For every factor, in float64 and float32: ``trisolve``
    (``tri_levels``) and ``trisolve_sweeps`` with 3 sweeps (``tri_sweeps``)
    bit for bit against their plain versions run on a CPU copy of the plan,
    two launches the same bits.  Then device µs a call (a replayed graph of
    20) of each kernel beside its plain version on the card, the bound (the
    factor's bytes over the HBM rate; the level chain: levels x the µs a
    level of ``tri_levels`` on a 4096-level chain of one row each), and
    PyTorch's ``torch.triangular_solve`` on the sparse CSR factor (cuSPARSE),
    or its refusal; the exact ILU apply at aniso against its plain version.
    The main paths, their counts set to 0 just before: ``cg_solve`` with the
    exact ILU on dw4096-SPD and af23560-SPD (the ``trisolve_f64`` record's
    launches: dw4096-SPD's) and, at aniso, ``ilu0(sweeps=3)`` with
    ``ILU_SWELL_MIN`` raised past its factors (the gather sweeps:
    ``tri_sweeps_f64``'s)."""
    import dataclasses

    import numpy as np
    import torch

    import spmv_acc_tpu_torch as port
    from spmv_acc_tpu_torch.cli.solve import spdize
    from spmv_acc_tpu_torch.formats import generate as gen
    from spmv_acc_tpu_torch.models.cg import cg_solve
    from spmv_acc_tpu_torch.ops import trisolve as tri
    from spmv_acc_tpu_torch.ops.golden import host_spmv
    from spmv_acc_tpu_torch.utils import cuda_time_us
    from spmv_acc_tpu_torch.utils.timer import graph_us

    def cpu_copy(plan):
        """The plan with its tensors on the CPU (its own cast cache)."""
        tensors = {f.name: getattr(plan, f.name).cpu() for f in dataclasses.fields(plan)
                   if isinstance(getattr(plan, f.name), torch.Tensor)}
        return dataclasses.replace(plan, _cast={}, **tensors)

    def spd_system(name):
        rp, ci, v, (m, _) = gen.example_like(name).to_numpy()
        rp2, ci2, v2 = spdize(rp.astype(np.int64), ci.astype(np.int64), v, m)
        csr = port.CSR.from_numpy(rp2, ci2, v2, (m, m), device=dev)
        x_true = np.random.default_rng(5).standard_normal(m)
        b = torch.from_numpy(host_spmv(1.0, 0.0, rp2, ci2, v2, x_true, np.zeros(m))).to(dev)
        return csr, b, x_true

    def factor_bytes(plan, item=8):
        """What one solve must move: the factor in CSR (a value and a 4-B
        column a dependency, the row pointer, the diagonal unless unit), b
        read and y written."""
        diag = 0 if plan.lower else item * plan.m
        return plan.num_deps * (item + 4) + 4 * (plan.m + 1) + diag + 2 * item * plan.m

    def factor_csr(plan):
        """The factor as a sparse CSR tensor on the card: the strict part and,
        for U, the diagonal (L's unit diagonal is not stored)."""
        rows, cols, vals = plan.dep_rows, plan.dep_cols, plan.dep_vals
        if not plan.lower:
            ar = torch.arange(plan.m, device=dev)
            rows, cols, vals = torch.cat([rows, ar]), torch.cat([cols, ar]), torch.cat(
                [vals, plan.diag])
        order = torch.argsort(rows * plan.m + cols)
        crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cumsum(torch.bincount(rows, minlength=plan.m), 0)])
        return torch.sparse_csr_tensor(crow, cols[order], vals[order], size=(plan.m, plan.m))

    def library(plan, b, y):
        """(ms a call, text) of torch.triangular_solve on the CSR factor."""
        try:
            mat = factor_csr(plan)
            fn = lambda: torch.triangular_solve(  # noqa: E731
                b.unsqueeze(1), mat, upper=not plan.lower, unitriangular=plan.lower)[0]
            got = fn()[:, 0]
            torch.cuda.synchronize()
            gap = float((got - y).abs().max() / y.abs().max())
            ms = cuda_time_us(fn) / 1e3
            return ms, (f"torch.triangular_solve on the sparse CSR factor (cuSPARSE, its "
                        f"analysis in every call) {ms!r} ms a call, max|lib - F-3| / max|y| "
                        f"{gap!r}")
        except (RuntimeError, NotImplementedError, TypeError) as e:
            return None, f"torch.triangular_solve on the sparse CSR factor refused: {e}"

    # the level chain: one row a level, one dependency a row, the one-block form
    nch = 4096
    rp_c = np.r_[0, 1, np.arange(3, 2 * nch, 2)]
    ci_c = np.r_[0, np.stack([np.arange(nch - 1), np.arange(1, nch)], 1).ravel()]
    chain = tri.analyze_trisolve(rp_c, ci_c, np.ones(len(ci_c)), (nch, nch), lower=True,
                                 unit_diag=False, device=dev)
    if chain.num_levels != nch or chain.widest_level != 1:
        fail("the level chain's plan is not a chain")
    cb = torch.ones(nch, dtype=torch.float64, device=dev)
    us_level = graph_us(lambda: tri.trisolve(chain, cb), calls=5) / nch
    phase("trisolve", f"the level chain: {nch} levels of one row, tri_levels (one block) "
          f"{us_level * nch!r} us a call in a replayed graph of 5, {us_level!r} us a level; "
          f"card: {card}")

    systems = {"aniso 512^2": (acsr, ab, None)}
    for name in ("dw4096", "af23560"):
        systems[f"{name}-SPD"] = spd_system(name)
    facts = {}
    rng = np.random.default_rng(15)
    for label, (csr, b, _) in systems.items():
        t0 = time.perf_counter()
        fact = facts[label] = tri.ilu0(csr, sweeps=0)
        torch.cuda.synchronize()
        t_fact = time.perf_counter() - t0
        for fname, plan in (("L", fact.l_plan), ("U", fact.u_plan)):
            cplan = cpu_copy(plan)
            bh = torch.from_numpy(rng.uniform(-1, 1, plan.m))
            form = "grid" if plan.widest_level > tri._BLOCK_MAX else "one block"
            for dtype in (torch.float64, torch.float32):
                bc = bh.to(dtype)
                bd = bc.to(dev)
                tri.LAUNCHES.clear()
                y1, y2 = tri.trisolve(plan, bd), tri.trisolve(plan, bd)
                s1, s2 = tri.trisolve_sweeps(plan, bd, 3), tri.trisolve_sweeps(plan, bd, 3)
                torch.cuda.synchronize()
                launched = dict(tri.LAUNCHES)
                want, want_s = tri.trisolve_plain(cplan, bc), tri.trisolve_sweeps_plain(
                    cplan, bc, 3)
                same = (torch.equal(y1.cpu(), want) and torch.equal(y1, y2)
                        and torch.equal(s1.cpu(), want_s) and torch.equal(s1, s2))
                finite = bool(torch.isfinite(y1).all() and torch.isfinite(s1).all())
                phase("trisolve", f"{label} {fname} ({plan.m} rows, {plan.num_deps} "
                      f"dependencies, at most {int(plan.dep_len.max())} a row, "
                      f"{plan.num_levels} levels, widest {plan.widest_level}: {form}) "
                      f"{str(dtype)[6:]}: tri_levels and tri_sweeps (3) bit for bit their "
                      f"plain versions on a CPU copy, two launches the same bits: {same}; "
                      f"finite: {finite}; launches {launched}")
                if not same or not finite:
                    fail(f"{label} {fname} {dtype}: F-3 differs from its plain version")
                if sum(launched.values()) != 4:
                    fail(f"{label} {fname}: F-3 did not launch once a solve")
        phase("trisolve", f"{label}: ilu0(sweeps=0) factor and plans {t_fact!r} s")

    # device µs a call beside the plain versions, the bounds and the library
    for label in ("aniso 512^2", "dw4096-SPD", "af23560-SPD"):
        fact = facts[label]
        for fname, plan in (("L", fact.l_plan), ("U", fact.u_plan)):
            b = torch.from_numpy(rng.uniform(-1, 1, plan.m)).to(dev)
            lv = lambda: tri.trisolve(plan, b)  # noqa: E731
            sw = lambda: tri.trisolve_sweeps(plan, b, 3)  # noqa: E731
            calls = 5 if plan.num_levels > 600 else 20
            t_lv = (graph_us(lv, calls=calls), graph_us(lv, calls=calls))
            t_sw = (graph_us(sw), graph_us(sw))
            p_lv = loop_us(lambda: tri.trisolve_plain(plan, b), 2)
            p_sw = loop_us(lambda: tri.trisolve_sweeps_plain(plan, b, 3), 5)
            lib_ms, lib_text = library(plan, b, lv())
            nbytes = factor_bytes(plan)
            ops = 2 * plan.num_deps + 2 * plan.m
            bl, bs = bound_of(nbytes, ops, FP64_TFLOPS), bound_of(nbytes, 3 * ops, FP64_TFLOPS)
            chain_us = plan.num_levels * us_level
            phase("trisolve", f"{label} {fname} f64, device us a call in a replayed graph: "
                  f"tri_levels {t_lv[0]!r} / {t_lv[1]!r} (plain, host-launched loop of 2: "
                  f"{p_lv!r}), tri_sweeps (3) {t_sw[0]!r} / {t_sw[1]!r} (plain {p_sw!r}); "
                  f"bound {bl['bound_ms'] * 1e3!r} us by {bl['bound_by']} ({nbytes} B at the "
                  f"HBM rate), the level chain {chain_us!r} us ({plan.num_levels} levels x "
                  f"{us_level!r}); {lib_text}; card: {card}")
            if label == "aniso 512^2" and fname == "L":
                records["trisolve_f64"] = {"max_abs_err": 0.0, "ms": sum(t_lv) / 2e3,
                                           "plain_ms": p_lv / 1e3, "library_ms": lib_ms, **bl}
                records["tri_sweeps_f64"] = {"max_abs_err": 0.0, "ms": sum(t_sw) / 2e3,
                                             "plain_ms": p_sw / 1e3, "library_ms": None, **bs}
        exact = facts[label]
        b = systems[label][1]
        ms_k = loop_us(lambda: exact.solve(b), 5) / 1e3
        ms_p = loop_us(lambda: tri.trisolve_plain(exact.u_plan, tri.trisolve_plain(
            exact.l_plan, b)), 2) / 1e3
        phase("trisolve", f"{label} exact ILU apply (two F-3 launches): {ms_k!r} ms a call "
              f"(host-launched loop of 5), the plain version {ms_p!r} ms; card: {card}")

    # the main paths: cg_solve as called with the exact ILU, and the gather sweeps
    for label in ("dw4096-SPD", "af23560-SPD"):
        csr, b, x_true = systems[label]
        walls = []
        for _ in range(3):
            tri.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = cg_solve(csr, b, tol=1e-8, max_iters=1000, strategy="swell",
                           precond=facts[label])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launched = dict(tri.LAUNCHES)
        err = float(np.linalg.norm(res.x.cpu().numpy() - x_true) / np.linalg.norm(x_true))
        met = float(res.residual_norm) <= 1e-8 * float(b.norm())
        phase("trisolve", f"{label} cg_solve(precond=ilu0(sweeps=0)) as called: "
              f"{res.iters} iterations, residual met: {met}, rel err {err!r}; walls "
              f"{walls!r} s (best {min(walls)!r}); F-3 launches of the last solve "
              f"{launched}; card: {card}")
        if not met or sum(launched.values()) < 2 * (res.iters + 1):
            fail(f"{label}: the exact-ILU CG did not converge or did not run F-3 an apply")
        if any(k[1] == "sweeps" for k in launched) != (facts[label].l_plan.rows_sorted is None):
            fail(f"{label}: F-3 ran another entry than the plan asks")
        if label == "dw4096-SPD":
            records["trisolve_f64"]["launches"] = sum(launched.values())
    was = tri.ILU_SWELL_MIN
    tri.ILU_SWELL_MIN = 1 << 62
    try:
        gather = tri.ilu0(acsr, sweeps=3)
    finally:
        tri.ILU_SWELL_MIN = was
    if gather.swell is not None:
        fail("ilu0 built a swell backing past ILU_SWELL_MIN")
    tri.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = cg_solve(acsr, ab, tol=1e-8, max_iters=4000, strategy="swell", precond=gather)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = dict(tri.LAUNCHES)
    met = float(res.residual_norm) <= 1e-8 * float(ab.norm())
    phase("trisolve", f"aniso 512^2 cg_solve(precond=ilu0(sweeps=3)), ILU_SWELL_MIN past "
          f"its factors (the gather sweeps on F-3): {res.iters} iterations, residual met: "
          f"{met}, {secs!r} s as called; F-3 launches {launched}; card: {card}")
    if not met or set(launched) != {("f64", "sweeps")} or launched[("f64", "sweeps")] < 2 * (
            res.iters + 1):
        fail("the gather-sweep ILU CG did not converge or did not run tri_sweeps an apply")
    records["tri_sweeps_f64"]["launches"] = launched[("f64", "sweeps")]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    from spmv_acc_tpu_torch.ops import _build

    # the disk plan cache in a directory of this run alone, deleted at its end:
    # every swell layout the run builds is saved there, and the run reads back
    # only entries it wrote
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    plan_dir = tempfile.mkdtemp(prefix="smoke_plans_", dir=_build.BUILD_DIR)
    os.environ["SPMV_TPU_PLAN_CACHE_DIR"] = plan_dir
    os.environ.pop("SPMV_TPU_NO_PLAN_CACHE", None)
    try:
        return smoke(plan_dir)
    finally:
        shutil.rmtree(plan_dir, ignore_errors=True)


def smoke(plan_dir: str) -> int:
    import numpy as np
    import torch

    import spmv_acc_tpu_torch as port
    from spmv_acc_tpu_torch.formats import generate as gen
    from spmv_acc_tpu_torch.io import write_bin2
    from spmv_acc_tpu_torch.io.native import available as native_available
    from spmv_acc_tpu_torch.ops import _build
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.ops.golden import host_spmm, host_spmv
    from spmv_acc_tpu_torch.utils import cuda_time_us, verify_y
    from spmv_acc_tpu_torch.utils.stats import bytes_moved, chip_peak_gbs

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    def loop_us(fn, n=20):
        """Device µs per call of ``fn`` over a loop of ``n`` calls (CUDA events)."""
        fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) * 1e3 / n

    flush_buf = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB

    def device_us(fn, kernel, n=20, cold=False):
        """Device µs per launch of the CUDA kernels whose name holds ``kernel``,
        by torch.profiler over ``n`` calls of ``fn`` (None if it saw none): the
        time a short kernel runs, without the host path that bounds a loop.
        ``cold`` writes 256 MB (5x the L2) before each call, so the kernel
        reads its inputs from HBM and its writes evict dirty lines to HBM."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if cold:
                    flush_buf.zero_()
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if kernel in e.key]
        total = sum(getattr(e, "device_time_total", 0.0) or e.cuda_time_total for e in evs)
        count = sum(e.count for e in evs)
        return total / count if count else None

    def sweep(label, resched, run, values):
        """µs per launch (loop of 20) of ``run`` on the plan ``resched(C)``
        for every chunk cap C in ``values``, in turns up and down."""
        plans = {c: resched(c) for c in values}
        up = {c: loop_us(lambda: run(plans[c])) for c in values}
        down = {c: loop_us(lambda: run(plans[c])) for c in reversed(values)}
        phase("sweep", f"{label}: " + "; ".join(
            f"C={c}: {up[c]!r} / {down[c]!r} us ({plans[c].schedule.nchunks} chunks, "
            f"{plans[c].schedule.nsplit} split)" for c in values) + f"; card: {card}")

    def tensor_bytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def bound_of(nbytes, ops, tflops):
        """The least time for the work: bytes over the card's HBM rate or
        operations over the peak rate of their type, whichever is larger."""
        t_bytes = nbytes / (peak_gbs * 1e9) * 1e3
        t_ops = ops / (tflops * 1e12) * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    lib_cache = {}

    def library(csr, X):
        """(per-call ms, loop us per call) of PyTorch's CSR product (cuSPARSE)
        computing A @ X on the same inputs, or (None, None) when it refuses."""
        key = (id(csr.values), id(X))
        if key not in lib_cache:
            mat = torch.sparse_csr_tensor(csr.row_ptr, csr.col_idx, csr.values, size=csr.shape,
                                          check_invariants=False)
            fn = (lambda: torch.mv(mat, X)) if X.dim() == 1 else (lambda: mat @ X)
            try:
                lib_cache[key] = (cuda_time_us(fn) / 1e3, loop_us(fn))
            except RuntimeError as e:
                phase("times", f"PyTorch's CSR product refused {tuple(X.shape)} "
                      f"{X.dtype}: {e}")
                lib_cache[key] = (None, None)
        return lib_cache[key]

    def finish(record, label, nbytes, ops, tflops, lib, layout_bytes=None):
        """Print (and record) the bound of ``nbytes`` and ``ops`` and the
        library time; ``layout_bytes``, the arrays the kernel actually reads,
        are printed beside it and bound nothing."""
        b = bound_of(nbytes, ops, tflops)
        lib_text = ("no PyTorch call computes it" if lib[0] is None else
                    f"PyTorch CSR product {lib[1]!r} us per call in a loop of 20, "
                    f"{lib[0]!r} ms per call (median of 3)")
        lay_text = ("" if layout_bytes is None else
                    f"; layout bytes {layout_bytes} ({layout_bytes / nbytes!r} x the bound's)")
        phase("times", f"{label}: bound {b['bound_ms'] * 1e3!r} us by {b['bound_by']} "
              f"({nbytes} B at {peak_gbs!r} GB/s, {ops} operations at {tflops} TFLOP/s)"
              f"{lay_text}; {lib_text}")
        if record:
            records[record].update(library_ms=lib[0], **b)
    tdt = {np.float64: torch.float64, np.float32: torch.float32}
    t_start = time.perf_counter()

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True)
    if nvcc.returncode != 0:
        fail("nvcc --version failed")
    peak_gbs = chip_peak_gbs()
    phase("env", f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {kind} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {card}; nvcc: {nvcc.stdout.strip().splitlines()[-1]}; "
          f"peak HBM from the card's clock x bus width: {peak_gbs!r} GB/s")

    # 2. build the kernels from the checkout's sources, one nvcc each, all at
    # once (and the host analyze library)
    t0 = time.perf_counter()
    for src, so in zip(_build.SOURCES, _build.build_all()):
        _build.load_lib(src)
        secs, log = _build.build_log.get(src, (0.0, "(already built)"))
        phase("build", f"{os.path.relpath(so)} in {secs:.2f}s; ptxas: {ptxas_summary(log)}")
    phase("build", f"all kernels in {time.perf_counter() - t0:.2f}s; native analyze "
          f"library: {native_available()}")

    # 3. every kernel variant against its plain version on the card
    for name, make in smoke_matrices(gen).items():
        for dtype in (np.float64, np.float32):
            csr = make().astype(tdt[dtype]).to(dev)
            m, n = csr.shape
            x, _ = gen.random_x_y(n, m, seed=75, dtype=dtype)
            layout = swell.get_swell_plan(csr)
            dx = torch.from_numpy(x).to(dev)
            a = swell.swell_ax(layout, dx)
            p = swell.swell_ax_plain(layout, dx)
            torch.cuda.synchronize()
            compare(f"{name} {np.dtype(dtype).name}", csr, x, a, p)
    rng = np.random.default_rng(3)
    for name, make in bsr_cases(gen).items():
        base = make()
        for dtype, r, k in ([(np.float64, r, k) for r in (1, 2, 3, 4) for k in (1, 3, 8)]
                            + [(np.float32, r, k) for r in (2, 4) for k in (1, 8)]):
            csr = base.astype(tdt[dtype]).to(dev)
            layout = swell.get_swell_plan(csr, r=r)
            X = rng.standard_normal((csr.cols, k)).astype(dtype)
            dX = torch.from_numpy(X).to(dev)
            a = swell.swell_amx(layout, dX)
            p = swell.swell_amx_plain(layout, dX)
            torch.cuda.synchronize()
            compare(f"{name} {np.dtype(dtype).name} r={r}", csr, X, a, p)
    phase("h1-vs-plain", f"kernel launches so far by (dtype, r, k): {dict(swell.LAUNCHES)}")

    # 3b. the tile and ELL row-sum kernels against their plain versions; the
    # ELL kernel at every vector size, two launches bit for bit equal
    from spmv_acc_tpu_torch.formats.convert import csr_to_ell
    from spmv_acc_tpu_torch.ops import adaptive_plus as ap
    from spmv_acc_tpu_torch.ops import vector_row as vr

    def twice(label, fn):
        """``fn()`` twice; fails unless both give the same bits (NaN included)."""
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)):
            fail(f"{label}: two launches differ")
        return a

    def ell_vs(ell):
        return vr.vector_size(ell.width, ell.values.element_size())

    for name, make in smoke_matrices(gen).items():
        for dtype in (np.float64, np.float32):
            csr = make().astype(tdt[dtype]).to(dev)
            m, n = csr.shape
            x, _ = gen.random_x_y(n, m, seed=76, dtype=dtype)
            dx = torch.from_numpy(x).to(dev)
            dp = ap.get_tile_plan(csr)
            a, p = ap.tile_spmv(dp, dx), ap.tile_spmv_plain(dp, dx)
            torch.cuda.synchronize()
            compare(f"tile {name} {np.dtype(dtype).name}", csr, x, a, p, "zoo-vs-plain")
            ell = csr_to_ell(csr)
            p = vr.ell_rowsum_plain(ell, dx)[:m]
            a = vr.ell_rowsum(ell, dx)[:m]
            torch.cuda.synchronize()
            compare(f"ell {name} {np.dtype(dtype).name} vs={ell_vs(ell)} (ell_rowsum)", csr, x,
                    a, p, "zoo-vs-plain")
            for vs in ELL_SWEEP:
                label = f"ell {name} {np.dtype(dtype).name} vs={vs}"
                a = twice(label, lambda: vr._launch(ell, dx, vs))[:m]
                compare(f"{label}, two launches bit for bit equal", csr, x, a, p, "zoo-vs-plain")

    def ell_rows_csr(lens, n, seed, dtype):
        """A CSR whose rows hold ``lens`` cells each, at distinct random columns;
        only every fifth row may hold column 0."""
        rng = np.random.default_rng(seed)
        cols = [np.sort(rng.choice(np.arange(i % 5 != 0, n), ln, replace=False))
                for i, ln in enumerate(lens)]
        return port.CSR.from_numpy(np.concatenate([[0], np.cumsum(lens)]), np.concatenate(cols),
                                   rng.standard_normal(int(np.sum(lens))).astype(dtype),
                                   (len(lens), n), device=dev)

    # a slab whose rows all reach the width (no padding term), and x[0] = inf
    # on a slab with padded and unpadded rows: the kernel must be non-finite on
    # exactly the rows where the whole-slab plain version is
    for dtype in (np.float64, np.float32):
        dn = np.dtype(dtype).name
        full = ell_rows_csr(np.full(4000, 24), 5000, 81, dtype)
        ell = csr_to_ell(full)
        if int(ell.row_len.min()) != ell.width or ell.padded_rows != full.rows:
            fail("the unpadded slab has padding")
        x, _ = gen.random_x_y(5000, 4000, seed=82, dtype=dtype)
        dx = torch.from_numpy(x).to(dev)
        p = vr.ell_rowsum_plain(ell, dx)
        for vs in ELL_SWEEP:
            a = twice(f"ell unpadded {dn} vs={vs}", lambda: vr._launch(ell, dx, vs))
            compare(f"ell unpadded 4000 rows x width {ell.width} {dn} vs={vs}", full, x, a, p,
                    "zoo-vs-plain")
        rng = np.random.default_rng(83)
        mixed = ell_rows_csr(np.where(np.arange(3001) % 2 == 1, 16, rng.integers(0, 17, 3001)),
                             3001, 84, dtype)
        ell = csr_to_ell(mixed)
        x, _ = gen.random_x_y(3001, 3001, seed=85, dtype=dtype)
        x[0] = np.inf
        dx = torch.from_numpy(x).to(dev)
        p = vr.ell_rowsum_plain(ell, dx)
        bad = ~torch.isfinite(p)
        fx = dx.double().abs().nan_to_num(posinf=0.0)
        bound = (ell.values.double().abs() * fx[ell.col_idx.long()]).sum(1)
        allowed = ROW_TOL * bound + (F32_ULP * p.double().abs() if dtype == np.float32 else 0.0)
        for vs in ELL_SWEEP:
            a = twice(f"ell x[0]=inf {dn} vs={vs}", lambda: vr._launch(ell, dx, vs))
            same = torch.equal(~torch.isfinite(a), bad)
            gap = (a.double() - p.double()).abs()[~bad]
            within = bool((gap <= allowed[~bad]).all())
            phase("zoo-vs-plain", f"ell x[0]=inf {dn} vs={vs}: {int(bad.sum())} of "
                  f"{ell.padded_rows} rows non-finite in the plain version, the same rows in "
                  f"the kernel: {same}; the other rows max|kernel-plain|="
                  f"{float(gap.max())!r} within {ROW_TOL}*(|A||x|): {within}")
            if not (same and within) or not bool(bad.any()) or bool(bad.all()):
                fail(f"ell x[0]=inf {dn} vs={vs}: the kernel disagrees with its plain version")
    phase("zoo-vs-plain", f"launches so far: tile {dict(ap.LAUNCHES)}, ELL {dict(vr.LAUNCHES)}")

    # 3c. the plane split (bit for bit) and the plane-form swell on every smoke matrix
    def planes_check(name, csr, layout, dx):
        """prep_x's kernel against prep_x_plain as int16, and swell_ax_planes
        against its plain version (float32: also against the direct kernel,
        bit for bit)."""
        planes = swell.prep_x(layout, dx)
        plain = swell.prep_x_plain(layout, dx)
        torch.cuda.synchronize()
        same = torch.equal(planes.view(torch.int16), plain.view(torch.int16))
        phase("plane-split", f"{name} {csr.rows}x{csr.cols} delta={layout.delta} nchunks="
              f"{layout.nchunks} planes {tuple(planes.shape)}: kernel == prep_x_plain bit for "
              f"bit: {same}")
        if not same:
            fail(f"{name}: the plane-split kernel differs from prep_x_plain")
        a = swell.swell_ax_planes(layout, planes)
        p = swell.swell_ax_planes_plain(layout, planes)
        xt = swell._planes_x(layout, planes, torch.arange(csr.cols, device=dev))
        torch.cuda.synchronize()
        max_abs = compare(name, csr, xt.cpu().numpy(), a, p, "swell-planes")
        if csr.dtype == torch.float32:
            direct = swell.swell_ax(layout, dx)
            torch.cuda.synchronize()
            same = torch.equal(a, direct)
            phase("swell-planes", f"{name}: float32 plane form == direct kernel bit for bit: "
                  f"{same}")
            if not same:
                fail(f"{name}: the float32 plane form differs from the direct kernel")
        return max_abs

    deltas = []
    for name, make in smoke_matrices(gen).items():
        for dtype in (np.float64, np.float32):
            csr = make().astype(tdt[dtype]).to(dev)
            x, _ = gen.random_x_y(csr.cols, csr.rows, seed=77, dtype=dtype)
            layout = swell.get_swell_plan(csr, r=1)
            planes_check(f"{name} {np.dtype(dtype).name}", csr, layout,
                         torch.from_numpy(x).to(dev))
            deltas.append(layout.delta)
    if max(deltas) <= 0:
        fail("no smoke matrix has a plan with a column shift delta > 0")
    phase("plane-split", f"launches so far: {dict(swell.LAUNCHES)}; largest delta "
          f"{max(deltas)}")

    # 3d. the same checks with the chunk schedules cut to 1 and to 4 slot rows
    # (tile: one block, or runs of at most 4 rows), so that every row block of
    # more is split and its partials go through the fix-up pass; two launches
    # must agree bit for bit
    from spmv_acc_tpu_torch.ops import swell_plan, tile_plan

    default_rows = (swell_plan.SWELL_CHUNK_ROWS, tile_plan.TILE_CHUNK_ROWS)

    for cut in (1, 4):
        swell_plan.SWELL_CHUNK_ROWS = tile_plan.TILE_CHUNK_ROWS = cut
        swell.clear_swell_cache()
        ap.clear_tile_cache()
        swell.LAUNCHES.clear()
        ap.LAUNCHES.clear()
        for name, make in smoke_matrices(gen).items():
            for dtype in (np.float64, np.float32):
                csr = make().astype(tdt[dtype]).to(dev)
                x, _ = gen.random_x_y(csr.cols, csr.rows, seed=78, dtype=dtype)
                dx = torch.from_numpy(x).to(dev)
                label = f"{name} {np.dtype(dtype).name} cut={cut}"
                layout = swell.get_swell_plan(csr)
                a = twice(label, lambda: swell.swell_ax(layout, dx))
                compare(f"{label} r={layout.r} {sched_text(layout.schedule)}; two launches "
                        f"bit for bit equal", csr, x, a, swell.swell_ax_plain(layout, dx))
                dp = ap.get_tile_plan(csr)
                a = twice(f"tile {label}", lambda: ap.tile_spmv(dp, dx))
                compare(f"tile {label} {sched_text(dp.schedule)}; two launches bit for bit "
                        f"equal", csr, x, a, ap.tile_spmv_plain(dp, dx), "zoo-vs-plain")
                planes_check(label, csr, swell.get_swell_plan(csr, r=1), dx)
        for name, make in bsr_cases(gen).items():
            base = make()
            for dtype in (np.float64, np.float32):
                csr = base.astype(tdt[dtype]).to(dev)
                for r in (1, 2, 3, 4):
                    # an r x r plan takes SWELL_CHUNK_ROWS // r slot rows a chunk
                    swell_plan.SWELL_CHUNK_ROWS = cut * r
                    layout = swell.get_swell_plan(csr, r=r)
                    if layout.schedule.max_rows != cut:
                        fail(f"{name} r={r}: chunks of {layout.schedule.max_rows}, not {cut}")
                    for k in (1, 3, 8):
                        X = rng.standard_normal((csr.cols, k)).astype(dtype)
                        dX = torch.from_numpy(X).to(dev)
                        label = f"{name} {np.dtype(dtype).name} r={r} k={k} cut={cut}"
                        a = twice(label, lambda: swell.swell_amx(layout, dX))
                        compare(f"{label} {sched_text(layout.schedule)}; two launches bit "
                                f"for bit equal", csr, X, a, swell.swell_amx_plain(layout, dX))
        fixups = {key: c for key, c in swell.LAUNCHES.items() if "fixup" in str(key[-1])}
        phase("h1-vs-plain", f"cut={cut}: swell launches {dict(swell.LAUNCHES)}; tile "
              f"{dict(ap.LAUNCHES)}")
        if not fixups or not ap.LAUNCHES[("f64", "fixup")] or not ap.LAUNCHES[("f32", "fixup")]:
            fail(f"cut={cut}: the fix-up passes did not run")
    swell_plan.SWELL_CHUNK_ROWS, tile_plan.TILE_CHUNK_ROWS = default_rows
    swell.clear_swell_cache()
    ap.clear_tile_cache()
    phase("h1-vs-plain", f"schedules back to SWELL_CHUNK_ROWS {default_rows[0]}, "
          f"TILE_CHUNK_ROWS {default_rows[1]}")
    records = {}

    # 4. the main path at full size: boneS10 through spmv(strategy="adaptive")
    t0 = time.perf_counter()
    bone = gen.example_like("boneS10")
    t_gen = time.perf_counter() - t0
    m, n = bone.shape
    x, y = gen.random_x_y(n, m, seed=42)
    bone_dev = csr = bone.to(dev)
    dx, dy = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    h = port.Handle()
    swell.LAUNCHES.clear()
    out = port.spmv(csr, dx, dy, alpha=1.0, beta=1.0, strategy="adaptive", handle=h)
    torch.cuda.synchronize()
    cold = {"boneS10": (h.kernel_time_us, dict(swell.PLAN_TIMES))}
    launches = launches_of(swell, "f64", 1, 1)
    rp, ci, v, _ = bone.to_numpy()
    rep = verify_y(out, host_spmv(1.0, 1.0, rp, ci, v, x, y))
    layout = swell.get_swell_plan(csr)
    phase("main-path", f"boneS10 {m}x{n} nnz={bone.nnz} (generated in {t_gen:.1f}s): "
          f"strategy={h.strategy_used} r={layout.r} kernel launches={launches} "
          f"analyze (get_plan)={h.analyze_time_us:.0f}us picker, layout and kernel="
          f"{h.kernel_time_us:.0f}us "
          f"slabs={layout.slab_off.numel()} slots={layout.slots} fill={layout.fill!r} verify {rep}")
    if h.strategy_used != "swell" or layout.r != 1:
        fail(f"boneS10 went to {h.strategy_used!r} with r={layout.r}, not swell with r=1")
    if launches < 1:
        fail("the main path launched the swell kernel no time")
    if tuple(out.shape) != (m,) or not torch.isfinite(out).all() or not rep.ok:
        fail("boneS10 output is wrong")
    records["swell_spmv_f64"] = {"launches": launches}

    # 5. the BSR main path at full size: TSOPF_RS_b2383, r = 4 by the detector
    t0 = time.perf_counter()
    tsopf = gen.example_like("TSOPF_RS_b2383")
    t_gen = time.perf_counter() - t0
    tm, tn = tsopf.shape
    tx, ty = gen.random_x_y(tn, tm, seed=42)
    tsopf_dev = tsopf.to(dev)
    h = port.Handle()
    swell.LAUNCHES.clear()
    out = port.spmv(tsopf_dev, torch.from_numpy(tx).to(dev), torch.from_numpy(ty).to(dev),
                    alpha=1.0, beta=1.0, strategy="adaptive", handle=h)
    torch.cuda.synchronize()
    cold["TSOPF_RS_b2383"] = (h.kernel_time_us, dict(swell.PLAN_TIMES))
    launches = launches_of(swell, "f64", 4, 1)
    trp, tci, tv, _ = tsopf.to_numpy()
    rep = verify_y(out, host_spmv(1.0, 1.0, trp, tci, tv, tx, ty))
    tlay = swell.get_swell_plan(tsopf_dev)
    phase("bsr-main-path", f"TSOPF_RS_b2383 {tm}x{tn} nnz={tsopf.nnz} (generated in "
          f"{t_gen:.1f}s): strategy={h.strategy_used} r={tlay.r} kernel launches={launches} "
          f"analyze (get_plan)={h.analyze_time_us:.0f}us picker, layout and kernel="
          f"{h.kernel_time_us:.0f}us node slots={tlay.slots} fill={tlay.fill!r} "
          f"verify {rep}")
    if h.strategy_used != "swell" or tlay.r != 4:
        fail(f"TSOPF_RS_b2383 went to {h.strategy_used!r} with r={tlay.r}, not swell with r=4")
    if launches < 1 or not torch.isfinite(out).all() or not rep.ok:
        fail("the BSR main path did not launch the r=4 kernel or its output is wrong")
    records["swell_bsr_r4_f64"] = {"launches": launches}

    # 5b. the disk plan cache: phases 4 and 5 built and saved boneS10's and
    # TSOPF_RS_b2383's layouts (cold); with the process's caches dropped, the
    # first spmv(strategy="adaptive") loads them (warm), as a second process
    # would, and runs the kernel over the loaded layout
    def split(times):
        return ", ".join(f"{k} {t!r} s" for k, t in times.items())

    for name, host, dcsr, (xn, yn), r in (("boneS10", bone, bone_dev, (x, y), 1),
                                          ("TSOPF_RS_b2383", tsopf, tsopf_dev, (tx, ty), 4)):
        live = swell.get_swell_plan(dcsr)
        hrp, hci, hv, hshape = host.to_numpy()
        entry = swell._plan_cache_path(hrp, hci, hv, hshape, torch.float64, None)
        cold_us, cold_times = cold[name]
        if "save" not in cold_times or not os.path.exists(entry):
            fail(f"{name}: the cold call saved no layout ({split(cold_times)})")
        dxn, dyn = torch.from_numpy(xn).to(dev), torch.from_numpy(yn).to(dev)
        port.dispatch.clear_caches()
        h = port.Handle()
        swell.LAUNCHES.clear()
        out = port.spmv(dcsr, dxn, dyn, alpha=1.0, beta=1.0, strategy="adaptive", handle=h)
        torch.cuda.synchronize()
        warm = dict(swell.PLAN_TIMES)
        launches = launches_of(swell, "f64", r, 1)
        rep = verify_y(out, host_spmv(1.0, 1.0, hrp, hci, hv, xn, yn))
        loaded = swell.get_swell_plan(dcsr)
        same = layouts_equal(live, loaded)
        phase("plan-cache", f"{name}: cold first call: picker, layout and kernel {cold_us!r} us; "
              f"split {split(cold_times)}; entry {os.path.getsize(entry) / 1e6!r} MB "
              f"({os.path.basename(entry)}); warm first call: analyze (get_plan) "
              f"{h.analyze_time_us!r} us, picker, layout and kernel {h.kernel_time_us!r} us; "
              f"split {split(warm)}; strategy={h.strategy_used} r={loaded.r} kernel "
              f"launches={launches}; verify {rep}; loaded layout == live layout tensor for "
              f"tensor: {same}; card: {card}")
        if "load" not in warm or "slabs" in warm or "layout" in warm:
            fail(f"{name}: the warm call did not load the saved layout")
        if (not same or launches < 1 or h.strategy_used != "swell" or loaded.r != r
                or not torch.isfinite(out).all() or not rep.ok):
            fail(f"{name}: the loaded layout differs or its run is wrong")
        swell.LAUNCHES.clear()
        a = twice(f"{name} live layout", lambda: swell.swell_ax(live, dxn))
        b = twice(f"{name} loaded layout", lambda: swell.swell_ax(loaded, dxn))
        launches = launches_of(swell, "f64", r, 1)
        equal = torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        phase("plan-cache", f"{name}: swell_ax over the live and the loaded layout, two "
              f"launches each ({launches} launches): equal in bytes: {equal}")
        if not equal or launches != 4:
            fail(f"{name}: the kernel over the loaded layout differs from the live one")
        del live, loaded, a, b

    # spmv-cli twice on boneS10's bin2, two processes sharing a fresh cache
    # directory: the first builds and saves the layout, the second loads it
    root = os.path.dirname(os.path.abspath(__file__))
    cli_dir = tempfile.mkdtemp(prefix="cli_", dir=plan_dir)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "boneS10.bin2")
        write_bin2(path, *bone.to_numpy())
        env = dict(os.environ, SPMV_TPU_PLAN_CACHE_DIR=cli_dir)
        walls = []
        for run in ("cold", "warm"):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "spmv_acc_tpu_torch.cli.main", path,
                                   "-f", "bin2"], capture_output=True, text=True, env=env,
                                  cwd=root, timeout=600)
            walls.append(time.perf_counter() - t0)
            for ln in proc.stdout.splitlines():
                phase("plan-cache", f"spmv-cli {run}: {ln}")
            files, nbytes = dir_bytes(cli_dir)
            phase("plan-cache", f"spmv-cli boneS10.bin2 {run} cache: returned "
                  f"{proc.returncode} in {walls[-1]!r} s wall (taken outside the process); "
                  f"cache directory {files} entries, {nbytes} B; card: {card}")
            if proc.returncode != 0 or "Congratulation" not in proc.stdout or files != 1:
                fail(f"spmv-cli {run}: rc {proc.returncode}; {proc.stderr[-2000:]}")
    phase("plan-cache", f"spmv-cli boneS10 warm / cold wall: {walls[1] / walls[0]!r}")

    # 6. SpMM, k = 8, on the reference's SPMM_MATRICES
    K = 8
    spmm_X = {}
    swell.LAUNCHES.clear()
    for name, host, dcsr in (("TSOPF_RS_b2383", tsopf, tsopf_dev), ("boneS10", bone, bone_dev)):
        rp_, ci_, v_, (mm, nn) = host.to_numpy()
        X = np.random.default_rng(8).uniform(-1, 1, (nn, K))
        Y = np.random.default_rng(9).uniform(-1, 1, (mm, K))
        dX, dY = torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)
        out = port.spmm(dcsr, dX, dY, alpha=1.0, beta=1.0, strategy="swell")
        run = swell.make_swell_amx_run(dcsr, K)
        chained = run(dX, 3)
        torch.cuda.synchronize()
        rep = verify_y(out.cpu().numpy().ravel(),
                       host_spmm(1.0, 1.0, rp_, ci_, v_, X, Y).ravel())
        ok_chain = bool(torch.isfinite(chained).all()) and torch.allclose(chained, dX, rtol=1e-15)
        phase("spmm", f"{name} k={K}: spmm(strategy='swell') r={swell.get_swell_plan(dcsr).r} "
              f"verify {rep}; make_swell_amx_run 3 iterations finite and stable: {ok_chain}")
        if not rep.ok or not ok_chain:
            fail(f"{name}: SpMM k={K} is wrong")
        spmm_X[name] = dX
    launches = launches_of(swell, "f64", None, K)
    phase("spmm", f"k={K} kernel launches: {launches}")
    if launches < 1:
        fail("the SpMM path launched the kernel no time")
    records["swell_spmm_k8_f64"] = {"launches": launches}

    # 6b. the chained loops as captured CUDA graphs, and F-1
    t0 = time.perf_counter()
    graphs_phase(dev, card, records, [("boneS10", bone_dev), ("TSOPF_RS_b2383", tsopf_dev)],
                 spmm_X, bound_of, flush_buf)
    phase("graphs", f"phase took {time.perf_counter() - t0:.1f}s")

    # 7. float32: spmv-cli on af23560 and boneS10 through spmv(adaptive)
    from spmv_acc_tpu_torch.cli.main import main as cli_main

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "af23560.bin2")
        af = gen.example_like("af23560")
        write_bin2(path, *af.to_numpy())
        rc32 = cli_main([path, "-f", "bin2", "--dtype", "float32"])
        rc = cli_main([path, "-f", "bin2"])
    af32 = af.astype(torch.float32).to(dev)
    arp, aci, av, (am, an) = af32.to_numpy()
    ax32, ay32 = gen.random_x_y(an, am, seed=42, dtype=np.float32)
    out = port.spmv(af32, torch.from_numpy(ax32).to(dev), torch.from_numpy(ay32).to(dev),
                    alpha=1.0, beta=1.0)
    rep32 = verify_y(out, host_spmv(1.0, 1.0, arp, aci, av, ax32, ay32), dtype=np.float32)
    phase("cli", f"spmv-cli af23560.bin2 -f bin2 --dtype float32 returned {rc32} (its run: "
          f"max_error {rep32.max_error!r}, verify {rep32}); -f bin2 (float64) returned {rc}")
    if rc32 != 0 or rc != 0 or not rep32.ok:
        fail(f"spmv-cli returned {rc32} (float32) / {rc} (float64)")

    bone32 = bone.astype(torch.float32).to(dev)
    x32, y32 = gen.random_x_y(n, m, seed=42, dtype=np.float32)
    h = port.Handle()
    swell.LAUNCHES.clear()
    out = port.spmv(bone32, torch.from_numpy(x32).to(dev), torch.from_numpy(y32).to(dev),
                    alpha=1.0, beta=1.0, handle=h)
    torch.cuda.synchronize()
    launches = launches_of(swell, "f32", 1, 1)
    rep = verify_y(out, host_spmv(1.0, 1.0, rp, ci, v.astype(np.float32), x32, y32),
                   dtype=np.float32)
    phase("f32-main-path", f"boneS10 float32: strategy={h.strategy_used} kernel launches="
          f"{launches} analyze (get_plan)={h.analyze_time_us:.0f}us picker, layout and kernel="
          f"{h.kernel_time_us:.0f}us max_error {rep.max_error!r} verify {rep}")
    if h.strategy_used != "swell" or launches < 1 or out.dtype != torch.float32 or not rep.ok:
        fail("the float32 main path is wrong")
    records["swell_spmv_f32"] = {"launches": launches}

    # 7b. adaptive_plus and vector_row at full size: boneS10 in both dtypes,
    # TSOPF_RS_b2383 (buckets of depth up to 128) through adaptive_plus
    def zoo_run(label, host, dcsr, strategy, x_np, y_np, dtype, mod, key):
        rp_, ci_, v_, (mm, nn) = host.to_numpy()
        h = port.Handle()
        mod.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = port.spmv(dcsr, torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev),
                        alpha=1.0, beta=1.0, strategy=strategy, handle=h)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = sum(c for k_, c in mod.LAUNCHES.items() if key(k_))
        rep = verify_y(out, host_spmv(1.0, 1.0, rp_, ci_, v_.astype(dtype), x_np, y_np),
                       dtype=dtype)
        phase("zoo-main-path", f"{label} {mm}x{nn} nnz={host.nnz} {np.dtype(dtype).name}: "
              f"spmv(strategy={strategy!r}) launches={dict(mod.LAUNCHES)} first call "
              f"{secs:.2f}s (analyze (get_plan) {h.analyze_time_us:.0f}us, layout and kernel "
              f"{h.kernel_time_us:.0f}us) max_error {rep.max_error!r} verify {rep}")
        if (launches < 1 or h.strategy_used != strategy or tuple(out.shape) != (mm,)
                or not torch.isfinite(out).all() or not rep.ok):
            fail(f"{label} {strategy} {np.dtype(dtype).name}: no kernel launch or a wrong result")
        return launches

    for dtype, dcsr, xs in ((np.float64, bone_dev, (x, y)), (np.float32, bone32, (x32, y32))):
        nm = np.dtype(dtype).name
        dk = "f64" if dtype == np.float64 else "f32"
        records[f"tile_spmv_{dk}"] = {"launches": zoo_run(
            "boneS10", bone, dcsr, "adaptive_plus", *xs, dtype, ap, lambda k_, d=dk: k_ == d)}
        dp = ap.get_tile_plan(dcsr)
        phase("zoo-main-path", f"boneS10 {nm} tile layout: {dp.blk_depth.numel()} blocks, "
              f"{dp.slots} slots, fill {dp.fill_efficiency!r}, depths "
              f"{sorted(set(dp.blk_depth.tolist()))}")
        records[f"ell_rowsum_{dk}"] = {"launches": zoo_run(
            "boneS10", bone, dcsr, "vector_row", *xs, dtype, vr, lambda k_, d=dk: k_[0] == d)}
    bone_ell = port.dispatch._get_ell(bone_dev, port.DEFAULT_TUNE)
    phase("zoo-main-path", f"boneS10 ELL: {bone_ell.padded_rows} x {bone_ell.width} = "
          f"{bone_ell.padded_rows * bone_ell.width} cells (budget "
          f"{port.dispatch._ELL_MAX_CELLS}), {bone.nnz} stored (row_len), vs f64 "
          f"{ell_vs(bone_ell)}, f32 {vr.vector_size(bone_ell.width, 4)}")
    zoo_run("TSOPF_RS_b2383", tsopf, tsopf_dev, "adaptive_plus", tx, ty, np.float64, ap,
            lambda k_: k_ == "f64")
    tdp = ap.get_tile_plan(tsopf_dev)
    depths = sorted(set(tdp.blk_depth.tolist()))
    phase("zoo-main-path", f"TSOPF_RS_b2383 tile layout: {tdp.blk_depth.numel()} blocks in "
          f"{tdp.num_row_blocks} row blocks, {tdp.slots} slots, depths {depths}")
    if max(depths) != 128:
        fail("TSOPF_RS_b2383 has no block of depth 128")

    # 7c. every strategy on af23560 at full size
    af_dev = af.to(dev)
    ax64, ay64 = gen.random_x_y(an, am, seed=42)
    agold = host_spmv(1.0, 1.0, *af.to_numpy()[:3], ax64, ay64)
    for strategy in sorted(port.STRATEGIES):
        h = port.Handle()
        out = port.spmv(af_dev, torch.from_numpy(ax64).to(dev), torch.from_numpy(ay64).to(dev),
                        alpha=1.0, beta=1.0, strategy=strategy, handle=h)
        torch.cuda.synchronize()
        rep = verify_y(out, agold)
        phase("strategies", f"af23560 {strategy} (ran {h.strategy_used}): max_error "
              f"{rep.max_error!r} verify {rep}")
        if not rep.ok or not torch.isfinite(out).all():
            fail(f"strategy {strategy} is wrong on af23560")

    # 7d. spmv-benchmark from its main: af23560 with every engine, boneS10 with four
    import contextlib
    import io

    from spmv_acc_tpu_torch.cli.benchmark import ENGINES
    from spmv_acc_tpu_torch.cli.benchmark import main as bench_main

    bone_engines = ["spmv-acc-swell", "spmv-acc-adaptive-plus", "spmv-acc-vector-row",
                    "torch-sparse-csr"]
    with tempfile.TemporaryDirectory() as td:
        for name, host, engines, extra in (
                ("af23560", af, [e for e, _ in ENGINES], []),
                ("boneS10", bone, [e for e, _ in ENGINES if e in bone_engines],
                 ["--engines", ",".join(bone_engines)])):
            path = os.path.join(td, f"{name}.bin2")
            write_bin2(path, *host.to_numpy())
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = bench_main([path, "-f", "bin2", *extra])
            rows = [ln.split(",") for ln in buf.getvalue().splitlines()
                    if ln.startswith(f"PERFORMANCE,{name}.bin2,")]
            for r in rows:
                phase("benchmark", ",".join(r))
            phase("benchmark", f"{name}: spmv-benchmark returned {rc} in "
                  f"{time.perf_counter() - t0:.1f}s with {len(rows)} rows; card: {card}")
            if (rc != 0 or [r[2] for r in rows] != engines
                    or any(r[-2] != "0" for r in rows)):
                fail(f"spmv-benchmark on {name}: rc {rc}, rows {[r[2] for r in rows]}")

    # 7e. the plane split and the plane-form swell on boneS10, both dtypes
    for dcsr, xb in ((bone_dev, gen.random_x_y(n, m, seed=42)[0]), (bone32, x32)):
        planes_check(f"boneS10 {str(dcsr.dtype)[6:]}", dcsr, swell.get_swell_plan(dcsr),
                     torch.from_numpy(xb).to(dev))

    # 7e'. the port's benchmark as a user runs it, on the large shapes no other
    # phase has (Hardesty3: rectangular, the most rows; RM07R: the detector's
    # r = 3; largebasis: the lowest fill) and rajat03, SpGEMM and the solvers
    # left to their phases; each matrix's stderr line gives the swell kernel's
    # launches in its adaptive call, counted from 0 in the bench's process
    import ast

    t0 = time.perf_counter()
    names = [nm for nm, _, _ in BENCH_LARGE] + list(BENCH_SMALL)
    proc = subprocess.run([sys.executable, "-m", "spmv_acc_tpu_torch.bench"], capture_output=True,
                          text=True, cwd=root, timeout=600, env=dict(
                              os.environ, SPMV_TPU_BENCH_ONLY=",".join(names),
                              SPMV_TPU_BENCH_SPGEMM="0", SPMV_TPU_BENCH_SOLVER="0"))
    secs = time.perf_counter() - t0
    for ln in proc.stderr.splitlines():
        phase("bench", ln.strip())
    out_lines = proc.stdout.strip().splitlines()
    try:
        last = json.loads(out_lines[-1])
    except (IndexError, ValueError):
        fail(f"the bench printed no JSON last line (rc {proc.returncode})")
    phase("bench", f"python -m spmv_acc_tpu_torch.bench ({','.join(names)}) returned "
          f"{proc.returncode} in {secs!r} s; {len(out_lines)} JSON lines; last: {out_lines[-1]}; "
          f"card: {card}")
    if (proc.returncode != 0 or "partial" in last or last.get("verify_all_pass") is not True
            or last.get("verify_raw_kernel_all_pass") is not True
            or last.get("large_done") != len(BENCH_LARGE) or last.get("corpus") != len(names)):
        fail("the bench's last line is partial, failed a verify flag or misses a matrix")
    for nm, record, r in BENCH_LARGE:
        got = re.search(rf"^  {nm}: .* strategy=(\S+) r=(\d+) .* launches=(\{{.*?\}})  device",
                        proc.stderr, re.M)
        if not got:
            fail(f"the bench printed no line for {nm}")
        counts = ast.literal_eval(got.group(3))
        n_launch = counts.get(("f64", r, 1), 0)
        phase("bench", f"{nm}: strategy={got.group(1)} r={got.group(2)}, swell kernel launches "
              f"in the adaptive call {counts}")
        if got.group(1) != "swell" or int(got.group(2)) != r or n_launch < 1:
            fail(f"{nm} went to {got.group(1)} r={got.group(2)}, not swell r={r} with a launch")
        records[record] = {"launches": n_launch}

    # entry(): the flagship step on the card (float32 swell, r = 1) against its
    # plain version, within 1e-12 (|A||x|) plus a float32 ulp of each rounding
    from spmv_acc_tpu_torch.entry import entry

    efn, eargs = entry()
    elay, ex, ey = eargs
    swell.LAUNCHES.clear()
    ea = efn(*eargs)
    torch.cuda.synchronize()
    e_launches = launches_of(swell, "f32", 1, 1)
    eax = swell.swell_ax_plain(elay, ex)
    ep = eax + ey
    ecsr = gen.random_csr(512, 512, 4096, seed=7, dtype=np.float32).to(dev)
    egap = (ea.double() - ep.double()).abs().cpu().numpy()
    eallowed = (ROW_TOL * row_bound(ecsr, ex.cpu().numpy())[:, 0]
                + F32_ULP * (eax.double().abs() + ep.double().abs()).cpu().numpy())
    e_ok = bool(torch.isfinite(ea).all()) and bool((egap <= eallowed).all())
    phase("bench", f"entry(): fn(layout, x, y) on {ea.device} {tuple(ea.shape)} {ea.dtype}; swell "
          f"launches {dict(swell.LAUNCHES)}; max|fn - plain| {float(egap.max())!r} within "
          f"{ROW_TOL}*(|A||x|) + 2^-23(|Ax| + |plain|): {e_ok}")
    if not e_ok or e_launches != 1:
        fail("entry()'s step disagrees with its plain version or did not launch the kernel once")
    e_k = [cuda_time_us(lambda: efn(*eargs)) for _ in range(2)]
    e_p = [cuda_time_us(lambda: swell.swell_ax_plain(elay, ex) + ey) for _ in range(2)]
    records["swell_entry_f32"] = {"launches": e_launches, "max_abs_err": float(egap.max()),
                                  "ms": sum(e_k) / 2e3, "plain_ms": sum(e_p) / 2e3}
    phase("bench", f"entry() step: {e_k!r} us per call, plain {e_p!r} us (median of 3 after 10 "
          f"warmups); card: {card}")
    finish("swell_entry_f32", "entry() f32 r=1 k=1", spmv_bytes(ecsr) + 4 * 512, 2 * ecsr.nnz,
           F32_TFLOPS, library(ecsr, ex))

    # 7f. the solver path at full size: the JAX package's two solver workloads
    # (bench.py bench_solver, bench_solver_aniso)
    from spmv_acc_tpu_torch.cli.solve import spdize
    from spmv_acc_tpu_torch.models.cg import _cg_loop, cg_solve, jacobi_preconditioner
    from spmv_acc_tpu_torch.ops import cg_update
    from spmv_acc_tpu_torch.ops import trisolve as tri

    def solved(label, res, x_true, b_norm, tol, max_iters, gate=None):
        err = float(np.linalg.norm(res.x.cpu().numpy() - x_true) / np.linalg.norm(x_true))
        met = float(res.residual_norm) <= tol * b_norm
        phase("solver", f"{label}: {res.iters} iterations (max {max_iters}), residual "
              f"{float(res.residual_norm)!r} (tol {tol} x |b| = {tol * b_norm!r}, met: {met}), "
              f"rel err against x_true {err!r}")
        if not met:
            fail(f"{label}: CG ended at {res.iters} iterations without meeting tol")
        if gate is not None and not err < gate:
            fail(f"{label}: rel err {err!r} misses the {gate} gate")
        return err

    def captured_vs_eager(system, label, lay, pre, b, max_iters, res):
        """cg_solve's result (``res``: plain iterations, then captured blocks)
        and a ``CGBlocks`` captured from the first iteration against the eager
        loop on the same swell matvec: iterations equal and the recorded ones,
        x bit for bit where the eager loop repeats itself; the solve's wall
        seconds and µs an iteration of fixed-trip loops (tol 0, 65 and 513
        iterations), captured and eager in turns."""
        from spmv_acc_tpu_torch import bench
        from spmv_acc_tpu_torch.models.cg import CGBlocks

        M = pre.solve if isinstance(pre, tri.ILU0) else pre
        mv = lambda v: swell.swell_ax(lay, v)  # noqa: E731
        x0 = torch.zeros_like(b)
        walls, runs = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(_cg_loop(mv, M, b, x0, 1e-8, max_iters))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        solver = CGBlocks(mv, M, b, eager_iters=0)
        first = solver.solve(b, x0, 1e-8, max_iters)  # captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = solver.solve(b, x0, 1e-8, max_iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = same_or_close(f"{system} cg[{label}]", res.x, [r.x for r in runs])
        text_c = same_or_close(f"{system} cg[{label}] captured", first.x, [r.x for r in runs])
        want = CG_ITERS[(system, label)]
        per = {"eager": [], "captured": []}
        if system.startswith("aniso"):  # Ga41As41H72-SPD's residual reaches 0 before 513
            for which in ("eager", "captured", "captured", "eager"):
                fn = ((lambda n: _cg_loop(mv, M, b, x0, 0.0, n).residual_norm)
                      if which == "eager" else
                      (lambda n: solver.solve(b, x0, 0.0, n).residual_norm))
                per[which].append(bench._slope_us(fn, 65, 513, dev))
        phase("solver", f"{system} cg[{label}] against the eager loop: iterations cg_solve "
              f"{res.iters}, captured from the first iteration {first.iters}, {again.iters} "
              f"again, eager {runs[0].iters} (recorded {want}); x of cg_solve {text}; x "
              f"captured {text_c}; solve wall captured {wall!r} s (its graphs captured "
              f"before), eager {walls!r} s; us an iteration (fixed-trip loops of 65 and 513, "
              f"aniso): captured {per['captured']!r}, eager {per['eager']!r}; card: {card}")
        if not res.iters == first.iters == runs[0].iters == again.iters == want:
            fail(f"{system} cg[{label}]: cg_solve {res.iters}, captured {first.iters}, eager "
                 f"{runs[0].iters} iterations, recorded {want}")
        return min(per["captured"], default=None)

    t0 = time.perf_counter()
    ga = gen.example_like("Ga41As41H72")
    grp, gci, gv, (gm, _) = ga.to_numpy()
    grp2, gci2, gv2 = spdize(grp.astype(np.int64), gci.astype(np.int64), gv, gm)
    gcsr = port.CSR.from_numpy(grp2, gci2, gv2, (gm, gm), device=dev)
    phase("solver", f"Ga41As41H72 {gm}x{gm} nnz={ga.nnz}, SPD-ized nnz={len(gci2)} (made in "
          f"{time.perf_counter() - t0:.1f}s)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gfact = tri.ilu0(gcsr, sweeps=3)
    torch.cuda.synchronize()
    t_factor = time.perf_counter() - t0
    if gfact.swell is None:
        fail("Ga41As41H72-SPD: ilu0 built no swell backing")
    glay = swell.get_swell_plan(gcsr)
    g0 = torch.ones(gm, dtype=torch.float64, device=dev)
    us_spmv = loop_us(lambda: swell.swell_ax(glay, g0))
    glay1 = swell.get_swell_plan(gcsr, r=1)
    us_spmv1 = loop_us(lambda: swell.swell_ax(glay1, g0))
    us_lib = library(gcsr, g0)[1]
    depth = torch.ones_like(glay.slab_off) << glay.slab_log2d.long()
    rb_of = torch.repeat_interleave(torch.arange(glay.mrb, device=dev),
                                    torch.diff(glay.rb_slab_ptr))
    rows_per_rb = torch.zeros(glay.mrb, dtype=torch.int64, device=dev).index_add_(0, rb_of, depth)
    phase("solver", f"Ga41As41H72-SPD row lengths: max {int(np.diff(grp2).max())}, mean "
          f"{len(gci2) / gm:.1f}; slot rows a row block (one thread block walks them in "
          f"turn): max {int(rows_per_rb.max())}, mean {float(rows_per_rb.double().mean()):.1f}; "
          f"slabs a row block: max {int(torch.diff(glay.rb_slab_ptr).max())}")
    # the swell kernel against its plain version at the solver's shapes: the
    # matrix's layout and the strict L and U layouts of the ILU sweeps
    def strict_csr(plan):
        """The CSR of a factor's off-diagonal entries (its TriSolvePlan's deps)."""
        rows, cols, vals = (t.cpu().numpy() for t in (plan.dep_rows, plan.dep_cols,
                                                       plan.dep_vals))
        order = np.lexsort((cols, rows))
        rp_ = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=plan.m))])
        return port.CSR.from_numpy(rp_, cols[order], vals[order], (plan.m, plan.m), device=dev)

    gx = torch.from_numpy(np.random.default_rng(6).uniform(-1, 1, gm)).to(dev)
    solver_err = 0.0
    for name, lay, mat in (("Ga41As41H72-SPD", glay, gcsr),
                           ("Ga41As41H72-SPD ILU strict L", gfact.swell.layout_l,
                            strict_csr(gfact.l_plan)),
                           ("Ga41As41H72-SPD ILU strict U", gfact.swell.layout_u,
                            strict_csr(gfact.u_plan))):
        a, p = swell.swell_ax(lay, gx), swell.swell_ax_plain(lay, gx)
        torch.cuda.synchronize()
        solver_err = max(solver_err, compare(f"{name} r={lay.r} slots={lay.slots}", mat,
                                             gx.cpu().numpy(), a, p, "solver"))
    t_p1, t_k1, t_k2, t_p2 = (cuda_time_us(lambda: swell.swell_ax_plain(glay, gx)),
                              cuda_time_us(lambda: swell.swell_ax(glay, gx)),
                              cuda_time_us(lambda: swell.swell_ax(glay, gx)),
                              cuda_time_us(lambda: swell.swell_ax_plain(glay, gx)))
    phase("solver", f"Ga41As41H72-SPD swell f64: kernel {t_k1!r} / {t_k2!r} us, plain "
          f"{t_p1!r} / {t_p2!r} us per call (median of 3 after 10 warmups); card: {card}")
    records["swell_solver_f64"] = {"max_abs_err": solver_err, "ms": (t_k1 + t_k2) / 2e3,
                                   "plain_ms": (t_p1 + t_p2) / 2e3}
    finish("swell_solver_f64", "Ga41As41H72-SPD swell f64 r=1 k=1", spmv_bytes(gcsr),
           2 * gcsr.nnz, FP64_TFLOPS, library(gcsr, g0), tensor_bytes(
               glay.vals, glay.lidx, glay.slab_off, glay.slab_log2d, glay.slab_col_base,
               glay.rb_slab_ptr, g0, g0))
    # tools: trace around three boneS10 swell launches (the exported trace must
    # name the kernel) and bandwidth_report of one call.  Here, as the process's
    # first torch.profiler session, with the others seconds after it: with torch
    # 2.11 (CUDA 12.8) on an H100, a session that starts some 30 s after the
    # process's previous one records no CUDA kernels at all, and a later session
    # recorded none of this region in three smoke runs where it came after two
    # sessions minutes earlier and two just before
    from spmv_acc_tpu_torch.utils.profiling import bandwidth_report, trace

    bone_lay = swell.get_swell_plan(bone_dev)
    bx_dev = torch.from_numpy(gen.random_x_y(bone.cols, bone.rows, seed=42)[0]).to(dev)
    with tempfile.TemporaryDirectory() as td:
        with trace(td) as prof:
            for _ in range(3):
                swell.swell_ax(bone_lay, bx_dev)
        (tfile,) = os.listdir(td)
        with open(os.path.join(td, tfile)) as f:
            named = "swell_kernel" in f.read()
    kernels = sorted({e.key for e in prof.key_averages() if "swell_kernel" in e.key})
    us = cuda_time_us(lambda: swell.swell_ax(bone_lay, bx_dev))
    phase("tools", f"trace around three boneS10 swell launches: {tfile} names the swell "
          f"kernel: {named} ({kernels}); bandwidth_report of one call ({us!r} us per call, "
          f"median of 3): {bandwidth_report(bone.rows, bone.nnz, us)}; card: {card}")
    if not named or not kernels:
        fail("the exported trace does not name the swell kernel")
    del bone_lay
    gs = glay.schedule
    ga_ax = lambda: swell.swell_ax(glay, g0)  # noqa: E731
    phase("solver", f"Ga41As41H72-SPD swell schedule: {sched_text(gs)} for {glay.mrb} row "
          f"blocks; partial buffer {gs.nparts * glay.r * 128 * 8} B at k = 1; device time "
          f"(torch.profiler) chunk kernel {device_us(ga_ax, 'swell_kernel')!r} us, fix-up "
          f"{device_us(ga_ax, 'fixup_kernel')!r} us a launch; card: {card}")
    sweep(f"Ga41As41H72-SPD swell f64 r={glay.r} k=1", lambda c: swell.rescheduled(glay, c),
          lambda lay: swell.swell_ax(lay, g0), SWELL_SWEEP)
    phase("solver", f"Ga41As41H72-SPD swell layout: r={glay.r}, {glay.mrb} row blocks, "
          f"{glay.slots} slots, fill {glay.fill!r}, tail {glay.tail_v.numel()}; r=1 layout "
          f"{glay1.slots} slots, fill {glay1.fill!r}: {us_spmv1!r} us a launch; L factor "
          f"{gfact.swell.layout_l.slots} slots (r={gfact.swell.layout_l.r}), U "
          f"{gfact.swell.layout_u.slots} slots (r={gfact.swell.layout_u.r}); PyTorch CSR "
          f"product {us_lib!r} us a call (loops of 20); card: {card}")
    swell.LAUNCHES.clear()
    gfact.solve(g0)
    torch.cuda.synchronize()
    per_apply = dict(swell.LAUNCHES)
    us_apply = loop_us(lambda: gfact.solve(g0))
    phase("solver", f"Ga41As41H72-SPD: ilu0(sweeps=3) factor+plans {t_factor!r} s (levels L "
          f"{gfact.l_plan.num_levels}, U {gfact.u_plan.num_levels}; off-diagonal nnz "
          f"{gfact.l_plan.num_deps + gfact.u_plan.num_deps}); swell SpMV {us_spmv!r} us, ILU "
          f"apply (3 sweeps per factor on the swell kernel) {us_apply!r} us = "
          f"{us_apply / us_spmv!r} x SpMV (CUDA-event loops of 20); swell launches of one "
          f"ILU apply {per_apply}; card: {card}")
    x_true = np.random.default_rng(5).standard_normal(gm)
    gb = host_spmv(1.0, 0.0, grp2, gci2, gv2, x_true, np.zeros(gm))
    dgb, gb_norm = torch.from_numpy(gb).to(dev), float(np.linalg.norm(gb))
    g_launches = {}
    gjac = jacobi_preconditioner(gcsr)
    f2_check(dev, records, "solver", "Ga41As41H72-SPD", gm, gjac.inv)
    for label, pre in (("jacobi", gjac), ("ilu", gfact)):
        swell.LAUNCHES.clear()
        cg_update.LAUNCHES.clear()
        box = []
        secs, mem = first_call(lambda: box.append(cg_solve(
            gcsr, dgb, tol=1e-8, max_iters=300, strategy="swell", precond=pre)))
        res = box[0]
        launches = g_launches[label] = launches_of(swell, "f64")
        solved(f"Ga41As41H72-SPD cg[{label}] ({secs!r} s, any capture included, graph memory "
               f"{mem} B; swell launches {dict(swell.LAUNCHES)})", res, x_true, gb_norm, 1e-8,
               300, gate=1e-6)
        if launches < res.iters:
            fail(f"Ga41As41H72-SPD cg[{label}] launched the swell kernel {launches} times "
                 f"in {res.iters} iterations")
        phase("solver", f"Ga41As41H72-SPD cg[{label}]: F-2 launches " + repr(f2_launches(
            cg_update, f"Ga41As41H72-SPD cg[{label}]", res.iters,
            "general" if label == "ilu" else "step")))
        captured_vs_eager("Ga41As41H72-SPD", label, glay, pre, dgb, 300, res)
    # the ILU-preconditioned solve is the solver path's record
    records["swell_solver_f64"]["launches"] = g_launches["ilu"]
    del gfact, glay, gcsr

    t0 = time.perf_counter()
    nx = 512
    acsr = gen.aniso_laplacian_csr(nx, nx, 1e-4).to(dev)
    am_, _ = acsr.shape
    arp_, aci_, av_, _ = acsr.to_numpy()
    ax_true = np.random.default_rng(5).standard_normal(am_)
    ab = torch.from_numpy(host_spmv(1.0, 0.0, arp_, aci_, av_, ax_true, np.zeros(am_))).to(dev)
    ab_norm = float(torch.linalg.norm(ab))
    ajac = jacobi_preconditioner(acsr)
    afact = tri.ilu0(acsr, sweeps=3)
    alay = swell.get_swell_plan(acsr)
    torch.cuda.synchronize()
    phase("solver", f"aniso {nx}^2 eps=1e-4: {am_} rows, nnz={acsr.nnz}, ilu0(sweeps=3) and "
          f"plans {time.perf_counter() - t0:.2f}s, swell backing: {afact.swell is not None}")
    axs = torch.from_numpy(np.random.default_rng(6).uniform(-1, 1, am_)).to(dev)
    a, p = swell.swell_ax(alay, axs), swell.swell_ax_plain(alay, axs)
    torch.cuda.synchronize()
    compare(f"aniso {nx}^2 r={alay.r} slots={alay.slots}", acsr, axs.cpu().numpy(), a, p,
            "solver")
    aiters, aper = {}, {}
    f2_main = 0
    for label, pre in (("jacobi", ajac), ("ilu", afact)):
        swell.LAUNCHES.clear()
        cg_update.LAUNCHES.clear()
        box = []
        secs, mem = first_call(lambda: box.append(cg_solve(
            acsr, ab, tol=1e-8, max_iters=4000, strategy="swell", precond=pre)))
        res = box[0]
        solved(f"aniso cg[{label}] ({secs!r} s, any capture included, graph memory {mem} B, "
               f"{secs / max(res.iters, 1) * 1e6!r} us per iteration; swell launches "
               f"{dict(swell.LAUNCHES)})", res, ax_true, ab_norm, 1e-8, 4000)
        if launches_of(swell, "f64") < res.iters:
            fail(f"aniso cg[{label}] launched the swell kernel fewer times than it iterated")
        f2 = f2_launches(cg_update, f"aniso cg[{label}]", res.iters,
                         "general" if label == "ilu" else "step")
        phase("solver", f"aniso cg[{label}]: F-2 launches {f2} in {res.iters} iterations")
        if label == "jacobi":  # F-2's main path: the record's launches
            f2_main = sum(f2.values())
        aiters[label] = res.iters
        aper[label] = captured_vs_eager(f"aniso {nx}^2", label, alay, pre, ab, 4000, res)

    f2_phase(dev, card, records, ajac.inv, bound_of, loop_us, f2_main, flush_buf)
    # the bench's solver section as the bench runs it (its timed_cg on F-2)
    from spmv_acc_tpu_torch import bench as port_bench

    cg_update.LAUNCHES.clear()
    blog = io.StringIO()
    bsol = port_bench.bench_solver_aniso(blog, dev)
    for ln in blog.getvalue().splitlines():
        phase("solver", f"bench_solver_aniso: {ln.strip()}")
    bit = (bsol["solver_aniso_cg_iters_jacobi"], bsol["solver_aniso_cg_iters_ilu"])
    phase("solver", f"bench_solver_aniso: {bsol}; F-2 launches {dict(cg_update.LAUNCHES)}")
    if (bit != (aiters["jacobi"], aiters["ilu"]) or cg_update.LAUNCHES[("f64", "step")] < bit[0]
            or cg_update.LAUNCHES[("f64", "dot_xr")] < bit[1]):
        fail("the bench's solver section left cg_solve's iterations or did not run F-2")
    per_j, per_i = aper["jacobi"], aper["ilu"]
    win = (aiters["jacobi"] * per_j) / (aiters["ilu"] * per_i)
    exact = tri.ILU0(afact.l_plan, afact.u_plan, sweeps=0)
    ms_exact = loop_us(lambda: exact.solve(ab), 2) / 1e3
    phase("solver", f"aniso per iteration (captured fixed-trip loops of 65 and 513, host "
          f"clock): jacobi {per_j!r} us, ilu(3 sweeps) {per_i!r} us; total_wall_win {win!r}; "
          f"exact ILU apply (two F-3 launches over {afact.l_plan.num_levels} + "
          f"{afact.u_plan.num_levels} levels) {ms_exact!r} ms; card: {card}")
    # the exact ILU captured: two F-3 launches an apply in the graph
    from spmv_acc_tpu_torch.models.cg import CGBlocks

    amv = lambda v: swell.swell_ax(alay, v)  # noqa: E731
    eager_x = [_cg_loop(amv, exact.solve, ab, torch.zeros_like(ab), 0.0, 8).x for _ in range(2)]
    box = []
    ablock = CGBlocks(amv, exact.solve, ab, eager_iters=0)
    tri.LAUNCHES.clear()
    secs, mem = first_call(lambda: box.append(ablock.solve(ab, torch.zeros_like(ab), 0.0, 8)))
    f3 = dict(tri.LAUNCHES)
    same = torch.equal(box[0].x, eager_x[0]) and torch.equal(eager_x[0], eager_x[1])
    phase("solver", f"aniso cg[exact ilu], 8 iterations in one captured block of "
          f"{box[0].iters}: x bit for bit the eager loop's (which repeats itself): {same}; "
          f"first call {secs!r} s with the capture, graph memory {mem} B; F-3 launches "
          f"(the warm-up's and the replay's, 2 an apply) {f3}; card: {card}")
    if box[0].iters != 8 or not same:
        fail("the captured exact-ILU CG did not run its 8 iterations bit for bit")
    if set(f3) != {("f64", "levels_block")} or f3[("f64", "levels_block")] < 2 * 9:
        fail("the captured exact-ILU CG did not run F-3's tri_levels")
    del ablock
    trisolve_phase(dev, card, records, bound_of, loop_us, acsr, ab)

    # the JAX package's on-chip form: every matvec splits p into bf16 planes and
    # reads them in the plane-form swell kernel
    swell.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = _cg_loop(lambda v: swell.swell_ax_planes(alay, swell.prep_x(alay, v)), ajac, ab,
                   torch.zeros_like(ab), 1e-8, 4000)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    plane_launches = dict(swell.LAUNCHES)
    solved(f"aniso cg[jacobi] plane form ({secs!r} s; launches {plane_launches})", res,
           ax_true, ab_norm, 1e-8, 4000)
    gap = abs(res.iters - aiters["jacobi"])
    phase("solver", f"aniso plane form {res.iters} against direct {aiters['jacobi']} "
          f"iterations: gap {gap} (allowed {max(2, 0.02 * aiters['jacobi'])!r})")
    if gap > max(2, 0.02 * aiters["jacobi"]):
        fail("the plane-form CG's iteration count is too far from the direct form's")
    for name, key in (("plane_split", ("f64", "plane_split")),
                      ("swell_planes", ("f64", 1, 1, "planes"))):
        records[f"{name}_f64"] = {"launches": plane_launches.get(key, 0)}
        if records[f"{name}_f64"]["launches"] < 1:
            fail(f"the plane-form CG launched {name} no time")

    # 7g. spmv-solve on af23560, Jacobi and ILU(0)
    from spmv_acc_tpu_torch.cli.solve import main as solve_main

    f2_check(dev, records, "solve-cli", "af23560", af.rows)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "af23560.bin2")
        write_bin2(path, *af.to_numpy())
        for pre in ("jacobi", "ilu0"):
            buf = io.StringIO()
            cg_update.LAUNCHES.clear()
            with contextlib.redirect_stdout(buf):
                rc = solve_main([path, "-f", "bin2", "--precond", pre])
            for ln in buf.getvalue().splitlines():
                phase("solve-cli", ln)
            if rc != 0 or "Congratulation, solution verified!" not in buf.getvalue():
                fail(f"spmv-solve --precond {pre} returned {rc}")
            its = int(re.search(r"iters=(\d+)", buf.getvalue()).group(1))
            phase("solve-cli", f"--precond {pre}: F-2 launches " + repr(f2_launches(
                cg_update, f"spmv-solve --precond {pre}", its,
                "general" if pre == "ilu0" else "step")))

    # 7h. SpGEMM: A @ A on the JAX bench's three matrices (bench.py:300-341), the
    # symbolic phase on the host and the numeric phase (plain PyTorch: a gather
    # and a segment sum, as the JAX package's XLA ops) on the card, against the
    # host Gustavson golden within 1e-12 (|A|.|A|) per entry
    from spmv_acc_tpu_torch.ops.spgemm import spgemm_host, spgemm_numeric, spgemm_symbolic

    for name in ("af23560", "epb1", "dw4096"):
        host = gen.example_like(name)
        dcsr = host.to(dev)
        t0 = time.perf_counter()
        pattern, a_pos, b_pos, out_pos, c_nnz = spgemm_symbolic(dcsr, dcsr)
        t_sym = time.perf_counter() - t0
        numeric = lambda: spgemm_numeric(dcsr.values, dcsr.values, a_pos, b_pos,  # noqa: E731
                                         out_pos, c_nnz)
        c = port.spgemm(dcsr, dcsr)
        torch.cuda.synchronize()
        us = cuda_time_us(numeric)
        hrp, hci, hv, hshape = host.to_numpy()
        g_rp, g_ci, g_v, _ = spgemm_host(hrp, hci, hv, hshape, hrp, hci, hv, hshape)
        scale = spgemm_host(hrp, hci, np.abs(hv), hshape, hrp, hci, np.abs(hv), hshape)[2]
        c_rp, c_ci, c_v, _ = c.to_numpy()
        same_pattern = np.array_equal(c_rp, g_rp) and np.array_equal(c_ci, g_ci)
        gap = np.abs(c_v - g_v) if same_pattern else np.array([np.inf])
        within = bool((gap <= ROW_TOL * scale).all()) if same_pattern else False
        lib = "refused"
        try:
            mat = torch.sparse_csr_tensor(dcsr.row_ptr.long(), dcsr.col_idx.long(),
                                          dcsr.values, size=dcsr.shape, check_invariants=False)
            lib = f"{cuda_time_us(lambda: mat @ mat)!r} us"
        except RuntimeError as e:
            lib = f"refused ({e})"
        # where the numeric phase's time goes, and index_add_ (atomic, its sum
        # order varies from call to call; not used) on the same products
        prod = dcsr.values[a_pos] * dcsr.values[b_pos]
        lengths = torch.bincount(out_pos, minlength=c_nnz)
        parts = {
            "gather": cuda_time_us(lambda: dcsr.values[a_pos] * dcsr.values[b_pos]),
            "bincount": cuda_time_us(lambda: torch.bincount(out_pos, minlength=c_nnz)),
            "segment_reduce": cuda_time_us(
                lambda: torch.segment_reduce(prod, "sum", lengths=lengths)),
            "index_add_": cuda_time_us(
                lambda: prod.new_zeros(c_nnz).index_add_(0, out_pos, prod))}
        phase("spgemm", f"{name} numeric phase by step, us per call: " + ", ".join(
            f"{k} {t!r}" for k, t in parts.items()) + f"; card: {card}")
        phase("spgemm", f"{name} A@A: nnz {host.nnz} -> c_nnz {c_nnz} (host golden "
              f"{len(g_ci)}), {len(a_pos)} products; symbolic (host) {t_sym!r} s; numeric "
              f"(plain PyTorch gather + segment_reduce on the card) {us!r} us per call "
              f"(median of 3 after 10 warmups); max|card - golden| {float(gap.max())!r} within "
              f"{ROW_TOL}*(|A||A|): {within}; result on {c.values.device}, pattern on "
              f"{c.row_ptr.device}; PyTorch's CSR @ CSR (cuSPARSE, not used): {lib}; card: "
              f"{card}")
        if (c_nnz != len(g_ci) or not same_pattern or not within
                or c.values.device.type != dev.type or c.row_ptr.device.type != dev.type):
            fail(f"spgemm {name}: the card's product differs from the host golden")

    # 7i. the tools: csr-tool and suitesparse-dl on a small file (trace and
    # bandwidth_report ran in the solver phase)
    from spmv_acc_tpu_torch.cli import csr_tool, suitesparse_dl
    from spmv_acc_tpu_torch.io import load_matrix, write_mtx

    def run_tool(main_fn, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main_fn(argv)
        for ln in buf.getvalue().splitlines()[:6]:
            phase("tools", f"{argv[0]}: {ln}")
        if rc != 0:
            fail(f"{argv[0]} returned {rc}")
        return buf.getvalue()

    with tempfile.TemporaryDirectory() as td:
        hrp, hci, hv, hshape = af.to_numpy()
        mtx = os.path.join(td, "af23560.mtx")
        write_mtx(mtx, np.repeat(np.arange(hshape[0]), np.diff(hrp)), hci, hv, hshape)
        b2 = os.path.join(td, "af23560.bin2")
        run_tool(suitesparse_dl.main, ["conv", mtx, "-o", b2])
        got = load_matrix(b2)
        conv_ok = all(np.array_equal(a_, b_) for a_, b_ in zip(got[:3], (hrp, hci, hv)))
        nnz_text = run_tool(csr_tool.main, ["nnz", "-i", b2, "-p", "4"])
        dist_text = run_tool(csr_tool.main, ["dist", "-i", b2])
        list_text = run_tool(suitesparse_dl.main, ["list", td])
        gen_text = run_tool(suitesparse_dl.main, ["gen", td, "-o", os.path.join(td, "batch")])
        ok = (conv_ok and nnz_text.startswith(f"matrix: rows={hshape[0]} cols={hshape[1]} "
                                              f"nnz={len(hv)}")
              and dist_text.splitlines()[1] == "row_length,count"
              and "af23560.bin2" in list_text and gen_text.startswith("generated 2 scripts"))
        phase("tools", f"conv mtx -> bin2 array for array: {conv_ok}; csr-tool nnz/dist, list, "
              f"gen: {ok}")
        if not ok:
            fail("the tools' output is wrong")

    # 7j. the multi-device layer on the card (dist_phase): the dry run, the
    # D = 4 structural baseline, the all-gather and halo paths and the swell
    # CG at D = 1
    t0 = time.perf_counter()
    dist_phase(dev, card, os.path.join(plan_dir, "dist_rendezvous"), records, loop_us,
               cuda_time_us, library, bound_of)
    phase("dist", f"phase took {time.perf_counter() - t0:.1f}s")

    # 8. times: each kernel against its plain version at the main paths' shapes,
    # per call (reference protocol, in turns plain, kernel, kernel, plain) and
    # per launch in a loop of 20, beside its bound and PyTorch's CSR product
    def timed(label, name, csr, layout, X, record=None, nbytes=None):
        dX = X if isinstance(X, torch.Tensor) else torch.from_numpy(X).to(dev)
        one = dX.dim() == 1
        kern = (lambda: swell.swell_ax(layout, dX)) if one else (lambda: swell.swell_amx(layout, dX))
        plain = ((lambda: swell.swell_ax_plain(layout, dX)) if one
                 else (lambda: swell.swell_amx_plain(layout, dX)))
        a, p = kern(), plain()
        torch.cuda.synchronize()
        max_abs = compare(f"{name} ({label})", csr, dX.cpu().numpy(), a, p)
        t_p1, t_k1, t_k2, t_p2 = (cuda_time_us(plain), cuda_time_us(kern),
                                  cuda_time_us(kern), cuda_time_us(plain))
        l_k, l_p = loop_us(kern), loop_us(plain, 5)
        us_k, us_p = (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2
        extra = ""
        if nbytes:
            gbs = nbytes / (l_k * 1e-6) / 1e9
            roof = f"{gbs / peak_gbs!r}" if peak_gbs else "not measured"
            extra = (f"; by the loop time {gbs!r} GB/s under 8(2m+nnz)+4(m+1+nnz) = "
                     f"{nbytes} B, roofline share {roof}")
        phase("times", f"{name} {label}: kernel {t_k1!r} / {t_k2!r} us, plain {t_p1!r} / "
              f"{t_p2!r} us per call (median of 3 after 10 warmups, CUDA events); loop of "
              f"20: kernel {l_k!r} us, plain {l_p!r} us per launch; r={layout.r} slots="
              f"{layout.slots}{extra}; card: {card}")
        if record:
            records[record].update(max_abs_err=max_abs, ms=us_k / 1e3, plain_ms=us_p / 1e3)
        k = 1 if one else int(dX.shape[1])
        finish(record, f"{name} {label}", spmv_bytes(csr, k), 2 * csr.nnz * k, FP64_TFLOPS,
               library(csr, dX), tensor_bytes(
                   layout.vals, layout.lidx, layout.slab_off, layout.slab_log2d,
                   layout.slab_col_base, layout.rb_slab_ptr, dX, a))
        return l_k

    ref_bytes = lambda c: 8 * (2 * c.rows + c.nnz) + 4 * (c.rows + 1 + c.nnz)  # noqa: E731
    bx = gen.random_x_y(n, m, seed=42)[0]
    t_bone = timed("f64 r=1 k=1", "boneS10", bone_dev, swell.get_swell_plan(bone_dev), bx,
                   "swell_spmv_f64", ref_bytes(bone))
    timed("f64 r=1 k=1", "af23560", af_dev, swell.get_swell_plan(af_dev),
          gen.random_x_y(an, am, seed=42)[0], nbytes=ref_bytes(af))
    timed("f32 r=1 k=1", "boneS10", bone32, swell.get_swell_plan(bone32), x32, "swell_spmv_f32")
    t_on = timed("f64 BSR-on r=4 k=1", "TSOPF_RS_b2383", tsopf_dev, tlay, tx,
                 "swell_bsr_r4_f64", ref_bytes(tsopf))
    t_off = timed("f64 BSR-off r=1 k=1", "TSOPF_RS_b2383", tsopf_dev,
                  swell.get_swell_plan(tsopf_dev, r=1), tx, nbytes=ref_bytes(tsopf))
    phase("times", f"TSOPF_RS_b2383 BSR-on / BSR-off kernel loop time: {t_on / t_off!r}")
    for name, dcsr, t1 in (("boneS10", bone_dev, t_bone), ("TSOPF_RS_b2383", tsopf_dev, t_on)):
        t8 = timed(f"f64 SpMM k={K}", name, dcsr, swell.get_swell_plan(dcsr), spmm_X[name],
                   "swell_spmm_k8_f64" if name == "boneS10" else None)
        run = swell.make_swell_amx_run(dcsr, K)
        run1 = swell.make_swell_run(dcsr)
        dX, dx1 = spmm_X[name], spmm_X[name][:, 0].contiguous()
        dy1 = torch.zeros_like(dx1)
        it_amx = loop_us(lambda: run(dX, 10), 2) / 10
        it_mv = loop_us(lambda: run1(dx1, dy1, 10), 2) / 10
        phase("times", f"{name} chained iteration: make_swell_amx_run k={K} {it_amx!r} us, "
              f"make_swell_run (k=1) {it_mv!r} us, 8 x SpMV {8 * it_mv!r} us; SpMM kernel "
              f"k={K} {t8!r} us per launch against 8 x the SpMV kernel {8 * t1!r} us")

    # 8b. the tile and ELL kernels against their plain versions on boneS10
    def timed_pair(name, label, kern, plain, csr, x_np, record=None, nbytes=None, inputs=(),
                   layout_bytes=None):
        a, p = kern(), plain()
        torch.cuda.synchronize()
        m_ = csr.rows
        max_abs = compare(f"{name} ({label})", csr, x_np, a[:m_], p[:m_], "times")
        t_p1, t_k1, t_k2, t_p2 = (cuda_time_us(plain), cuda_time_us(kern),
                                  cuda_time_us(kern), cuda_time_us(plain))
        l_k, l_p = loop_us(kern), loop_us(plain, 5)
        us_k, us_p = (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2
        roof = ""
        if nbytes:
            gbs = nbytes / (l_k * 1e-6) / 1e9
            roof = (f"; by the loop time {gbs!r} GB/s under the reference model "
                    f"T(2m+nnz)+4(m+1+nnz) = {nbytes} B, roofline share {gbs / peak_gbs!r} of "
                    f"{peak_gbs!r} GB/s")
        phase("times", f"{name} {label}: kernel {t_k1!r} / {t_k2!r} us, plain {t_p1!r} / "
              f"{t_p2!r} us per call (median of 3 after 10 warmups, CUDA events); loop of 20: "
              f"kernel {l_k!r} us, plain {l_p!r} us per launch{roof}; card: {card}")
        if record:
            records[record].update(max_abs_err=max_abs, ms=us_k / 1e3, plain_ms=us_p / 1e3)
        finish(record, f"{name} {label}", spmv_bytes(csr), 2 * csr.nnz, FP64_TFLOPS,
               library(csr, inputs[-1]),
               tensor_bytes(*inputs, a) if layout_bytes is None else layout_bytes)
        return l_k

    def ell_read_bytes(ell):
        """The bytes the ELL kernel moves: each row's stored values and columns
        in whole 32-B sectors, row_len, x read once and y written once."""
        t = ell.values.element_size()
        lens = ell.row_len.long()
        start = torch.arange(ell.padded_rows, device=lens.device) * ell.width

        def sectors(item):
            first, end = start * item // 32, ((start + lens) * item + 31) // 32
            return int(torch.where(lens > 0, end - first, 0).sum()) * 32

        return sectors(t) + sectors(4) + 4 * ell.padded_rows + (ell.shape[1] + ell.padded_rows) * t

    def timed_ell(name, dcsr, xb, record=None):
        """The ELL kernel on the slab that spmv(strategy="vector_row") caches."""
        ell = port.dispatch._get_ell(dcsr, port.DEFAULT_TUNE)
        dxb = torch.from_numpy(xb).to(dev)
        dk = _dk(dcsr.dtype)
        kern = lambda: vr.ell_rowsum(ell, dxb)  # noqa: E731
        read = ell_read_bytes(ell)
        timed_pair(name, f"ell_rowsum {dk} vs={ell_vs(ell)}", kern,
                   lambda: vr.ell_rowsum_plain(ell, dxb), dcsr, xb, record,
                   bytes_moved(dcsr.rows, dcsr.nnz, dcsr.values.element_size()),
                   (ell.values, ell.col_idx, ell.row_len, dxb), read)
        whole = tensor_bytes(ell.values, ell.col_idx, dxb, dxb)
        phase("times", f"{name} ell_rowsum {dk}: {ell.padded_rows} x {ell.width} slab, "
              f"{dcsr.nnz} stored cells; device time (torch.profiler) "
              f"{device_us(kern, 'ell_kernel')!r} us a launch; the whole slab with x and y "
              f"(what a walk to the width reads) {whole} B, this kernel {read} B; card: {card}")

    for dtype, dcsr, xb in ((np.float64, bone_dev, bx), (np.float32, bone32, x32)):
        dk = "f64" if dtype == np.float64 else "f32"
        dxb = torch.from_numpy(xb).to(dev)
        dp = ap.get_tile_plan(dcsr)
        nb = bytes_moved(bone.rows, bone.nnz, np.dtype(dtype).itemsize)
        tile_in = (dp.vals, dp.lidx, dp.blk_off, dp.blk_depth, dp.blk_ct, dp.rb_ptr, dxb)
        timed_pair("boneS10", f"tile_spmv {dk}", lambda: ap.tile_spmv(dp, dxb),
                   lambda: ap.tile_spmv_plain(dp, dxb), dcsr, xb, f"tile_spmv_{dk}", nb,
                   tile_in)
        timed_ell("boneS10", dcsr, xb, f"ell_rowsum_{dk}")
    # Ga41As41H72 is the unsymmetrised example_like matrix (the solver's
    # SPD-ized one is gone by now)
    ga_dev = ga.to(dev)
    gx = gen.random_x_y(ga.cols, ga.rows, seed=42)[0]
    timed_ell("TSOPF_RS_b2383", tsopf_dev, tx)
    timed_ell("Ga41As41H72", ga_dev, gx)
    dtx = torch.from_numpy(tx).to(dev)
    t_tile = timed_pair("TSOPF_RS_b2383", "tile_spmv f64", lambda: ap.tile_spmv(tdp, dtx),
                        lambda: ap.tile_spmv_plain(tdp, dtx), tsopf_dev, tx,
                        nbytes=ref_bytes(tsopf), inputs=(
                            tdp.vals, tdp.lidx, tdp.blk_off, tdp.blk_depth, tdp.blk_ct,
                            tdp.rb_ptr, dtx))
    phase("times", f"TSOPF_RS_b2383 tile kernel {t_tile!r} us against the swell r=4 kernel "
          f"{t_on!r} us and r=1 {t_off!r} us per launch (loops of 20)")

    # 8b'. the fix-up pass's own device time, and the sweep that sets the chunk caps
    tlay1 = swell.get_swell_plan(tsopf_dev, r=1)
    fix = []
    for label, lay, fn, name in (
            ("swell r=1", tlay1, lambda: swell.swell_ax(tlay1, dtx), "swell_kernel"),
            ("swell r=4", tlay, lambda: swell.swell_ax(tlay, dtx), "swell_kernel"),
            ("tile", tdp, lambda: ap.tile_spmv(tdp, dtx), "tile_kernel")):
        fix.append(f"{label} {sched_text(lay.schedule)}: chunk kernel "
                   f"{device_us(fn, name)!r} us, fix-up {device_us(fn, 'fixup_kernel')!r} us")
    phase("times", f"TSOPF_RS_b2383 device time a launch (torch.profiler): {'; '.join(fix)}; "
          f"card: {card}")
    bone_x = torch.from_numpy(bx).to(dev)
    for label, dcsr, X in (("TSOPF_RS_b2383 swell f64 r=1 k=1", tsopf_dev, dtx),
                           ("boneS10 swell f64 r=1 k=1", bone_dev, bone_x),
                           ("boneS10 swell f32 r=1 k=1", bone32, torch.from_numpy(x32).to(dev)),
                           (f"TSOPF_RS_b2383 swell f64 k={K}", tsopf_dev, spmm_X["TSOPF_RS_b2383"]),
                           (f"boneS10 swell f64 k={K}", bone_dev, spmm_X["boneS10"])):
        lay = swell.get_swell_plan(dcsr, r=1) if "r=1" in label else swell.get_swell_plan(dcsr)
        run = ((lambda p, X=X: swell.swell_ax(p, X)) if X.dim() == 1
               else (lambda p, X=X: swell.swell_amx(p, X)))
        sweep(f"{label} (r={lay.r})", lambda c, lay=lay: swell.rescheduled(lay, c), run,
              SWELL_SWEEP)
    # the ELL kernel's lanes a row (vector_size), every vs also held against
    # the plain version, two launches bit for bit equal
    for label, dcsr, xb in (("boneS10 f64", bone_dev, bx), ("boneS10 f32", bone32, x32),
                            ("Ga41As41H72 f64", ga_dev, gx), ("TSOPF_RS_b2383 f64", tsopf_dev, tx),
                            ("af23560 f64", af_dev, ax64)):
        ell = port.dispatch._get_ell(dcsr, port.DEFAULT_TUNE)
        dx = torch.from_numpy(xb).to(dev)
        p = vr.ell_rowsum_plain(ell, dx).double()
        bound = (ell.values.double().abs() * dx.double().abs()[ell.col_idx.long()]).sum(1)
        allowed = ROW_TOL * bound + (F32_ULP * p.abs() if dcsr.dtype == torch.float32 else 0.0)
        for vs in ELL_SWEEP:
            a = twice(f"{label} ell vs={vs}", lambda: vr._launch(ell, dx, vs))
            if not bool(((a.double() - p).abs() <= allowed).all()):
                fail(f"{label} ell vs={vs}: the kernel disagrees with its plain version")
        up = {vs: loop_us(lambda: vr._launch(ell, dx, vs)) for vs in ELL_SWEEP}
        down = {vs: loop_us(lambda: vr._launch(ell, dx, vs)) for vs in reversed(ELL_SWEEP)}
        phase("sweep", f"{label} ELL, width {ell.width}, shipped vs={ell_vs(ell)}: " + "; ".join(
            f"vs={vs}: {up[vs]!r} / {down[vs]!r} us" for vs in ELL_SWEEP) + "; every vs within "
            f"{ROW_TOL}*(|A||x|) of the plain version, two launches bit for bit equal; card: "
            f"{card}")
    # the detector's r is 4; r = 2, 3 check the rule SWELL_CHUNK_ROWS // r
    for r in (4, 3, 2):
        lay = swell.get_swell_plan(tsopf_dev, r=r)
        sweep(f"TSOPF_RS_b2383 swell f64 r={r} k=1", lambda c, lay=lay: swell.rescheduled(lay, c),
              lambda p: swell.swell_ax(p, dtx), (4,) + SWELL_SWEEP)
    for label, dp, X in (("TSOPF_RS_b2383 tile f64", tdp, dtx),
                         ("boneS10 tile f64", ap.get_tile_plan(bone_dev), bone_x)):
        sweep(label, lambda c, dp=dp: ap.rescheduled(dp, c),
              lambda p, X=X: ap.tile_spmv(p, X), TILE_SWEEP)

    # 8c. the plane split and the plane-form swell: on the solver's aniso
    # system (their main path, recorded) and on boneS10, against the direct kernel
    def time_planes(name, csr, layout, dx, record=False):
        sets = 2 if csr.dtype == torch.float64 else 1
        dk = _dk(csr.dtype)
        split, split_plain = (lambda: swell.prep_x(layout, dx)), (lambda: swell.prep_x_plain(
            layout, dx))
        a, p = split(), split_plain()
        torch.cuda.synchronize()
        if not torch.equal(a.view(torch.int16), p.view(torch.int16)):
            fail(f"{name}: the plane-split kernel differs from prep_x_plain")
        t_p1, t_k1, t_k2, t_p2 = (cuda_time_us(split_plain), cuda_time_us(split),
                                  cuda_time_us(split), cuda_time_us(split_plain))
        l_k, l_p = loop_us(split), loop_us(split_plain, 5)
        phase("times", f"{name} plane_split {dk}: kernel {t_k1!r} / {t_k2!r} us, plain "
              f"{t_p1!r} / {t_p2!r} us per call; loop of 20: kernel {l_k!r} us, plain {l_p!r} "
              f"us per launch; device time (torch.profiler) "
              f"{device_us(split, 'plane_split_kernel')!r} us a launch, L2-cold "
              f"{device_us(split, 'plane_split_kernel', cold=True)!r} us; "
              f"n_pad={layout.nchunks * 16384}; card: {card}")
        rec = f"plane_split_{dk}" if record else None
        if rec:
            records[rec].update(max_abs_err=0.0, ms=(t_k1 + t_k2) / 2e3, plain_ms=(t_p1 + t_p2) / 2e3)
        finish(rec, f"{name} plane_split {dk}", tensor_bytes(dx, a),
               16 * sets * layout.nchunks * 16384, F32_TFLOPS, (None, None))
        planes = a
        kern = lambda: swell.swell_ax_planes(layout, planes)  # noqa: E731
        plain = lambda: swell.swell_ax_planes_plain(layout, planes)  # noqa: E731
        direct = lambda: swell.swell_ax(layout, dx)  # noqa: E731
        xt = swell._planes_x(layout, planes, torch.arange(csr.cols, device=dev))
        ka, pa = kern(), plain()
        torch.cuda.synchronize()
        max_abs = compare(f"{name} (swell_ax_planes {dk})", csr, xt.cpu().numpy(), ka, pa,
                          "times")
        t_p1, t_k1, t_d, t_k2, t_p2 = (cuda_time_us(plain), cuda_time_us(kern),
                                       cuda_time_us(direct), cuda_time_us(kern),
                                       cuda_time_us(plain))
        l_k, l_d, l_p = loop_us(kern), loop_us(direct), loop_us(plain, 5)
        phase("times", f"{name} swell_ax_planes {dk}: kernel {t_k1!r} / {t_k2!r} us, direct "
              f"kernel {t_d!r} us, plain {t_p1!r} / {t_p2!r} us per call; loop of 20: kernel "
              f"{l_k!r} us, direct kernel {l_d!r} us, plain {l_p!r} us per launch "
              f"(plane form / direct {l_k / l_d!r}); device time (torch.profiler) plane form "
              f"{device_us(kern, 'swell_kernel')!r} us, direct {device_us(direct, 'swell_kernel')!r}"
              f" us a launch, L2-cold plane form {device_us(kern, 'swell_kernel', cold=True)!r}"
              f" us; card: {card}")
        rec = f"swell_planes_{dk}" if record else None
        if rec:
            records[rec].update(max_abs_err=max_abs, ms=(t_k1 + t_k2) / 2e3,
                                plain_ms=(t_p1 + t_p2) / 2e3)
        finish(rec, f"{name} swell_ax_planes {dk}",
               spmv_bytes(csr, x_bytes=tensor_bytes(planes)), 2 * csr.nnz, FP64_TFLOPS,
               library(csr, xt.to(csr.dtype)), tensor_bytes(
                   layout.vals, layout.lidx, layout.slab_off, layout.slab_log2d,
                   layout.slab_col_base, layout.rb_slab_ptr, planes, ka))

    time_planes(f"aniso {nx}^2", acsr, alay, ab, record=True)
    time_planes("boneS10", bone_dev, swell.get_swell_plan(bone_dev),
                torch.from_numpy(bx).to(dev))

    # 8d. the bench phase's large shapes: the swell kernel over the layouts the
    # bench saved (loaded from the plan cache) on the corpus it cached
    for nm, record, r in BENCH_LARGE:
        host = gen.example_like(nm)
        dcsr = host.to(dev)
        lay = swell.get_swell_plan(dcsr)
        timed(f"f64 r={lay.r} k=1 fill={lay.fill:.3f} (bench shape)", nm, dcsr, lay,
              gen.random_x_y(host.cols, host.rows, seed=42)[0], record, ref_bytes(host))
        del host, dcsr, lay
        swell.clear_swell_cache()

    # 9. records
    keys = {"launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    kernels = []
    for name, replaces in (("swell_spmv_f64", "spmv_acc_tpu/ops/swell.py:455"),
                           ("swell_spmv_f32", "spmv_acc_tpu/ops/swell.py:334"),
                           ("swell_bsr_r4_f64", "spmv_acc_tpu/ops/swell.py:455"),
                           ("swell_spmm_k8_f64", "spmv_acc_tpu/ops/swell.py:455"),
                           ("swell_solver_f64", "spmv_acc_tpu/ops/swell.py:455"),
                           ("swell_dist_f64", "spmv_acc_tpu/ops/swell.py:455"),
                           ("swell_rect_f64", "spmv_acc_tpu/ops/swell.py:455"),
                           ("swell_bsr_r3_f64", "spmv_acc_tpu/ops/swell.py:455"),
                           ("swell_lowfill_f64", "spmv_acc_tpu/ops/swell.py:455"),
                           ("swell_entry_f32", "spmv_acc_tpu/ops/swell.py:334")):
        rec = records[name]
        if set(rec) != keys or rec["launches"] < 1:
            fail(f"{name} was not launched on the main path or not timed")
        if name == "swell_dist_f64" and rec["launches"] < 4:
            fail("the D = 4 distributed path launched the swell kernel fewer than 4 times")
        kernels.append({"name": name, "route": "cuda",
                        "source": "spmv_acc_tpu_torch/csrc/swell_spmv.cu",
                        "replaces": replaces, **rec})
    for name, source, replaces in (
            ("tile_spmv_f64", "tile_spmv.cu", "spmv_acc_tpu/ops/adaptive_plus.py:113"),
            ("tile_spmv_f32", "tile_spmv.cu", "spmv_acc_tpu/ops/adaptive_plus.py:88"),
            ("ell_rowsum_f64", "ell_rowsum.cu", "spmv_acc_tpu/ops/vector_row.py:83"),
            ("ell_rowsum_f32", "ell_rowsum.cu", "spmv_acc_tpu/ops/vector_row.py:36"),
            ("plane_split_f64", "plane_split.cu", "spmv_acc_tpu/ops/swell.py:2197"),
            ("swell_planes_f64", "swell_spmv.cu", "spmv_acc_tpu/ops/swell.py:455"),
            # F-1 replaces no pallas_call: XLA's fusion of _swell_power_run's body
            ("feedback_f64", "feedback.cu", "spmv_acc_tpu/ops/swell.py:2681"),
            # F-2 neither: XLA's fusions of _cg_loop's body; the fused form on one
            # device, the three phases where a distributed solve all-reduces
            ("cg_update_f64", "cg_update.cu", "spmv_acc_tpu/models/cg.py:74"),
            ("cg_phases_f64", "cg_update.cu", "spmv_acc_tpu/models/cg.py:74"),
            # F-3 neither: XLA's loops of the triangular solves (trisolve's
            # fori_loop; trisolve_sweeps' fori_loop)
            ("trisolve_f64", "trisolve.cu", "spmv_acc_tpu/ops/trisolve.py:224"),
            ("tri_sweeps_f64", "trisolve.cu", "spmv_acc_tpu/ops/trisolve.py:263")):
        rec = records[name]
        if set(rec) != keys or rec["launches"] < 1:
            fail(f"{name} was not launched on the main path or not timed")
        kernels.append({"name": name, "route": "cuda",
                        "source": f"spmv_acc_tpu_torch/csrc/{source}",
                        "replaces": replaces, **rec})
    files, nbytes = dir_bytes(plan_dir)
    phase("plan-cache", f"this run wrote {files} entries, {nbytes} B, to the disk plan cache "
          f"(deleted at the end of the run)")
    phase("done", f"{time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
