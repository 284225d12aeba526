#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spmv_acc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repo root on a machine with a Hopper card, ``nvcc`` and a C++
compiler.  It builds the four kernel sources of ``spmv_acc_tpu_torch/csrc``
(swell with its plane form, tile, ELL row sum, plane split; one nvcc each, all
at once), holds every variant the port launches against its plain PyTorch
version (swell at float64 and float32, BSR r = 1..4, k = 1, 3, 8 columns; the
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
kernel as its matvec, and ``spmv-solve`` on af23560.  It then times each
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

import json
import os
import re
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


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


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
        m = re.search(r"(swell|tile|ell|plane_split|fixup)_kernelI([df])((?:L[ib]\d+E)*)E", ln)
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


def spmv_bytes(csr, k=1, x_bytes=None) -> int:
    """The bytes that A @ X must move, whatever layout computes it: the CSR's
    values and column indices (4 B each), row_ptr at 4 B a row, X read once (or
    ``x_bytes``) and Y written once."""
    t = csr.values.element_size()
    x_bytes = csr.cols * k * t if x_bytes is None else x_bytes
    return csr.nnz * (t + 4) + 4 * (csr.rows + 1) + x_bytes + csr.rows * k * t


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
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

    # 7f. the solver path at full size: the JAX package's two solver workloads
    # (bench.py bench_solver, bench_solver_aniso)
    from spmv_acc_tpu_torch.cli.solve import spdize
    from spmv_acc_tpu_torch.models.cg import _cg_loop, cg_solve, jacobi_preconditioner
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
    for label, pre in (("jacobi", jacobi_preconditioner(gcsr)), ("ilu", gfact)):
        swell.LAUNCHES.clear()
        t0 = time.perf_counter()
        res = cg_solve(gcsr, dgb, tol=1e-8, max_iters=300, strategy="swell", precond=pre)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = g_launches[label] = launches_of(swell, "f64")
        solved(f"Ga41As41H72-SPD cg[{label}] ({secs!r} s; swell launches "
               f"{dict(swell.LAUNCHES)})", res, x_true, gb_norm, 1e-8, 300, gate=1e-6)
        if launches < res.iters:
            fail(f"Ga41As41H72-SPD cg[{label}] launched the swell kernel {launches} times "
                 f"in {res.iters} iterations")
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
    aiters = {}
    for label, pre in (("jacobi", ajac), ("ilu", afact)):
        swell.LAUNCHES.clear()
        t0 = time.perf_counter()
        res = cg_solve(acsr, ab, tol=1e-8, max_iters=4000, strategy="swell", precond=pre)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        solved(f"aniso cg[{label}] ({secs!r} s, {secs / max(res.iters, 1) * 1e6!r} us per "
               f"iteration with one host read each; swell launches {dict(swell.LAUNCHES)})",
               res, ax_true, ab_norm, 1e-8, 4000)
        if launches_of(swell, "f64") < res.iters:
            fail(f"aniso cg[{label}] launched the swell kernel fewer times than it iterated")
        aiters[label] = res.iters

    def aniso_matvec(v):
        return swell.swell_ax(alay, v)

    def fixed_trip(M, n):
        """n CG iterations with no host read (bench.py:470-506)."""
        x_ = torch.zeros_like(ab)
        r_ = ab - aniso_matvec(x_)
        z_ = M(r_)
        p_, rz = z_, torch.dot(r_, z_)
        for _ in range(n):
            ap_ = aniso_matvec(p_)
            alpha = rz / torch.dot(p_, ap_)
            x_ = x_ + alpha * p_
            r_ = r_ - alpha * ap_
            z_ = M(r_)
            rzn = torch.dot(r_, z_)
            p_ = z_ + (rzn / rz) * p_
            rz = rzn
        return torch.dot(r_, r_)

    def per_iter_us(M):
        def once(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(fixed_trip(M, k))
            return time.perf_counter() - t0

        once(65)
        once(513)
        w1 = min(once(65) for _ in range(3))
        w2 = min(once(513) for _ in range(3))
        return max(w2 - w1, 0.0) / (513 - 65) * 1e6

    per_j, per_i = per_iter_us(ajac), per_iter_us(afact.solve)
    win = (aiters["jacobi"] * per_j) / (aiters["ilu"] * per_i)
    exact = tri.ILU0(afact.l_plan, afact.u_plan, sweeps=0)
    ms_exact = loop_us(lambda: exact.solve(ab), 2) / 1e3
    phase("solver", f"aniso per iteration (fixed-trip loops of 65 and 513, host clock): "
          f"jacobi {per_j!r} us, ilu(3 sweeps) {per_i!r} us; total_wall_win {win!r}; exact "
          f"chunk-scheduled ILU apply ({afact.l_plan.num_iters} + {afact.u_plan.num_iters} "
          f"iterations) {ms_exact!r} ms; card: {card}")

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

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "af23560.bin2")
        write_bin2(path, *af.to_numpy())
        for pre in ("jacobi", "ilu0"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = solve_main([path, "-f", "bin2", "--precond", pre])
            for ln in buf.getvalue().splitlines():
                phase("solve-cli", ln)
            if rc != 0 or "Congratulation, solution verified!" not in buf.getvalue():
                fail(f"spmv-solve --precond {pre} returned {rc}")

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

    # 9. records
    keys = {"launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    kernels = []
    for name, replaces in (("swell_spmv_f64", "spmv_acc_tpu/ops/swell.py:455"),
                           ("swell_spmv_f32", "spmv_acc_tpu/ops/swell.py:334"),
                           ("swell_bsr_r4_f64", "spmv_acc_tpu/ops/swell.py:455"),
                           ("swell_spmm_k8_f64", "spmv_acc_tpu/ops/swell.py:455"),
                           ("swell_solver_f64", "spmv_acc_tpu/ops/swell.py:455")):
        rec = records[name]
        if set(rec) != keys:
            fail(f"{name} was not timed")
        kernels.append({"name": name, "route": "cuda",
                        "source": "spmv_acc_tpu_torch/csrc/swell_spmv.cu",
                        "replaces": replaces, **rec})
    for name, source, replaces in (
            ("tile_spmv_f64", "tile_spmv.cu", "spmv_acc_tpu/ops/adaptive_plus.py:113"),
            ("tile_spmv_f32", "tile_spmv.cu", "spmv_acc_tpu/ops/adaptive_plus.py:88"),
            ("ell_rowsum_f64", "ell_rowsum.cu", "spmv_acc_tpu/ops/vector_row.py:83"),
            ("ell_rowsum_f32", "ell_rowsum.cu", "spmv_acc_tpu/ops/vector_row.py:36"),
            ("plane_split_f64", "plane_split.cu", "spmv_acc_tpu/ops/swell.py:2197"),
            ("swell_planes_f64", "swell_spmv.cu", "spmv_acc_tpu/ops/swell.py:455")):
        rec = records[name]
        if set(rec) != keys or rec["launches"] < 1:
            fail(f"{name} was not launched on the main path or not timed")
        kernels.append({"name": name, "route": "cuda",
                        "source": f"spmv_acc_tpu_torch/csrc/{source}",
                        "replaces": replaces, **rec})
    phase("done", f"{time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
