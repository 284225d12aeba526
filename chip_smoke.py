#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spmv_acc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repo root on a machine with a Hopper card, ``nvcc`` and a C++
compiler.  It builds the three kernels of ``spmv_acc_tpu_torch/csrc`` (swell,
tile, ELL row sum; one nvcc each, all at once), holds every variant the port
launches against its plain PyTorch version (swell at float64 and float32, BSR
r = 1..4, k = 1, 3, 8 columns; the tile and ELL kernels at both dtypes on every
smoke matrix), and drives the port's main paths at full size:
``spmv(strategy="adaptive")`` on boneS10 (scalar plan, float64 and float32)
and on TSOPF_RS_b2383 (the detector's r = 4 BSR plan), ``spmm`` and
``make_swell_amx_run`` with k = 8 on both, ``spmv-cli`` in float64 and float32,
``spmv(strategy="adaptive_plus")`` and ``spmv(strategy="vector_row")`` on
boneS10 in both dtypes and adaptive_plus on TSOPF_RS_b2383, every strategy on
af23560, and ``spmv-benchmark`` on af23560 (all engines) and boneS10.  It then
times each kernel against its plain version.  Every phase prints lines tagged
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
        m = re.search(r"(swell|tile|ell)_kernelI([df])((?:Li\d+E)*)E", ln)
        if m and "Compiling entry function" in ln:
            params = " ".join(re.findall(r"Li(\d+)E", m.group(3)))
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


def launches_of(swell, dtype=None, r=None, k=None) -> int:
    return sum(n for (d, rr, kk), n in swell.LAUNCHES.items()
               if (dtype is None or d == dtype) and (r is None or rr == r)
               and (k is None or kk == k))


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

    # 3b. the tile and ELL row-sum kernels against their plain versions
    from spmv_acc_tpu_torch.formats.convert import csr_to_ell
    from spmv_acc_tpu_torch.ops import adaptive_plus as ap
    from spmv_acc_tpu_torch.ops import vector_row as vr

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
            a, p = vr.ell_rowsum(ell, dx)[:m], vr.ell_rowsum_plain(ell, dx)[:m]
            torch.cuda.synchronize()
            compare(f"ell {name} {np.dtype(dtype).name} vs={vr.vector_size(ell.width)}", csr, x,
                    a, p, "zoo-vs-plain")
    phase("zoo-vs-plain", f"launches so far: tile {dict(ap.LAUNCHES)}, ELL {dict(vr.LAUNCHES)}")
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
          f"analyze={h.analyze_time_us:.0f}us kernel={h.kernel_time_us:.0f}us "
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
          f"analyze={h.analyze_time_us:.0f}us node slots={tlay.slots} fill={tlay.fill!r} "
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
          f"{launches} analyze={h.analyze_time_us:.0f}us max_error {rep.max_error!r} verify {rep}")
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
              f"{secs:.2f}s (analyze {h.analyze_time_us:.0f}us, layout and kernel "
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
          f"{port.dispatch._ELL_MAX_CELLS}), vs={vr.vector_size(bone_ell.width)}")
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

    # 8. times: each kernel against its plain version at the main paths' shapes,
    # per call (reference protocol, in turns plain, kernel, kernel, plain) and
    # per launch in a loop of 20
    def loop_us(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) * 1e3 / n

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
    def timed_pair(name, label, kern, plain, csr, x_np, record=None, nbytes=None):
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
        return l_k

    for dtype, dcsr, xb in ((np.float64, bone_dev, bx), (np.float32, bone32, x32)):
        dk = "f64" if dtype == np.float64 else "f32"
        dxb = torch.from_numpy(xb).to(dev)
        dp = ap.get_tile_plan(dcsr)
        nb = bytes_moved(bone.rows, bone.nnz, np.dtype(dtype).itemsize)
        timed_pair("boneS10", f"tile_spmv {dk}", lambda: ap.tile_spmv(dp, dxb),
                   lambda: ap.tile_spmv_plain(dp, dxb), dcsr, xb, f"tile_spmv_{dk}", nb)
        ell = port.dispatch._get_ell(dcsr, port.DEFAULT_TUNE)
        timed_pair("boneS10", f"ell_rowsum {dk} vs={vr.vector_size(ell.width)}",
                   lambda: vr.ell_rowsum(ell, dxb), lambda: vr.ell_rowsum_plain(ell, dxb),
                   dcsr, xb, f"ell_rowsum_{dk}", nb)
    dtx = torch.from_numpy(tx).to(dev)
    t_tile = timed_pair("TSOPF_RS_b2383", "tile_spmv f64", lambda: ap.tile_spmv(tdp, dtx),
                        lambda: ap.tile_spmv_plain(tdp, dtx), tsopf_dev, tx,
                        nbytes=ref_bytes(tsopf))
    phase("times", f"TSOPF_RS_b2383 tile kernel {t_tile!r} us against the swell r=4 kernel "
          f"{t_on!r} us and r=1 {t_off!r} us per launch (loops of 20)")

    # 9. records
    kernels = []
    for name, replaces in (("swell_spmv_f64", "spmv_acc_tpu/ops/swell.py:455"),
                           ("swell_spmv_f32", "spmv_acc_tpu/ops/swell.py:334"),
                           ("swell_bsr_r4_f64", "spmv_acc_tpu/ops/swell.py:455"),
                           ("swell_spmm_k8_f64", "spmv_acc_tpu/ops/swell.py:455")):
        rec = records[name]
        if not {"ms", "plain_ms", "max_abs_err"} <= set(rec):
            fail(f"{name} was not timed")
        kernels.append({"name": name, "route": "cuda",
                        "source": "spmv_acc_tpu_torch/csrc/swell_spmv.cu",
                        "replaces": replaces, **rec})
    for name, source, replaces in (
            ("tile_spmv_f64", "tile_spmv.cu", "spmv_acc_tpu/ops/adaptive_plus.py:113"),
            ("tile_spmv_f32", "tile_spmv.cu", "spmv_acc_tpu/ops/adaptive_plus.py:88"),
            ("ell_rowsum_f64", "ell_rowsum.cu", "spmv_acc_tpu/ops/vector_row.py:83"),
            ("ell_rowsum_f32", "ell_rowsum.cu", "spmv_acc_tpu/ops/vector_row.py:36")):
        rec = records[name]
        if not {"ms", "plain_ms", "max_abs_err"} <= set(rec) or rec["launches"] < 1:
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
