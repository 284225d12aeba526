#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spmv_acc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repo root on a machine with a Hopper card, ``nvcc`` and a C++
compiler.  It builds the swell kernel (H1) from ``spmv_acc_tpu_torch/csrc``,
holds it against its plain PyTorch version, drives the port's main path —
``spmv(strategy="adaptive")`` -> swell plan -> H1 — at boneS10's full size, runs
the CLI, and times H1 against the plain version.  Every phase prints one line;
the first failure exits non-zero.  Without a CUDA device it fails at once.  The
last two lines are the kernels' JSON record and the device JSON record.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# row-wise bound on |H1 - plain| and |port - reference|: FP64 summation order
# differs, so the gap is a few ulps of (|A|·|x|)[row]; 1e-12 leaves orders of margin
ROW_TOL = 1e-12


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


def row_bound(csr, x):
    """(|A|·|x|)[row], the scale of each row's rounding."""
    import numpy as np

    from spmv_acc_tpu_torch.ops.golden import host_spmv_plain

    rp, ci, v, _ = csr.to_numpy()
    return host_spmv_plain(rp, ci, np.abs(v), np.abs(x))


def compare(name, csr, x, a, p):
    """H1 output ``a`` against the plain version ``p`` and both against the golden."""
    import numpy as np

    from spmv_acc_tpu_torch.ops.golden import host_spmv_plain
    from spmv_acc_tpu_torch.utils import host_array, verify_y

    rp, ci, v, shape = csr.to_numpy()
    a, p = host_array(a), host_array(p)
    if a.shape != (shape[0],) or not np.isfinite(a).all():
        fail(f"{name}: H1 output has shape {a.shape} or non-finite values")
    gap = np.abs(a - p)
    worst = float((gap - ROW_TOL * row_bound(csr, x)).max()) if gap.size else -1.0
    golden = host_spmv_plain(rp, ci, v, x)
    ra, rpl = verify_y(a, golden), verify_y(p, golden)
    ok = worst <= 0.0 and ra.ok and rpl.ok
    max_abs = float(gap.max()) if gap.size else 0.0
    phase("h1-vs-plain", f"{name} {shape[0]}x{shape[1]} nnz={csr.nnz}: max|H1-plain|="
          f"{max_abs!r} within {ROW_TOL}*(|A||x|): {worst <= 0.0}; verify H1 {ra} "
          f"plain {rpl}")
    if not ok:
        fail(f"{name}: H1 disagrees with its plain version or the golden")
    return max_abs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    import spmv_acc_tpu_torch as port
    from spmv_acc_tpu_torch.formats import generate as gen
    from spmv_acc_tpu_torch.io import write_bin2
    from spmv_acc_tpu_torch.io.native import available as native_available
    from spmv_acc_tpu_torch.ops import _build
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.ops.golden import host_spmv
    from spmv_acc_tpu_torch.utils import cuda_time_us, verify_y

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

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
    props = torch.cuda.get_device_properties(0)
    clock_khz = getattr(props, "memory_clock_rate", 0)
    bus_bits = getattr(props, "memory_bus_width", 0)
    peak_gbs = 2 * clock_khz * 1e3 * bus_bits / 8 / 1e9 if clock_khz and bus_bits else None
    phase("env", f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {kind} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {card}; nvcc: {nvcc.stdout.strip().splitlines()[-1]}; "
          f"peak HBM from the card's clock x bus width: {peak_gbs!r} GB/s")

    # 2. build H1 from the checkout's sources (and the host analyze library)
    t0 = time.perf_counter()
    so = _build.build(_build.SWELL_SRC)
    _build.load_swell_lib()
    secs, log = _build.build_log.get(_build.SWELL_SRC, (0.0, "(already built)"))
    ptxas = " | ".join(ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln)
    phase("build", f"H1 {os.path.relpath(so)} in {secs:.2f}s (total {time.perf_counter() - t0:.2f}s); "
          f"ptxas: {ptxas}; native analyze library: {native_available()}")

    # 3. H1 against its plain version on the card
    for name, make in smoke_matrices(gen).items():
        csr = make().to(dev)
        m, n = csr.shape
        x, _ = gen.random_x_y(n, m, seed=75)
        layout = swell.get_swell_plan(csr)
        dx = torch.from_numpy(x).to(dev)
        a = swell.swell_ax(layout, dx)
        p = swell.swell_ax_plain(layout, dx)
        torch.cuda.synchronize()
        compare(name, csr, x, a, p)
    phase("h1-vs-plain", f"H1 launches so far: {swell.swell_ax.launches}")

    # 4. the main path at full size: boneS10 through spmv(strategy="adaptive")
    t0 = time.perf_counter()
    bone = gen.example_like("boneS10")
    t_gen = time.perf_counter() - t0
    m, n = bone.shape
    x, y = gen.random_x_y(n, m, seed=42)
    bone_dev = csr = bone.to(dev)
    dx, dy = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    h = port.Handle()
    swell.swell_ax.launches = 0
    out = port.spmv(csr, dx, dy, alpha=1.0, beta=1.0, strategy="adaptive", handle=h)
    torch.cuda.synchronize()
    launches = swell.swell_ax.launches
    rp, ci, v, _ = bone.to_numpy()
    rep = verify_y(out, host_spmv(1.0, 1.0, rp, ci, v, x, y))
    layout = swell.get_swell_plan(csr)
    phase("main-path", f"boneS10 {m}x{n} nnz={bone.nnz} (generated in {t_gen:.1f}s): "
          f"strategy={h.strategy_used} H1 launches={launches} analyze={h.analyze_time_us:.0f}us "
          f"kernel={h.kernel_time_us:.0f}us slabs={layout.slab_off.numel()} "
          f"slots={layout.slots} fill={layout.fill!r} verify {rep}")
    if h.strategy_used != "swell":
        fail(f"boneS10 went to {h.strategy_used!r}, not swell")
    if launches < 1:
        fail("the main path launched H1 no time")
    if tuple(out.shape) != (m,) or not torch.isfinite(out).all() or not rep.ok:
        fail("boneS10 output is wrong")

    # 5. the CLI entry point on a bin2 file
    from spmv_acc_tpu_torch.cli.main import main as cli_main

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "af23560.bin2")
        write_bin2(path, *gen.example_like("af23560").to_numpy())
        rc = cli_main([path, "-f", "bin2"])
    phase("cli", f"spmv-cli af23560.bin2 -f bin2 returned {rc}")
    if rc != 0:
        fail(f"spmv-cli returned {rc}")

    # 6. times: H1 against the plain version at the main path's shapes, in turns
    records = []
    for name, csr in (("boneS10", bone_dev), ("af23560", gen.example_like("af23560").to(dev))):
        mm, nn = csr.shape
        x, _ = gen.random_x_y(nn, mm, seed=42)
        dx = torch.from_numpy(x).to(dev)
        layout = swell.get_swell_plan(csr)
        a = swell.swell_ax(layout, dx)
        p = swell.swell_ax_plain(layout, dx)
        torch.cuda.synchronize()
        max_abs = compare(name, csr, x, a, p)

        def h1():
            return swell.swell_ax(layout, dx)

        def plain():
            return swell.swell_ax_plain(layout, dx)

        t_p1, t_h1, t_h2, t_p2 = (cuda_time_us(plain), cuda_time_us(h1),
                                  cuda_time_us(h1), cuda_time_us(plain))
        us_h1, us_plain = (t_h1 + t_h2) / 2, (t_p1 + t_p2) / 2
        nbytes = 8 * (2 * mm + csr.nnz) + 4 * (mm + 1 + csr.nnz)
        gbs = nbytes / (us_h1 * 1e-6) / 1e9
        roof = f"{gbs / peak_gbs!r}" if peak_gbs else "not measured"
        phase("times", f"{name}: H1 {t_h1!r} / {t_h2!r} us, plain {t_p1!r} / {t_p2!r} us "
              f"(median of 3 after 10 warmups, CUDA events); H1 {gbs!r} GB/s under "
              f"8(2m+nnz)+4(m+1+nnz) = {nbytes} B, roofline share {roof}; "
              f"padded slots {layout.slots}; card: {card}")
        if name == "boneS10":
            records.append({"name": "swell_spmv_f64", "route": "cuda",
                            "source": "spmv_acc_tpu_torch/csrc/swell_spmv.cu",
                            "replaces": "spmv_acc_tpu/ops/swell.py:455",
                            "launches": launches, "max_abs_err": max_abs,
                            "ms": us_h1 / 1e3, "plain_ms": us_plain / 1e3})

    # 7. records
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
