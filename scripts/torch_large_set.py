#!/usr/bin/env python3
"""The swell kernel (float64, the detector's r) on large corpus matrices, on one
card: each launch held against its plain version, then timed beside its bound
and PyTorch's CSR product (cuSPARSE).

    python3 scripts/torch_large_set.py [NAME ...] [--out FILE]

Default: the seven large matrices that ``chip_smoke.py`` does not time
(largebasis, Hardesty3, dielFilterV3real, RM07R, vas_stokes_2M, Cube_Coup_dt6,
Bump_2911).  Phase 1 generates every matrix, builds its layout (loaded from the
disk plan cache when an earlier process saved it) and holds the kernel against
``swell_ax_plain`` within 1e-12 (|A|·|x|) per row; it fails on the first
disagreement or non-finite value.  Phase 2 times them back to back (a
``torch.profiler`` step long after the previous one may drop launches):
µs per call (median of 3 after 10 warmups) and per launch in a CUDA-event loop
of 20, the chunk and fix-up kernels' device µs (``torch.profiler``), the plain
version per call, cuSPARSE per call and in a loop of 20, the bound (the bytes
A @ x needs in CSR over the card's peak), the layout's bytes over those, and,
for r > 1, the r = 1 layout's loop time.  One JSON line per matrix, and the
card's name and power limit, go to stdout (and to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SEVEN = ["largebasis", "Hardesty3", "dielFilterV3real", "RM07R", "vas_stokes_2M",
         "Cube_Coup_dt6", "Bump_2911"]
ROW_TOL = 1e-12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", default=SEVEN)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from spmv_acc_tpu_torch.formats import generate as gen
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.ops.golden import host_spmv
    from spmv_acc_tpu_torch.utils import cuda_time_us
    from spmv_acc_tpu_torch.utils.stats import chip_peak_gbs

    dev = torch.device("cuda")
    peak = chip_peak_gbs()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()

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

    def device_us(fn, kernel, n=10):
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if kernel in e.key]
        total = sum(getattr(e, "device_time_total", 0.0) or e.cuda_time_total for e in evs)
        count = sum(e.count for e in evs)
        return total / count if count else None

    # phase 1: every matrix on the card, its kernel against its plain version
    mats = {}
    for name in args.names:
        t0 = time.perf_counter()
        host = gen.example_like(name)
        t_gen = time.perf_counter() - t0
        rp, ci, v, (m, n) = host.to_numpy()
        x = gen.random_x_y(n, m, seed=42)[0]
        csr = host.to(dev)
        dx = torch.from_numpy(x).to(dev)
        t0 = time.perf_counter()
        lay = swell.get_swell_plan(csr)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        plan = "warm" if "load" in swell.PLAN_TIMES else "cold"
        swell.LAUNCHES.clear()
        a = swell.swell_ax(lay, dx)
        torch.cuda.synchronize()
        launches = dict(swell.LAUNCHES)
        p = swell.swell_ax_plain(lay, dx)
        bound_rows = host_spmv(1.0, 0.0, rp, ci, np.abs(v), np.abs(x), np.zeros(m))
        a_h, p_h = a.cpu().numpy(), p.cpu().numpy()
        gap = np.abs(a_h - p_h)
        finite = bool(np.isfinite(a_h).all())
        within = bool((gap <= ROW_TOL * bound_rows).all())
        print(f"[check] {name} {m}x{n} nnz={host.nnz}: gen {t_gen:.1f}s, layout {t_plan:.1f}s "
              f"({plan}), r={lay.r} fill={lay.fill!r} slots={lay.slots} split row blocks "
              f"{lay.schedule.nsplit}; launches {launches}; max|kernel-plain| {float(gap.max())!r} "
              f"within {ROW_TOL}*(|A||x|): {within}; finite: {finite}", flush=True)
        if not (finite and within):
            print(f"FAIL: {name}: the kernel disagrees with its plain version", flush=True)
            return 1
        mats[name] = dict(csr=csr, dx=dx, lay=lay, max_abs=float(gap.max()), launches=launches,
                          plan=plan, t_gen=t_gen, t_plan=t_plan)
        del host, rp, ci, v, a, p, a_h, p_h, gap, bound_rows

    # phase 2: the timings, back to back
    lines = []
    for name, d in mats.items():
        csr, dx, lay = d["csr"], d["dx"], d["lay"]
        kern = lambda: swell.swell_ax(lay, dx)  # noqa: E731
        plain = lambda: swell.swell_ax_plain(lay, dx)  # noqa: E731
        k_call = [cuda_time_us(kern), cuda_time_us(kern)]
        k_loop = [loop_us(kern), loop_us(kern)]
        k_dev = device_us(kern, "swell_kernel")
        f_dev = device_us(kern, "fixup_kernel") if lay.schedule.nsplit else None
        p_call = cuda_time_us(plain, warmups=1)
        mat = torch.sparse_csr_tensor(csr.row_ptr, csr.col_idx, csr.values, size=csr.shape,
                                      check_invariants=False)
        lib = lambda: torch.mv(mat, dx)  # noqa: E731
        l_call, l_loop = cuda_time_us(lib), loop_us(lib)
        need = csr.nnz * 12 + 4 * (csr.rows + 1) + 8 * csr.cols + 8 * csr.rows
        lay_bytes = sum(t.numel() * t.element_size() for t in (
            lay.vals, lay.lidx, lay.slab_off, lay.slab_log2d, lay.slab_col_base,
            lay.rb_slab_ptr)) + 8 * csr.cols + 8 * csr.rows
        ref_bytes = 8 * (2 * csr.rows + csr.nnz) + 4 * (csr.rows + 1 + csr.nnz)
        rec = {
            "name": name, "rows": csr.rows, "cols": csr.cols, "nnz": csr.nnz, "r": lay.r,
            "fill": lay.fill, "slots": lay.slots, "split_row_blocks": lay.schedule.nsplit,
            "tail": lay.tail_v.numel(), "plan": d["plan"], "gen_s": d["t_gen"],
            "layout_s": d["t_plan"], "launches_one_call": {str(k): c for k, c in
                                                          d["launches"].items()},
            "max_abs_err": d["max_abs"], "kernel_us_call": k_call, "kernel_us_loop": k_loop,
            "kernel_us_device": k_dev, "fixup_us_device": f_dev, "plain_us_call": p_call,
            "cusparse_us_call": l_call, "cusparse_us_loop": l_loop,
            "bound_us": need / (peak * 1e9) * 1e6, "bound_bytes": need,
            "layout_bytes_over_bound": lay_bytes / need, "ref_model_bytes": ref_bytes,
            "roofline_loop": ref_bytes / (min(k_loop) * 1e-6) / 1e9 / peak,
            "card": card, "peak_gbs": peak,
        }
        if lay.r > 1:
            lay1 = swell.get_swell_plan(csr, r=1)
            rec["r1_us_loop"] = loop_us(lambda: swell.swell_ax(lay1, dx))
            rec["r1_slots"], rec["r1_fill"] = lay1.slots, lay1.fill
            del lay1
        line = json.dumps(rec)
        print(line, flush=True)
        lines.append(line)
        del mat
    print(card, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines + [card]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
