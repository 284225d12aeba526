#!/usr/bin/env python3
"""Per-launch device time of the PyTorch port's ELL row-sum kernel
(``vector_row``) on boneS10 (float64 and float32), TSOPF_RS_b2383 and
Ga41As41H72 (float64), for an A/B of two trees of the repo on one card.

    python3 scripts/torch_ab_ell.py [--root DIR] [--label NAME] [--n 50] [--all-vs]

Imports ``spmv_acc_tpu_torch`` from DIR (default: this checkout; its kernels
are built into DIR/build), builds each matrix's ELL slab with ``csr_to_ell``
and times ``ell_rowsum`` at the tree's own lane count (``--all-vs``: the
kernel at every lane count, 2 to 32): µs per launch, CUDA-event loops of
``--n`` launches, two loops per kernel.  Prints one JSON line with the times,
the lanes each launch used, the largest gap to ``ell_rowsum_plain`` against
1e-12 (|A|·|x|) (plus one float32 ulp), and the card's name and power limit.
Set SPMV_TPU_CORPUS_CACHE to one directory for all runs of a call, so that
only the first generates the matrices.  Run trees in turns (parent, change,
change, parent) inside one call: times from two calls may come from two
cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

VS = (2, 4, 8, 16, 32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--all-vs", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from spmv_acc_tpu_torch.formats import csr_to_ell
    from spmv_acc_tpu_torch.formats import generate as gen
    from spmv_acc_tpu_torch.ops import vector_row as vr

    dev = torch.device("cuda")

    def loop_us(fn):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(2):
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(args.n):
                fn()
            t1.record()
            t1.synchronize()
            out.append(t0.elapsed_time(t1) * 1e3 / args.n)
        return out

    times, lanes, worst = {}, {}, {}
    for name, dtype in (("boneS10", torch.float64), ("boneS10", torch.float32),
                        ("TSOPF_RS_b2383", torch.float64), ("Ga41As41H72", torch.float64)):
        csr = gen.example_like(name).astype(dtype).to(dev)
        x = torch.from_numpy(gen.random_x_y(csr.cols, csr.rows, seed=42)[0]).to(dev, dtype)
        ell = csr_to_ell(csr)
        label = f"{name} {str(dtype)[6:]}"
        vr.LAUNCHES.clear()
        vr.ell_rowsum(ell, x)
        lanes[label] = [key[1] for key in vr.LAUNCHES]
        p = vr.ell_rowsum_plain(ell, x)
        bound = (ell.values.double().abs() * x.double().abs()[ell.col_idx.long()]).sum(1)
        ulp = 2.0**-23 * p.double().abs() if dtype == torch.float32 else 0.0
        runs = ({f"{label} vs={vs}": (lambda vs=vs: vr._launch(ell, x, vs)) for vs in VS}
                if args.all_vs else {label: lambda: vr.ell_rowsum(ell, x)})
        for key, fn in runs.items():
            worst[key] = float(((fn().double() - p.double()).abs() - ulp - 1e-12 * bound).max())
            times[key] = loop_us(fn)
        del csr, x, ell, p, bound

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "n": args.n, "us_per_launch": times,
                      "vs": lanes, "gap_minus_bound_max": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
