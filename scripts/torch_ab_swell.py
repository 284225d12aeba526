#!/usr/bin/env python3
"""Per-launch device time of the PyTorch port's swell and tile kernels on the
chip_smoke matrices, for an A/B of two trees of the repo on one card.

    python3 scripts/torch_ab_swell.py [--root DIR] [--label NAME] [--n 50]

Imports ``spmv_acc_tpu_torch`` from DIR (default: this checkout; its kernels
are built into DIR/build), builds every plan at its shipped chunk caps, and
prints one JSON line: µs per launch, CUDA-event loops of ``--n`` launches, two
loops per kernel, with the card's name and power limit.  Set
SPMV_TPU_CORPUS_CACHE to one directory for all runs of a call, so that only
the first generates the matrices.  Run trees in turns (parent, change,
change, parent) inside one call: times from two calls may come from two cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--n", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import spmv_acc_tpu_torch as port
    from spmv_acc_tpu_torch.cli.solve import spdize
    from spmv_acc_tpu_torch.formats import generate as gen
    from spmv_acc_tpu_torch.ops import adaptive_plus as tile
    from spmv_acc_tpu_torch.ops import swell

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

    times = {}
    bone = gen.example_like("boneS10").to(dev)
    bone32 = bone.astype(torch.float32)
    x = torch.from_numpy(gen.random_x_y(bone.cols, bone.rows, seed=42)[0]).to(dev)
    X8 = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (bone.cols, 8))).to(dev)
    lay, lay32 = swell.get_swell_plan(bone), swell.get_swell_plan(bone32)
    times["boneS10 swell f64"] = loop_us(lambda: swell.swell_ax(lay, x))
    times["boneS10 swell f32"] = loop_us(lambda: swell.swell_ax(lay32, x.float()))
    times["boneS10 swell f64 k=8"] = loop_us(lambda: swell.swell_amx(lay, X8))
    planes = swell.prep_x(lay, x)
    times["boneS10 swell planes f64"] = loop_us(lambda: swell.swell_ax_planes(lay, planes))
    dp, dp32 = tile.get_tile_plan(bone), tile.get_tile_plan(bone32)
    times["boneS10 tile f64"] = loop_us(lambda: tile.tile_spmv(dp, x))
    times["boneS10 tile f32"] = loop_us(lambda: tile.tile_spmv(dp32, x.float()))
    del lay, lay32, dp, dp32, planes, bone, bone32
    swell.clear_swell_cache()
    tile.clear_tile_cache()

    ts = gen.example_like("TSOPF_RS_b2383").to(dev)
    tx = torch.from_numpy(gen.random_x_y(ts.cols, ts.rows, seed=42)[0]).to(dev)
    TX8 = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (ts.cols, 8))).to(dev)
    l4, l1, tdp = swell.get_swell_plan(ts), swell.get_swell_plan(ts, r=1), tile.get_tile_plan(ts)
    times[f"TSOPF_RS_b2383 swell f64 r={l4.r}"] = loop_us(lambda: swell.swell_ax(l4, tx))
    times["TSOPF_RS_b2383 swell f64 r=1"] = loop_us(lambda: swell.swell_ax(l1, tx))
    times[f"TSOPF_RS_b2383 swell f64 r={l4.r} k=8"] = loop_us(lambda: swell.swell_amx(l4, TX8))
    times["TSOPF_RS_b2383 tile f64"] = loop_us(lambda: tile.tile_spmv(tdp, tx))
    del l4, l1, tdp, ts
    swell.clear_swell_cache()
    tile.clear_tile_cache()

    ga = gen.example_like("Ga41As41H72")
    rp, ci, v, (m, _) = ga.to_numpy()
    rp2, ci2, v2 = spdize(rp.astype(np.int64), ci.astype(np.int64), v, m)
    gcsr = port.CSR.from_numpy(rp2, ci2, v2, (m, m), device=dev)
    glay = swell.get_swell_plan(gcsr)
    g0 = torch.ones(m, dtype=torch.float64, device=dev)
    times["Ga41As41H72-SPD swell f64"] = loop_us(lambda: swell.swell_ax(glay, g0))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "n": args.n, "us_per_launch": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
