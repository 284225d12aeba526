"""Readings for the limits of a cell's check: the program on many seeds and
the control on a few, after one set-up, in one process.

    python3 -m perfbench.calibrate --workload hpcg104.cg_jacobi \\
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3 --out calib.jsonl

For each seed: a short closed-loop window at the cell's own load, then the
cell's check; one JSON line each with the numbers compared.  The control is
the reference put in the program's place one precision below the
configuration's (the kind's ``Control``); it has to come out not correct.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None, root=None, device=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--every", type=int, default=None,
                    help="keep one answer in this many (default: the mix's check_every)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(root or os.getcwd())

    import torch

    from perfbench import run

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, cfg_entry = run.find(bench, args.workload)
    dev = torch.device(device or "cuda")
    c, kind = run.open_cell(root, cell, cfg_entry, dev)
    out = open(args.out, "a") if args.out else None
    try:
        for label, seeds, make in (("program", args.seeds, kind.Program),
                                   ("control", args.control_seeds, kind.Control)):
            seeds = [int(s) for s in seeds.split(",") if s]
            if not seeds:
                continue
            program = make(c)
            program.request(12345, -1)  # warm-up
            program.sync()
            for seed in seeds:
                t = time.perf_counter()
                win = run.run_window(program, seed, args.seconds,
                                     args.every or c.traffic["check_every"])
                numbers, failed, checked = kind.check(c, seed, win)
                rec = {"workload": args.workload, "side": label, "seed": seed,
                       "requests": len(win.latencies), "units": sum(win.units),
                       "wall_s": win.wall, "checked": checked, "failed": failed,
                       "numbers": {n: v for n, v, _ in numbers},
                       "limits": {n: lim for n, _, lim in numbers},
                       "seconds": time.perf_counter() - t}
                line = json.dumps(rec)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
            program.close()
            del program
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
