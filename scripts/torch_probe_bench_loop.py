#!/usr/bin/env python3
"""Does profiling with ``torch.profiler`` change the host time of the bench's
chained loop after it?  On one card, for each named matrix: the per-iteration
time of ``make_swell_run``'s loop (``bench._slope_us`` at the bench's loop
lengths) three times, then one profiled step (``bench._profile``), then the
loop three times again.

    python3 scripts/torch_probe_bench_loop.py [NAME ...]

Prints one JSON line per matrix (µs an iteration before and after, the
profiler's kernel µs and busy µs an iteration) and the card's name and power
limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or ["rajat03", "TSOPF_RS_b2383"]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from spmv_acc_tpu_torch import bench
    from spmv_acc_tpu_torch.formats.generate import example_like, random_x_y
    from spmv_acc_tpu_torch.ops import swell

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for name in names:
        csr = example_like(name).to(dev)
        x, y = (torch.from_numpy(a).to(dev) for a in random_x_y(csr.cols, csr.rows, seed=42))
        run_n = swell.make_swell_run(csr)
        it = bench._iters_for(csr.nnz)

        def run(n):
            return run_n(x, y, n)

        def loops():
            return [bench._slope_us(run, 1 + it // 4, 1 + it, dev) for _ in range(3)]

        before = loops()
        k_us, count, busy = bench._profile(run, 5)
        after = loops()
        print(json.dumps({"name": name, "iters": it, "loop_us_before": before,
                          "kernel_us": k_us, "recorded": count, "busy_us": busy,
                          "loop_us_after": after, "card": card}), flush=True)
        swell.clear_swell_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
