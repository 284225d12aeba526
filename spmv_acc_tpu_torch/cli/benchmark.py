"""spmv-benchmark on PyTorch: every engine on one matrix, the reference's CSV.

The all-engine harness of the reference (benchmark/main.cpp:87-144 with
csr_spmv.hpp:23-100) and of the JAX package (``spmv_acc_tpu/cli/benchmark.py``):
for one matrix, run every enabled engine — the 14 strategies behind
``spmv(strategy=...)``, a numpy CPU baseline, PyTorch's own sparse CSR matvec
(cuSPARSE on the card: the third-party engine, as the reference's cuSPARSE
adapter is) and a dense matvec anchor — each with the reference protocol:
``--warmups`` calls with y reset, then the median of ``BENCHMARK_ARRAY_SIZE``
timed repetitions of ``--iters`` calls, CUDA events on the card
(``utils.timer.cuda_time_us``); golden verification; one CSV row per engine
in the 18-column schema (``utils/stats.py``).  An engine that raises is logged
on stderr and counted, and any failure makes the exit code 1 (csr_spmv.hpp:52-62).

The device is ``--device`` (default ``cuda``); without a CUDA card the run
stops with exit code 2 unless ``--device cpu`` is given, in which case every
time in the CSV is a host wall-clock time of the CPU run.

    python -m spmv_acc_tpu_torch.cli.benchmark matrix.bin2 -f bin2
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

from ..config import BENCHMARK_ARRAY_SIZE, WARMUP_ITERS
from ..dispatch import make_spmv_fn
from ..formats.containers import CSR
from ..formats.generate import random_x_y
from ..io import load_matrix
from ..ops.golden import host_spmv
from ..utils.stats import CSV_HEADER, BenchTimes, print_statistics
from ..utils.timer import WallTimer, cuda_time_us
from ..utils.verify import verify_y

# engine name -> strategy (None: the numpy CPU baseline; "@...": special engines)
ENGINES = [
    ("spmv-acc-adaptive", "adaptive"),
    ("spmv-acc-default", "default"),
    ("spmv-acc-line", "line"),
    ("spmv-acc-ell", "ell"),
    ("spmv-acc-flat", "flat"),
    ("spmv-acc-vector-row", "vector_row"),
    ("spmv-acc-adaptive-plus", "adaptive_plus"),
    ("spmv-acc-swell", "swell"),
    ("spmv-acc-thread-row", "thread_row"),
    ("spmv-acc-wf-row", "wf_row"),
    ("spmv-acc-block-row", "block_row"),
    ("spmv-acc-light", "light"),
    ("spmv-acc-line-enhance", "line_enhance"),
    ("spmv-acc-acsr", "acsr"),
    ("numpy-cpu", None),
    ("torch-sparse-csr", "@torch_csr"),
    ("dense-anchor", "@dense_anchor"),
]


def _time_us(fn, iters: int, warmups: int, device) -> float:
    """Median time of one ``fn()`` call: ``warmups`` calls, then the median of
    BENCHMARK_ARRAY_SIZE repetitions of ``iters`` calls, divided by ``iters``;
    CUDA events on a card, the host clock around a CPU run."""
    iters = max(iters, 1)

    def loop():
        for _ in range(iters):
            fn()

    for _ in range(warmups):
        fn()
    if torch.device(device).type == "cuda":
        return cuda_time_us(loop, warmups=0) / iters
    times = []
    for _ in range(BENCHMARK_ARRAY_SIZE):
        t = WallTimer(device).start()
        loop()
        times.append(t.stop() / iters)
    return statistics.median(times)


def _dense_anchor(csr, iters, warmups, dtype, device):
    """A dense matvec moving about the bytes of the CSR problem, reported as the
    time it would take for exactly those bytes: the practical device-memory
    speed of light.  It computes another product by design."""
    m = csr.rows
    itemsize = np.dtype(dtype).itemsize
    target = (2 * m + csr.nnz) * itemsize + (m + 1 + csr.nnz) * 4
    k = int(np.clip(target // max(m, 1) // itemsize, 128, 4096)) & ~127
    mm = max(128, min(m, target // (k * itemsize)))
    rng = np.random.default_rng(0)
    dmat = torch.from_numpy(rng.standard_normal((mm, k)).astype(dtype)).to(device)
    dx = torch.from_numpy(rng.standard_normal(k).astype(dtype)).to(device)
    us = _time_us(lambda: torch.matmul(dmat, dx), iters, warmups, device)
    return us * target / (mm * k * itemsize)


def bench_engine(strategy, csr, x_np, y_np, alpha, beta, iters, warmups, dtype, device):
    """(BenchTimes, VerifyReport) of one engine on ``csr``."""
    rp, ci, v, _ = csr.to_numpy()
    golden = host_spmv(alpha, beta, rp, ci, v, x_np, y_np)
    if strategy is None:  # CPU baseline: the numpy golden loop itself
        t = WallTimer().start()
        for _ in range(max(iters, 1)):
            out = host_spmv(alpha, beta, rp, ci, v, x_np, y_np)
        return BenchTimes(calc=t.stop() / max(iters, 1)), verify_y(out, golden, dtype=dtype)
    if strategy == "@dense_anchor":
        us = _dense_anchor(csr, iters, warmups, dtype, device)
        # its product is another one by design: the verification columns are
        # vacuous (the reference's verify_beta_y() = false, csr_spmv.hpp:28)
        return BenchTimes(calc=us), verify_y(golden, golden, dtype=dtype)

    dx = torch.from_numpy(x_np).to(device)
    dy = torch.from_numpy(y_np).to(device)
    pre = WallTimer(device).start()
    if strategy == "@torch_csr":
        mat = torch.sparse_csr_tensor(csr.row_ptr, csr.col_idx, csr.values, size=csr.shape,
                                      check_invariants=False)

        def fn(x, y):
            return alpha * torch.mv(mat, x) + beta * y
    else:
        fn, _ = make_spmv_fn(csr, alpha=alpha, beta=beta, strategy=strategy)
    pre_us = pre.stop()  # analyze / layout phase (SpMVAccHanele.pre)
    calc_us = _time_us(lambda: fn(dx, dy), iters, warmups, device)
    rep = verify_y(fn(dx, dy), golden, dtype=dtype)
    return BenchTimes(pre=pre_us, calc=calc_us), rep


def build_parser():
    p = argparse.ArgumentParser(prog="spmv-benchmark", description="all-engine SpMV comparison")
    p.add_argument("file")
    p.add_argument("-f", "--format", default=None, choices=[None, "csr", "mtx", "bin2"])
    p.add_argument("--engines", default=None, help="comma-separated engine filter")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--dtype", default="float64", choices=["float64", "float32"])
    p.add_argument("--iters", type=int, default=50, help="calls per timed repetition")
    p.add_argument("--warmups", type=int, default=WARMUP_ITERS)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engines run (default cuda; no CUDA card is an error)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to benchmark on the CPU",
              file=sys.stderr)
        return 2
    device = torch.device(args.device)
    dtype = np.dtype(args.dtype)
    try:
        row_ptr, col_idx, values, shape, file_x = load_matrix(args.file, fmt=args.format,
                                                              dtype=dtype)
    except FileNotFoundError as e:
        print(f"file open failed, file: {e.filename}", file=sys.stderr)
        return 2
    m, n = shape
    x, y = random_x_y(n, m, seed=args.seed, dtype=dtype)
    if file_x is not None and len(file_x) == n:
        x = np.asarray(file_x, dtype=dtype)
    csr = CSR.from_numpy(row_ptr, col_idx, values, shape, device=device)
    matrix_name = str(args.file).rsplit("/", 1)[-1]
    print(f"matrix {matrix_name}: rows={m} cols={n} nnz={len(values)} device={device}",
          file=sys.stderr)
    print(CSV_HEADER)

    wanted = set(args.engines.split(",")) if args.engines else None
    failures = 0
    for name, strategy in ENGINES:
        if wanted and name not in wanted:
            continue
        try:
            times, rep = bench_engine(strategy, csr, x, y, args.alpha, args.beta, args.iters,
                                      args.warmups, dtype, device)
            print_statistics(matrix_name, name, m, n, csr.nnz, times, rep,
                             value_bytes=dtype.itemsize)
            if not rep.ok:
                failures += 1
        except Exception as e:  # the reference logs a crashed engine and goes on
            print(f"ERROR,{matrix_name},{name},{type(e).__name__}: {e}", file=sys.stderr)
            failures += 1
    sys.stdout.flush()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
