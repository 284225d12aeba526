"""spmv-cli on PyTorch: load a matrix, run SpMV on the device, verify against the
CPU golden.

The reference CLI's flow (cli/main.cpp:33-140) and the JAX package's output
strings and exit codes: parse ``-f csr|mtx|bin2``, ingest, create host data (the
file's x for csr format, random x otherwise, random y always — cli/utils.hpp:65-85),
warmup iterations on ``--device`` (default ``cuda``), one timed run printing
``<file> elapsed time: X(us)``, a rerun for the result, golden-verify and print
the pass/fail verdict (cli/verification.cpp:43-54).  Exit code 0 on pass, 1 on
a failed verify, 2 on a bad file, an input the port cannot run, or no CUDA
card when the device is ``cuda`` (``--device cpu`` runs on the CPU).

    python -m spmv_acc_tpu_torch.cli.main matrix.bin2 -f bin2
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import WARMUP_ITERS
from ..dispatch import Handle, make_spmv_fn, spmv
from ..formats.containers import CSR
from ..formats.generate import random_x_y
from ..io import load_matrix
from ..ops.golden import host_spmv
from ..utils.timer import WallTimer, sync
from ..utils.verify import verify


def build_parser():
    p = argparse.ArgumentParser(
        prog="spmv-cli",
        description="SpMV on PyTorch/CUDA: y = alpha*A*x + beta*y with golden verification",
    )
    p.add_argument("file", help="path of input matrix file")
    p.add_argument(
        "-f",
        "--format",
        default="csr",
        choices=["csr", "mtx", "bin2"],
        help="input matrix file format (default: csr)",
    )
    p.add_argument(
        "-s",
        "--strategy",
        default="adaptive",
        help="kernel strategy (default: adaptive)",
    )
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--dtype", default="float64", choices=["float64", "float32"])
    p.add_argument("--warmups", type=int, default=WARMUP_ITERS)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument(
        "--device-verify",
        action="store_true",
        help="verify against the plain 'default' strategy on the same device "
        "instead of the CPU golden (analog of the reference's DEVICE_SIDE_VERIFY "
        "rocSPARSE check, config.cmake:7-9 / cli/verification.cpp:81-113)",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where SpMV runs (default cuda; no CUDA card is an error)")
    return p


def test_spmv(args) -> int:
    dtype = np.dtype(args.dtype)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise ValueError("no CUDA device; pass --device cpu to run on the CPU")
    device = torch.device(args.device)
    row_ptr, col_idx, values, shape, file_x = load_matrix(
        args.file, fmt=args.format, dtype=dtype
    )
    m, n = shape
    print(f"loaded {args.file}: rows={m} cols={n} nnz={len(values)}")

    # host data (cli/utils.hpp:65-85): keep file x when present, random otherwise
    x, y = random_x_y(n, m, seed=args.seed, dtype=dtype)
    if file_x is not None and len(file_x) == n:
        x = np.asarray(file_x, dtype=dtype)

    csr = CSR.from_numpy(row_ptr, col_idx, values, shape, device=device)
    dx = torch.from_numpy(x).to(device)
    dy = torch.from_numpy(y).to(device)

    handle = Handle()
    fn, chosen = make_spmv_fn(csr, alpha=args.alpha, beta=args.beta, strategy=args.strategy)
    handle.strategy_used = chosen
    # warmup (cli/main.cpp:99-103)
    for _ in range(args.warmups):
        fn(dx, dy)
    sync(device)

    timer = WallTimer(device).start()
    fn(dx, dy)
    elapsed = timer.stop()
    print(f"{args.file} elapsed time: {elapsed:.1f}(us)  [strategy: {handle.strategy_used}]")

    # rerun for the verified result (cli/main.cpp:116-118)
    hy = spmv(csr, dx, dy, alpha=args.alpha, beta=args.beta, strategy=chosen)

    if args.device_verify:
        golden = spmv(csr, dx, dy, alpha=args.alpha, beta=args.beta, strategy="default")
    else:
        golden = host_spmv(args.alpha, args.beta, row_ptr, col_idx, values, x, y)
    ok = verify(hy, golden, dtype=dtype)
    return 0 if ok else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return test_spmv(args)
    except FileNotFoundError as e:
        print(f"file open failed, file: {e.filename}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
