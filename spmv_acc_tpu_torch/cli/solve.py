"""spmv-solve on PyTorch: CG on a loaded matrix with the strategy zoo's SpMV.

The JAX package's ``spmv-solve`` flow, arguments, strings and exit codes:
ingest (``-f csr|mtx|bin2``), SPD-ize unless ``--assume-spd`` (0.5 (A + A^T)
plus diagonal dominance: CG needs an SPD matrix), make b from a known x_true,
solve with the chosen preconditioner, print iterations, residual and wall
times, and verify the solution against x_true (relative error < 1e-6).  Exit
code 0 on a verified solution, 1 on a failed one, 2 for a non-square matrix or
no CUDA card when ``--device`` is ``cuda`` (the default; ``--device cpu`` runs
on the CPU).

    python -m spmv_acc_tpu_torch.cli.solve matrix.bin2 -f bin2 --precond ilu0
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..formats.containers import CSR
from ..io import load_matrix
from ..utils.timer import sync


def build_parser():
    p = argparse.ArgumentParser(
        prog="spmv-solve",
        description="Preconditioned CG driven by the PyTorch/CUDA SpMV strategies",
    )
    p.add_argument("file", help="path of input matrix file")
    p.add_argument("-f", "--format", default="csr", choices=["csr", "mtx", "bin2"])
    p.add_argument("-s", "--strategy", default="adaptive",
                   help="SpMV strategy for the matvec (default: adaptive)")
    p.add_argument("--precond", default="jacobi", choices=["none", "jacobi", "ilu0"],
                   help="preconditioner (default: jacobi)")
    p.add_argument("--sweeps", type=int, default=None,
                   help="ILU(0) triangular-solve Jacobi sweeps (default: auto)")
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--max-iters", type=int, default=1000)
    p.add_argument("--assume-spd", action="store_true",
                   help="matrix is already SPD; skip the SPD-izing transform")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where CG runs (default cuda; no CUDA card is an error)")
    return p


def spdize(rp, ci, v, m):
    """0.5 (A + A^T) off the diagonal, and a diagonal of 1 + half the absolute
    off-diagonal sums of the row and the column: symmetric and strictly
    diagonally dominant, so SPD.  Returns canonical CSR arrays."""
    from ..formats.convert import coo_to_csr_arrays

    rr = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    off = ci != rr
    rr_s = np.concatenate([rr[off], ci[off], np.arange(m, dtype=np.int64)])
    cc_s = np.concatenate([ci[off], rr[off], np.arange(m, dtype=np.int64)])
    dom = np.zeros(m)
    np.add.at(dom, rr[off], 0.5 * np.abs(v[off]))
    np.add.at(dom, ci[off], 0.5 * np.abs(v[off]))
    v_s = np.concatenate([0.5 * v[off], 0.5 * v[off], dom + 1.0])
    return coo_to_csr_arrays(rr_s, cc_s, v_s, (m, m))


def main(argv=None) -> int:
    from ..models.cg import cg_solve, jacobi_preconditioner
    from ..ops.golden import host_spmv

    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    rp, ci, v, shape, _x = load_matrix(args.file, args.format, dtype=np.float64)
    m, n = shape
    if m != n:
        print(f"matrix is {m}x{n}; CG needs square", file=sys.stderr)
        return 2
    if not args.assume_spd:
        rp, ci, v = spdize(np.asarray(rp).astype(np.int64), np.asarray(ci).astype(np.int64),
                           np.asarray(v), m)
        print(f"SPD-ized: nnz {shape} -> {len(ci)}", flush=True)
    csr = CSR.from_numpy(rp, ci, v, (m, m), device=device)

    precond = None
    t0 = time.perf_counter()
    if args.precond == "jacobi":
        precond = jacobi_preconditioner(csr)
    elif args.precond == "ilu0":
        from ..ops.trisolve import ilu0

        precond = ilu0(csr, sweeps=args.sweeps)
    sync(device)
    t_pre = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed)
    x_true = rng.standard_normal(m)
    b = torch.from_numpy(host_spmv(1.0, 0.0, rp, ci, v, x_true, np.zeros(m))).to(device)

    t0 = time.perf_counter()
    res = cg_solve(csr, b, tol=args.tol, max_iters=args.max_iters, strategy=args.strategy,
                   precond=precond)
    x_sol = res.x.cpu().numpy()
    t_solve = time.perf_counter() - t0
    err = float(np.linalg.norm(x_sol - x_true) / max(np.linalg.norm(x_true), 1e-300))
    ok = err < 1e-6
    print(f"{args.file} cg[{args.precond}] iters={int(res.iters)} "
          f"residual={float(res.residual_norm):.3e} rel_err={err:.3e} "
          f"precond_setup={t_pre:.2f}s solve={t_solve:.2f}s")
    print("Congratulation, solution verified!" if ok
          else f"solution FAILED verification (rel err {err:.3e})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
