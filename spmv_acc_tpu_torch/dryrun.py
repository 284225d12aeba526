"""Multi-device dry run of the port: the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``) on ``torch.distributed``, gates 1-6 at the same
sizes and with the same assertions.

    python -m spmv_acc_tpu_torch.dryrun --devices N [--device cuda|cpu]
    torchrun --standalone --nproc_per_node 4 -m spmv_acc_tpu_torch.dryrun --devices 4

Under torchrun each process is a rank; otherwise the command spawns the N
ranks itself (gloo on the CPU, NCCL with one card a rank).  Gate 4b (the
tailed halo plan) needs two devices and is skipped, with a line that says
so, below that.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip", "main"]


def _spd_fem(m: int, dtype):
    """Gate 3's SPD system: fem_like_csr(m, m, 8m, block=3, seed=5)
    symmetrised, plus a dominant diagonal, without a dense matrix."""
    from .formats.containers import CSR
    from .formats.convert import coo_to_csr_arrays
    from .formats.generate import fem_like_csr

    rp, ci, v, _ = fem_like_csr(m, m, 8 * m, block=3, seed=5, dtype=dtype).to_numpy()
    rr = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    rr_s = np.concatenate([rr, ci, np.arange(m, dtype=np.int64)])
    cc_s = np.concatenate([ci, rr, np.arange(m, dtype=np.int64)])
    off_abs = np.zeros(m)
    np.add.at(off_abs, rr, 0.5 * np.abs(v))
    np.add.at(off_abs, ci, 0.5 * np.abs(v))
    v_s = np.concatenate([0.5 * v, 0.5 * v, off_abs + 1.0])
    rp, ci, v = coo_to_csr_arrays(rr_s, cc_s, v_s, (m, m))
    return rp, ci, v.astype(dtype), CSR.from_numpy(rp, ci, v.astype(dtype), (m, m))


def dryrun_multichip(n_devices: int, device: str | None = None) -> None:
    """Gates 1-6 over a group of ``n_devices`` ranks; every rank calls it
    and asserts.  ``device`` is informational (the group's backend decides:
    NCCL computes on the rank's card, gloo on the CPU).

    1. one distributed SpMV against ``host_spmv``; 2. distributed CG against a
    known solution; 3-4. the same with the swell kernel as the shards'
    product (SpMV and CG); 4b. a tailed plan that keeps the 1-hop halo path
    (needs two devices); 5. the hybrid (dcn, ici) mesh; 6. the weak-scaling
    structural record."""
    from .formats.containers import CSR
    from .formats.convert import coo_to_csr_arrays, csr_to_dense
    from .formats.generate import banded_csr
    from .models.cg import dist_cg_solve
    from .ops.golden import host_spmv
    from .parallel import (dist_spmv, gather_padded, make_mesh, pad_vector, partition_rows,
                           shard_partitioned, unpad_y)
    from .parallel.dist_spmv import mesh_device
    from .parallel.dist_swell import build_dist_swell, dist_swell_cg_solve, dist_swell_spmv_fn, pad_global
    from .parallel.multihost import dist_spmv_hier, hybrid_mesh, shard_partitioned_hier
    from .parallel.scaling_bench import run_weak_scaling
    from .utils.verify import verify_y

    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) runs on every rank of a group of "
                           f"{n_devices} ranks")
    rank = dist.get_rank()
    dtype = np.float64

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    # tiny SPD system
    m = 16 * n_devices
    base = banded_csr(m, bandwidth=3, seed=1, dtype=dtype)
    d = csr_to_dense(*base.to_numpy())
    d = 0.5 * (d + d.T) + np.eye(m) * (np.abs(d).sum(axis=1) + 1.0)
    rr, cc = np.nonzero(d)
    rp, ci, v = coo_to_csr_arrays(rr, cc, d[rr, cc], (m, m))
    csr = CSR.from_numpy(rp, ci, v.astype(dtype), (m, m))

    mesh = make_mesh(n_devices)
    dev = mesh_device(mesh)
    part = shard_partitioned(partition_rows(csr, n_devices, balance=False), mesh)

    # gate 1: one distributed SpMV golden-matched against host_spmv
    rng = np.random.default_rng(3)
    xg = rng.uniform(-1, 1, size=m).astype(dtype)
    y_dist = unpad_y(part, gather_padded(dist_spmv(part, xg, mesh), mesh)).cpu().numpy()
    golden = host_spmv(1.0, 0.0, rp, ci, v.astype(dtype), xg, np.zeros(m, dtype=dtype))
    rep = verify_y(y_dist, golden, dtype=dtype)
    assert rep.ok, f"distributed SpMV failed golden check: {rep}"

    # gate 2: CG against a KNOWN solution, must converge
    x_true = rng.uniform(-1, 1, size=m).astype(dtype)
    b_np = host_spmv(1.0, 0.0, rp, ci, v.astype(dtype), x_true, np.zeros(m, dtype=dtype))
    tol = 1e-8
    res = dist_cg_solve(part, pad_vector(part, b_np.astype(dtype)), mesh, tol=tol,
                        max_iters=4 * m)
    x_sol = unpad_y(part, gather_padded(res.x, mesh)).cpu().numpy()
    resid = float(res.residual_norm)
    bnorm = float(np.linalg.norm(b_np))
    assert resid <= tol * max(bnorm, 1.0), (
        f"distributed CG did not converge: residual={resid:.3e} tol={tol:.1e} iters={res.iters}")
    err = float(np.linalg.norm(x_sol - x_true) / np.linalg.norm(x_true))
    assert err < 1e-5, f"CG solution does not match known x_true: rel err {err:.3e}"
    assert res.x.device == dev and res.x.shape == (part.local_rows,), "x is not this rank's block"

    # gates 3+4: the swell kernel as the distributed local compute
    m2 = 32768
    rp2, ci2, v2, spd = _spd_fem(m2, dtype)
    dsp = build_dist_swell(spd, n_devices, mesh=mesh)
    run = dist_swell_spmv_fn(dsp, mesh)
    L = dsp.rows_local
    xg2 = rng.uniform(-1, 1, size=m2).astype(dtype)
    x_loc = pad_global(dsp, torch.from_numpy(xg2))[rank * L: (rank + 1) * L].to(dev).contiguous()
    y_sw = gather_padded(run(x_loc), mesh)[:m2].cpu().numpy()
    gold2 = host_spmv(1.0, 0.0, rp2, ci2, v2, xg2, np.zeros(m2, dtype=dtype))
    rep2 = verify_y(y_sw, gold2, dtype=dtype)
    assert rep2.ok, f"dist-SWELL SpMV failed golden check: {rep2}"
    x_true2 = rng.uniform(-1, 1, size=m2).astype(dtype)
    b2 = host_spmv(1.0, 0.0, rp2, ci2, v2, x_true2, np.zeros(m2, dtype=dtype))
    res2, _ = dist_swell_cg_solve(spd, torch.from_numpy(b2), mesh, tol=tol, max_iters=400)
    x_sol2 = gather_padded(res2.x, mesh)[:m2].cpu().numpy()
    resid2 = float(res2.residual_norm)
    assert resid2 <= tol * max(float(np.linalg.norm(b2)), 1.0), (
        f"dist-SWELL CG did not converge: residual={resid2:.3e} iters={res2.iters}")
    err2 = float(np.linalg.norm(x_sol2 - x_true2) / np.linalg.norm(x_true2))
    assert err2 < 1e-5, f"dist-SWELL CG solution mismatch: rel err {err2:.3e}"

    # gate 4b: a TAILED plan keeps the 1-hop halo path: near outliers spill
    # to the COO tail, their columns lie in the neighbours' blocks, so
    # halo_ok stays True and the exchange golden-matches.  Its fixture puts
    # outliers between consecutive shards, so it needs two of them
    if n_devices < 2:
        tail_text = "tailed-HALO gate 4b skipped: it needs at least 2 devices"
        say(f"dryrun_multichip({n_devices}): {tail_text}")
    else:
        saved = {k: os.environ.get(k) for k in ("SPMV_TPU_SPILL", "SPMV_TPU_NO_PLAN_CACHE")}
        os.environ.update(SPMV_TPU_SPILL="16", SPMV_TPU_NO_PLAN_CACHE="1")
        try:
            Lh = 16384
            mh = n_devices * Lh
            rph, cih, vh, _ = banded_csr(mh, bandwidth=5, seed=31, dtype=dtype).to_numpy()
            rngh = np.random.default_rng(32)
            rows_h = np.repeat(np.arange(mh), np.diff(rph))
            roh = np.concatenate([dd * Lh + rngh.integers(4000, 8000, size=12)
                                  for dd in range(n_devices - 1)])
            coh = roh + Lh
            voh = rngh.uniform(-1, 1, size=len(roh))
            rph, cih, vh = coo_to_csr_arrays(
                np.concatenate([rows_h, roh]), np.concatenate([cih, coh]),
                np.concatenate([vh, voh]), (mh, mh))
            tailed = CSR.from_numpy(rph, cih, vh.astype(dtype), (mh, mh))
            dsph = build_dist_swell(tailed, n_devices, mesh=mesh)
        finally:
            for k, val in saved.items():
                if val is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = val
        assert dsph.tail_nnz > 0, "fixture produced no tail"
        assert dsph.halo_ok, "tailed 1-hop plan must keep the halo path"
        runh = dist_swell_spmv_fn(dsph, mesh)  # takes the halo path
        xh = rng.uniform(-1, 1, size=mh).astype(dtype)
        Lt = dsph.rows_local
        xh_loc = pad_global(dsph, torch.from_numpy(xh))[rank * Lt: (rank + 1) * Lt].to(dev)
        yh = gather_padded(runh(xh_loc.contiguous()), mesh)[:mh].cpu().numpy()
        goldh = host_spmv(1.0, 0.0, rph, cih, vh.astype(dtype), xh, np.zeros(mh, dtype=dtype))
        reph = verify_y(yh, goldh, dtype=dtype)
        assert reph.ok, f"tailed-halo dist-SWELL failed golden check: {reph}"
        tail_text = (f"tailed-HALO golden OK (max_err={reph.max_error:.2e}, halo=on, "
                     f"tail {dsph.tail_nnz})")

    # gate 5: the hybrid (dcn, ici) mesh: the two-stage x gather (over ici,
    # then dcn) must golden-match on a (hosts x local) factoring
    dcn = 2 if n_devices % 2 == 0 else 1
    hmesh = hybrid_mesh(dcn=dcn, ici=n_devices // dcn)
    hpart = shard_partitioned_hier(partition_rows(csr, n_devices, balance=False), hmesh)
    y_h = unpad_y(hpart, gather_padded(dist_spmv_hier(hpart, xg, hmesh), hmesh)).cpu().numpy()
    rep3 = verify_y(y_h, golden, dtype=dtype)
    assert rep3.ok, f"hybrid-mesh SpMV failed golden check: {rep3}"

    # gate 6: the weak-scaling structural record: the distributed step timed
    # against the same shard layouts run one after another on one device
    # (dist_swell_serial_fn).  65536 rows a device: below that the per-shard
    # fixed costs dominate and the ratio measures overhead, not structure
    structural = dist.get_backend() != "nccl"
    scal = run_weak_scaling([1, n_devices], rows_per_device=65536, iters=4, dtype=dtype)
    assert len(scal) == 2, f"weak-scaling gate did not run both device counts: {scal}"
    if structural:
        # the structural gate must actually fire (no vacuous pass)
        assert "structural_efficiency" in scal[-1], f"no structural record: {scal}"
        if scal[-1]["structural_efficiency"] < 0.7 or scal[0]["structural_efficiency"] < 0.7:
            # host-contention guard: wall timings of CPU ranks on a shared host
            # can skew 2x under load; one clean retry before declaring collapse
            scal = run_weak_scaling([1, n_devices], rows_per_device=65536, iters=4, dtype=dtype)
        se, se1 = scal[-1]["structural_efficiency"], scal[0]["structural_efficiency"]
        assert se >= 0.7, f"dist-swell structural efficiency collapsed: {scal}"
        assert se1 >= 0.7, f"D=1 baseline and dist disagree: {scal}"
    say(f"weak-scaling structural record: {scal}")
    say(f"dryrun_multichip({n_devices}) on {dist.get_backend()} ({device or dev.type}): "
        f"dist-SpMV golden OK (max_err={rep.max_error:.2e}), CG converged iters={res.iters} "
        f"residual={resid:.3e}, x_true rel err={err:.2e}, x in {n_devices} block(s); "
        f"dist-SWELL golden OK (max_err={rep2.max_error:.2e}, r={dsp.r}, "
        f"halo={'on' if dsp.halo_ok else 'off'}), swell-CG iters={res2.iters} rel err="
        f"{err2:.2e}; {tail_text}; hybrid {dcn}x{n_devices // dcn} mesh golden OK "
        f"(max_err={rep3.max_error:.2e})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dryrun")
    p.add_argument("--devices", type=int, default=None,
                   help="ranks (default: torchrun's world size, else 1)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    from .parallel.launch import spawn
    from .parallel.multihost import init_distributed, shutdown_distributed

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # started by torchrun
        init_distributed(device=args.device)
        try:
            dryrun_multichip(args.devices or dist.get_world_size(), args.device)
        finally:
            shutdown_distributed()
    else:
        n = args.devices or 1
        spawn(dryrun_multichip, n, args.device, n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
