"""Weak-scaling benchmark for the distributed SpMV.

Counterpart of ``spmv_acc_tpu/parallel/scaling_bench.py``: the rows per
device are fixed and the matrix grows with the device count
(``banded_csr(m, bandwidth=min(avg_nnz | 1, m), seed=11)``); each count
reports nnz/s and the parallel efficiency against one device, and the
structural efficiency against the same shard layouts run one after another
on one device (``dist_swell_serial_fn``).  On the card each timed chain is
one device program, as the JAX bench's ``time_device_loop`` makes it:
replays of a captured ``utils.graphs.Loop``, the collectives inside.  It
runs on every rank of a joined group: D > 1 ranks on CPUs (gloo) validate
the structure, not a speed; on several cards (NCCL) ``efficiency`` is the
real weak-scaling figure.  The JAX package's ICI model
(``model_ici_efficiency``, TPU link and HBM rates) is not ported.

    python -m spmv_acc_tpu_torch.parallel.scaling_bench --devices 1,2,4 [--device cpu]
    torchrun --standalone --nproc_per_node 4 -m spmv_acc_tpu_torch.parallel.scaling_bench \\
        --devices 1,2,4 --rows-per-device 262144

Without torchrun's environment ``main`` spawns the ranks itself: as many as
the largest device count, on the card as many as there are cards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def _loop_us(step, x, iters: int, device, group=None, reps: int = 3) -> float:
    """µs per call of ``step`` chained ``iters`` times.  On the card the chain
    is one device program, as the JAX package's ``time_device_loop`` runs it:
    a ``utils.graphs.Loop`` of ``iters`` steps, whose untimed first run
    captures it; then a barrier over ``group``, so that no rank's one-off
    start falls into another rank's timed window as a wait at the first
    collective, and CUDA events around one replay.  On the CPU
    ``utils.timer.time_fn`` over the eager chain, the least of ``reps``
    chains (CPU ranks share the host with whatever else runs)."""
    if device.type == "cuda":
        from ..utils.graphs import Loop

        loop = Loop(step, x, unroll=iters)
        loop.advance(iters)  # the warm-up and the capture
        loop.load(x)
        if group is not None:
            dist.barrier(group=group)
        torch.cuda.synchronize(device)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        loop.advance(iters)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) * 1e3 / iters

    def chain(v):
        for _ in range(iters):
            v = step(v)
        return v

    from ..utils.timer import time_fn

    return min(time_fn(chain, x)[1] for _ in range(reps)) / iters


# turns of the distributed and the serial chain in run_weak_scaling
_ROUNDS = 5


def _renormalised(run, group):
    """y = run(x) scaled by 1 / max|y| over every rank (an ``all_reduce``):
    the feedback keeps the chain honest without divergence."""
    def step(x):
        y = run(x)
        top = y.abs().max()
        if group is not None:
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        return y * (1.0 / torch.clamp(top, min=1e-30))

    return step


def run_weak_scaling(device_counts, rows_per_device=32768, avg_nnz=16, iters=20, dtype=None,
                     engine="swell", device=None):
    """One row per device count D (those above the world size are skipped),
    each timed on ranks 0 .. D-1 while the others wait; every rank of the
    joined group calls it and gets the same rows.

    ``engine="swell"``: the swell kernel as each shard's product
    (``dist_swell``, 1-hop halo when the band allows it); ``"gather"``: the
    gather and segment-sum product of ``dist_spmv``.  ``dtype`` defaults to
    float64.  ``device`` is the device of the ranks' computation, by default
    the group's (the card under NCCL, the CPU under gloo); ``single_device_us``
    runs on rank 0.  ``efficiency`` is the per-device rate against D = 1:
    meaningful on several cards only, as CPU ranks share one host.
    ``structural_efficiency`` is ``single_device_us / us_per_spmv`` with the
    swell engine, after the serial output is checked against the distributed
    one."""
    from ..formats.generate import banded_csr
    from .dist_spmv import (dist_spmv_fn, dist_spmv_halo_fn, halo_feasible, make_mesh,
                            mesh_device, shard_partitioned)
    from .dist_swell import build_dist_swell, dist_swell_serial_fn, dist_swell_spmv_fn, pad_global
    from .launch import gather_padded
    from .partition import partition_rows

    if not dist.is_initialized():
        raise RuntimeError("run_weak_scaling runs on every rank of a joined group "
                           "(launch.spawn, torchrun or init_distributed)")
    dtype = np.float64 if dtype is None else dtype
    world, rank = dist.get_world_size(), dist.get_rank()
    results = []
    base_rate = None
    for d in device_counts:
        if d > world:
            if rank == 0:
                print(f"skip D={d}: only {world} devices", file=sys.stderr)
            continue
        m = rows_per_device * d
        csr = banded_csr(m, bandwidth=min(avg_nnz | 1, m), seed=11, dtype=dtype)
        mesh = make_mesh(d)  # every rank joins the sub-group's creation
        row = None
        if rank < d:
            dev = torch.device(device) if device is not None else mesh_device(mesh)
            group = mesh.get_group()
            if engine == "swell":
                dsp = build_dist_swell(csr, d, mesh=mesh)
                run = dist_swell_spmv_fn(dsp, mesh)
                if rank == 0:
                    print(f"D={d}: swell engine halo={'on' if dsp.halo_ok else 'off'} "
                          f"rows_local={dsp.rows_local}", file=sys.stderr)
                L = dsp.rows_local
                x_pad = pad_global(dsp, torch.ones(csr.cols, dtype=csr.values.dtype)).to(dev)
                x = x_pad[rank * L: (rank + 1) * L].contiguous()
            else:
                part = shard_partitioned(partition_rows(csr, d, balance=False), mesh)
                build = dist_spmv_halo_fn if halo_feasible(part, mesh) else dist_spmv_fn
                sp, xp = build(mesh, part)
                x = torch.zeros(xp, dtype=csr.values.dtype, device=dev)
                x[: max(0, min(xp, csr.cols - rank * xp))] = 1.0

                def run(v, sp=sp, part=part):
                    return sp(part.values, part.col_idx, part.row_ids, v)
            serial = None
            if engine == "swell":
                y_dist = gather_padded(run(x), mesh)
                if rank == 0:
                    run_ser = dist_swell_serial_fn(dsp, dev)
                    # the baseline must compute the same thing as the
                    # distributed step (a broken arm reads absurdly fast)
                    y_ser = run_ser(x_pad)
                    np.testing.assert_allclose(y_ser.cpu().numpy(), y_dist.cpu().numpy(),
                                               rtol=1e-6, atol=1e-12,
                                               err_msg="serial baseline != dist output")
                    serial = _renormalised(run_ser, None)
            # the distributed chain (every rank, the slowest counts) and the
            # serial one (rank 0) in turns, the least of each: CPU ranks share
            # the host, and a burst of load during one of two measurements
            # taken one after the other skewed their ratio 0.44-2.1x
            per_us, single_us = float("inf"), None
            for _ in range(_ROUNDS):
                top = torch.tensor([_loop_us(_renormalised(run, group), x, iters, dev, group,
                                             reps=1)], dtype=torch.float64, device=dev)
                dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)  # the slowest rank
                per_us = min(per_us, float(top.item()))
                if serial is not None:
                    us = _loop_us(serial, x_pad, iters, dev, reps=1)
                    single_us = us if single_us is None else min(single_us, us)
                dist.barrier(group=group)  # no rank starts a chain while rank 0 runs serial
            if rank == 0:
                rate = csr.nnz / (per_us * 1e-6) if per_us > 0 else 0.0
                row = dict(devices=d, rows=m, nnz=csr.nnz, us_per_spmv=per_us, nnz_per_s=rate)
                if single_us is not None and per_us > 0:
                    row["single_device_us"] = single_us
                    row["structural_efficiency"] = single_us / per_us
        box = [row]
        dist.broadcast_object_list(box, src=0)
        row = box[0]
        if base_rate is None:
            base_rate = row["nnz_per_s"] / d
        row["efficiency"] = (row["nnz_per_s"] / d) / base_rate if base_rate else 0.0
        if rank == 0:
            msg = (f"D={d}: m={m} nnz={row['nnz']} {row['us_per_spmv']:.0f}us/spmv "
                   f"{row['nnz_per_s'] / 1e6:.1f}M nnz/s eff={row['efficiency']:.2%}")
            if "structural_efficiency" in row:
                msg += f" struct_eff={row['structural_efficiency']:.2%}"
            print(msg, file=sys.stderr)
        results.append(row)
    return results


def _bench_rank(counts, args) -> dict:
    """One rank's run of ``main``: the document it prints."""
    results = run_weak_scaling(counts, args.rows_per_device, args.avg_nnz, args.iters,
                               engine=args.engine)
    backend = dist.get_backend()
    return {
        "weak_scaling": results,
        "engine": args.engine,
        "backend": backend,
        "device": (torch.cuda.get_device_name(torch.cuda.current_device())
                   if backend == "nccl" else "cpu"),
        "structural_only": backend != "nccl",
        "note": ("CPU ranks share one host's cores, so 'efficiency' is no "
                 "weak-scaling figure there; 'structural_efficiency' (the same shard "
                 "layouts run one after another on one device, "
                 "dist_swell_serial_fn, against the distributed step) is the "
                 "structural gate, ~1.0 iff distribution adds no overhead "
                 "beyond the serialised compute; on several cards (NCCL) "
                 "'efficiency' is the weak-scaling figure"),
    }


def _gate(doc) -> int:
    """The reference's exit rule: efficiency >= 0.75 where real devices ran
    D >= 2, otherwise structural efficiency >= 0.75."""
    results = doc["weak_scaling"]
    if len(results) < 2:
        return 0
    if not doc["structural_only"] and results[-1]["devices"] >= 2:
        return 0 if results[-1]["efficiency"] >= 0.75 else 1
    gate = [r.get("structural_efficiency") for r in results
            if r.get("structural_efficiency") is not None]
    return 0 if (gate and min(gate) >= 0.75) else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scaling-bench")
    p.add_argument("--devices", default="1,2,4,8")
    p.add_argument("--rows-per-device", type=int, default=32768)
    p.add_argument("--avg-nnz", type=int, default=16)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--engine", choices=("gather", "swell"), default="swell")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=None, help="also write the JSON artifact here")
    args = p.parse_args(argv)
    counts = [int(c) for c in args.devices.split(",")]
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scaling-bench: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    from .launch import spawn
    from .multihost import init_distributed, shutdown_distributed

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # started by torchrun
        init_distributed(device=args.device)
        try:
            doc = _bench_rank(counts, args)
        finally:
            shutdown_distributed()
        if int(os.environ["RANK"]) != 0:
            return 0  # rank 0 prints the document and applies the gate
    else:
        world = max(counts)
        if args.device == "cuda":
            world = min(world, torch.cuda.device_count())
        doc = spawn(_bench_rank, world, args.device, counts, args)[0]
    print(json.dumps(doc))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    return _gate(doc)


if __name__ == "__main__":
    sys.exit(main())
