#!/usr/bin/env python3
"""Where a distributed step of the PyTorch port spends its time, on one card
or several: a ``torch.profiler`` split of the two loops the multi-device
layer runs.

    python3 scripts/torch_probe_dist.py [--rows-per-device 262144] [--n 20]
    torchrun --standalone --nproc_per_node 4 scripts/torch_probe_dist.py

Alone it joins a one-rank NCCL group through a rendezvous file under
``build/``; under torchrun every rank runs it.  The loops:

* **step D**, for D = 1, 2, 4 up to the world size, on ranks 0 .. D-1: the
  weak-scaling bench's step (``scaling_bench._renormalised`` around
  ``dist_swell_spmv_fn``: the halo exchange, the swell kernel, an all-reduced
  max) on ``banded_csr(D * rows_per_device, bandwidth=17, seed=11)`` in f64.
  Timed twice with CUDA events over ``--n`` steps: first as the bench timed
  it before it warmed a whole chain (one untimed step, then the timed chain:
  ``us, one warm step``), then as ``scaling_bench._loop_us`` times it now
  (an untimed chain and a barrier first: ``us``).  A rank whose first calls
  are slow starts its timed chain late, and the ranks it exchanges with
  count that wait in theirs;
* **cg dist**: fixed-trip iterations of ``dist_swell_cg_solve``'s CG (its
  matvec and ``all_reduced_dot``) at D = world size on gate 3's SPD recipe
  (``dryrun._spd_fem``) at ``--cg-rows`` rows; at world size 1 also **cg
  single**, ``cg_solve(strategy="swell")``'s loop (``swell_ax``, ``torch.dot``).

For each, per step or iteration: µs (the step as above; CG: host clock,
loops of 5 and 5 + ``--n`` after a barrier), and under the profiler (primed
once at the start, each session entered after a barrier, so that no rank's
profiler start-up shows as another's wait) the device's busy µs (kernels
and copies, NCCL kernels apart: an NCCL kernel's time includes its wait for
the peers), the idle share, the ops with the most host (self CPU) time,
``record_param_comms`` (the collectives' bookkeeping) among them, and the
device kernels with the most time and their launches (the CG's profile
includes its set-up: one more matvec and three dots over ``--n``
iterations).  Rank 0 prints one JSON line with every rank's numbers, the
NCCL and torch versions and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-device", type=int, default=262144)
    ap.add_argument("--cg-rows", type=int, default=1_048_576)
    ap.add_argument("--n", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spmv_acc_tpu_torch.dryrun import _spd_fem
    from spmv_acc_tpu_torch.formats.generate import banded_csr
    from spmv_acc_tpu_torch.models.cg import _cg_loop
    from spmv_acc_tpu_torch.ops import _build, swell
    from spmv_acc_tpu_torch.parallel.dist_spmv import all_reduced_dot, make_mesh
    from spmv_acc_tpu_torch.parallel.dist_swell import (build_dist_swell, dist_swell_spmv_fn,
                                                        pad_global)
    from spmv_acc_tpu_torch.parallel.multihost import init_distributed
    from spmv_acc_tpu_torch.parallel.scaling_bench import _loop_us, _renormalised

    if not torch.cuda.is_available():
        print("torch_probe_dist: no CUDA device", file=sys.stderr)
        return 2
    td = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # started by torchrun
        init_distributed(device="cuda")
    else:
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        td = tempfile.mkdtemp(prefix="probe_dist_", dir=_build.BUILD_DIR)
        os.environ["SPMV_TPU_PLAN_CACHE_DIR"] = td
        init_distributed(coordinator_address="file://" + os.path.join(td, "rendezvous"),
                         num_processes=1, process_id=0, device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    n = args.n

    def split(fn, per, group):
        """The profiler's split of ``fn()`` (``per`` steps), per step."""
        fn()
        dist.barrier(group=group)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = prof.key_averages()
        on_dev = [e for e in evs if e.device_type == DeviceType.CUDA]
        nccl = sum(e.self_device_time_total for e in on_dev if "nccl" in e.key.lower())
        busy = sum(e.self_device_time_total for e in on_dev) - nccl
        host = sorted((e for e in evs if e.device_type == DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
        kern = sorted(on_dev, key=lambda e: e.self_device_time_total, reverse=True)[:5]
        return {"device busy us": busy / per, "nccl kernels us": nccl / per,
                "self CPU us": {e.key: round(e.self_cpu_time_total / per, 2) for e in host},
                "device us, launches": {e.key[:80]: [round(e.self_device_time_total / per, 2),
                                                     e.count / per] for e in kern}}

    def one_warm_step_us(step, x):
        """The bench's timing before its warm chain: one untimed step, then
        CUDA events around ``n`` chained steps."""
        step(x)
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        v = x
        for _ in range(n):
            v = step(v)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) * 1e3 / n

    out = {}
    try:
        _build.build_all([_build.SWELL_SRC])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)  # the profiler's one-off start-up
            torch.cuda.synchronize()
        for d in (c for c in (1, 2, 4) if c <= world):
            csr = banded_csr(d * args.rows_per_device, bandwidth=17, seed=11)
            mesh = make_mesh(d)  # every rank joins the sub-group's creation
            if rank < d:
                dsp = build_dist_swell(csr, d, mesh=mesh)
                step = _renormalised(dist_swell_spmv_fn(dsp, mesh), mesh.get_group())
                L = dsp.rows_local
                x = pad_global(dsp, torch.ones(csr.cols, dtype=torch.float64))
                x = x[rank * L: (rank + 1) * L].to(dev).contiguous()

                def chain(x=x, step=step):
                    v = x
                    for _ in range(n):
                        v = step(v)

                first = one_warm_step_us(step, x)
                us = _loop_us(step, x, n, dev, mesh.get_group())
                out[f"step D={d}"] = {"us, one warm step": first, "us": us, "halo": dsp.halo_ok,
                                      **split(chain, n, mesh.get_group())}
                out[f"step D={d}"]["idle share"] = 1.0 - out[f"step D={d}"]["device busy us"] / us
            dist.barrier()

        spd = _spd_fem(args.cg_rows, np.float64)[3].to(dev)
        b = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, spd.rows)).to(dev)
        mesh = make_mesh(world)
        dsp = build_dist_swell(spd, world, mesh=mesh)
        L = dsp.rows_local
        run = dist_swell_spmv_fn(dsp, mesh)
        loops = [("cg dist", run, all_reduced_dot(mesh),
                  pad_global(dsp, b)[rank * L: (rank + 1) * L].contiguous())]
        if world == 1:
            whole = swell.get_swell_plan(spd)
            loops.append(("cg single", lambda v: swell.swell_ax(whole, v), torch.dot, b))

        for label, matvec, dot, bb in loops:
            def trips(k, matvec=matvec, dot=dot, bb=bb, aligned=True):
                if aligned:
                    dist.barrier(group=mesh.get_group())
                t = time.perf_counter()
                _cg_loop(matvec, None, bb, torch.zeros_like(bb), 0.0, k, dot)
                torch.cuda.synchronize()
                return time.perf_counter() - t

            trips(5)
            us = (trips(5 + n) - trips(5)) / n * 1e6
            out[label] = {"us": us, **split(lambda: trips(n, aligned=False), n, mesh.get_group())}
            out[label]["idle share"] = 1.0 - out[label]["device busy us"] / us
        ranks = [None] * world
        dist.all_gather_object(ranks, out)
    finally:
        dist.destroy_process_group()
        if td is not None:
            shutil.rmtree(td, ignore_errors=True)
    if rank == 0:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(json.dumps({"world size": world, "rows per device": args.rows_per_device,
                          "n": n, "per rank": ranks,
                          "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                          "torch": torch.__version__,
                          "cards": card.strip().splitlines()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
