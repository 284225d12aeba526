#!/usr/bin/env python3
"""The multi-device layer's loops on one card or several, eager against
captured: where a distributed step of the PyTorch port spends its time, and
what the captured CUDA graphs (NCCL collectives inside) change.

    python3 scripts/torch_probe_dist.py [--rows-per-device 262144] [--cg-rows 1048576]
        [--n 20] [--capture-modes 40]
    torchrun --standalone --nproc_per_node 4 scripts/torch_probe_dist.py

Alone it joins a one-rank NCCL group through a rendezvous file under
``build/``; under torchrun every rank runs it.  The loops:

* **step D** (section `steps`), for D = 1, 2, 4 up to the world size, on ranks 0 .. D-1: the
  weak-scaling bench's step (``scaling_bench._renormalised`` around
  ``dist_swell_spmv_fn``: the halo exchange, the swell kernel, an all-reduced
  max) on ``banded_csr(D * rows_per_device, bandwidth=17, seed=11)`` in f64.
  ``eager us``: CUDA events around ``--n`` chained steps launched from the
  host, after one untimed chain and a barrier; ``captured us``:
  ``scaling_bench._loop_us``, the same chain as replays of a captured graph;
  whether the two chains give the same bits.
* **cg swell** and **cg gather** (section `cg`): fixed-trip CG iterations (tol 0) at D =
  world size on gate 3's SPD recipe (``dryrun._spd_fem``) at ``--cg-rows``
  rows, with ``dist_swell_cg_solve``'s matvec and with ``dist_cg_solve``'s
  (the gather-and-segment-sum product, its halo exchange where the partition
  allows it), dots all-reduced: the plain loop (``_cg_loop``, the stop test
  read on the host each iteration) against ``CGBlocks`` captured from the
  first iteration, µs an iteration on the host clock
  (loops of 5 and 5 + ``--n`` after a barrier), x after ``5 + n``
  iterations, twice each way: eager against eager, captured against
  captured and captured against eager (bit for bit or the relative
  difference), and each run's residual over ``|b|``.  **cg gather,
  deterministic** runs the gather matvec the same way under
  ``torch.use_deterministic_algorithms`` (``index_add_`` without atomics),
  so that the captured loop can be held to the eager one bit for bit.  At
  world size 1 also **cg single**, ``cg_solve``'s loop on the whole matrix
  (``swell_ax``, one device's sums).
* **solve swell** and **solve gather** (section `solves`): ``dist_swell_cg_solve`` and
  ``dist_cg_solve`` as called at tol 1e-8, twice with every iteration plain
  and twice captured (``CG_EAGER_ITERS`` = 0; the second call reuses
  nothing, so both pay their capture): iterations, residual over ``|b|``,
  x eager against eager, captured against eager and captured against
  captured, wall seconds.
* **capture modes** (``--capture-modes N``): N captures of a two-step loop
  whose step all-reduces, each after eager collectives that NCCL's watchdog
  thread then polls, in the capture modes "global" and "thread_local": how
  many failed, and the first error (at world size 1 only).

For each loop, per step or iteration, under the profiler (primed once at
the start, each session entered after a barrier): the device's busy µs
(kernels and copies, NCCL kernels apart: an NCCL kernel's time includes its
wait for the peers), the NCCL kernels' µs, the idle share, the ops with the
most host (self CPU) time and the device kernels with the most time and
their launches.  Every rank prints each loop's record as a JSON line when
the loop ends (and a progress line on stderr when it starts); rank 0's last
line has every rank's numbers, the NCCL and torch versions and the cards'
names and power limits.
"""

from __future__ import annotations

import argparse
import gc
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
    ap.add_argument("--capture-modes", type=int, default=0)
    ap.add_argument("--no-profile", action="store_true",
                    help="leave out the profiler's split (device busy µs, idle share)")
    ap.add_argument("--sections", default="solves,cg,steps",
                    help="which of solves, cg and steps to run (they run in that order)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spmv_acc_tpu_torch.dryrun import _spd_fem
    from spmv_acc_tpu_torch.formats.generate import banded_csr
    from spmv_acc_tpu_torch.models import cg
    from spmv_acc_tpu_torch.ops import _build, swell
    from spmv_acc_tpu_torch.parallel import pad_vector, partition_rows
    from spmv_acc_tpu_torch.parallel.dist_spmv import (all_reduced_sum, dist_spmv_fn,
                                                       dist_spmv_halo_fn, halo_feasible,
                                                       make_mesh, shard_partitioned)
    from spmv_acc_tpu_torch.parallel.dist_swell import (build_dist_swell, dist_swell_cg_solve,
                                                        dist_swell_spmv_fn, pad_global)
    from spmv_acc_tpu_torch.parallel.multihost import init_distributed, shutdown_distributed
    from spmv_acc_tpu_torch.parallel.scaling_bench import _loop_us, _renormalised
    from spmv_acc_tpu_torch.utils import graphs

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
    sections = args.sections.split(",")
    t_start = time.perf_counter()

    def note(msg):
        """A progress line on stderr (where a rank stops, if one hangs)."""
        print(f"[probe rank {rank} {time.perf_counter() - t_start:.1f}s] {msg}", file=sys.stderr,
              flush=True)

    def keep(label, rec):
        """Record ``rec`` and print it at once (a later hang loses nothing)."""
        out[label] = rec
        print(json.dumps({"rank": rank, label: rec}), flush=True)

    def split(fn, per, group, us):
        """The profiler's split of ``fn()`` (``per`` steps), per step, and the
        idle share against ``us`` a step (nothing with ``--no-profile``)."""
        if args.no_profile:
            return {}
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
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
        kern = sorted(on_dev, key=lambda e: e.self_device_time_total, reverse=True)[:5]
        return {"device busy us": busy / per, "nccl kernels us": nccl / per,
                "idle share": 1.0 - busy / per / us,
                "self CPU us": {e.key: round(e.self_cpu_time_total / per, 2) for e in host},
                "device us, launches": {e.key[:80]: [round(e.self_device_time_total / per, 2),
                                                     e.count / per] for e in kern}}

    def eager_us(step, x, group):
        """CUDA events around ``n`` chained steps launched from the host,
        after one untimed chain and a barrier."""
        def chain(v):
            for _ in range(n):
                v = step(v)
            return v

        chain(x)
        dist.barrier(group=group)
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        chain(x)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) * 1e3 / n

    def same(a, b):
        if torch.equal(a, b):
            return "bit for bit"
        return f"relative {float((a - b).norm() / b.norm().clamp(min=1e-300))!r}"

    def compare(xs):
        """This rank's x of two eager and two captured runs, each pair held
        against the other."""
        return {"x eager again against eager": same(xs["eager again"], xs["eager"]),
                "x captured against eager": same(xs["captured"], xs["eager"]),
                "x captured again against captured": same(xs["captured again"], xs["captured"])}

    out = {}

    def measure():
        """Every section; the graphs it captures die with its locals."""
        _build.build_all([_build.SWELL_SRC])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)  # the profiler's one-off start-up
            torch.cuda.synchronize()
        note("the CG system")
        host = _spd_fem(args.cg_rows, np.float64)[3]
        spd = host.to(dev)
        b = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, spd.rows)).to(dev)
        mesh = make_mesh(world)
        group = mesh.get_group()
        reduce = all_reduced_sum(mesh)
        dsp = build_dist_swell(spd, world, mesh=mesh)
        L = dsp.rows_local
        part = shard_partitioned(partition_rows(host, world, balance=False), mesh)
        halo = halo_feasible(part, mesh, padded=True)
        sp, _ = (dist_spmv_halo_fn if halo else dist_spmv_fn)(mesh, part, padded=True)
        lr = part.local_rows
        b_pad = pad_vector(part, b.cpu())[rank * lr: (rank + 1) * lr].to(dev).contiguous()
        bnorm = float(b.norm())

        def gather(v):
            return sp(part.values, part.col_idx_padded, part.row_ids, v)

        loops = [("cg swell", dist_swell_spmv_fn(dsp, mesh), reduce,
                  pad_global(dsp, b)[rank * L: (rank + 1) * L].contiguous()),
                 ("cg gather", gather, reduce, b_pad)]
        if world == 1:
            whole = swell.get_swell_plan(spd)
            loops.append(("cg single", lambda v: swell.swell_ax(whole, v), None, b))
        loops.append(("cg gather, deterministic", gather, reduce, b_pad))

        saved = cg.CG_EAGER_ITERS
        for label in ("solve swell", "solve gather") if "solves" in sections else ():
            got = {}
            for key, eager in (("eager", 10 ** 9), ("eager again", 10 ** 9), ("captured", 0),
                               ("captured again", 0)):
                note(f"{label}, {key}")
                cg.CG_EAGER_ITERS = eager
                dist.barrier(group=group)
                torch.cuda.synchronize()
                t = time.perf_counter()
                if label == "solve swell":
                    res = dist_swell_cg_solve(spd, b, mesh, tol=1e-8, max_iters=400)[0]
                else:
                    res = cg.dist_cg_solve(part, pad_vector(part, b.cpu()), mesh, tol=1e-8,
                                           max_iters=400)
                torch.cuda.synchronize()
                got[key] = (time.perf_counter() - t, res)
            cg.CG_EAGER_ITERS = saved
            rec = {k: {"s": s, "iters": r.iters, "residual / |b|": float(r.residual_norm) / bnorm}
                   for k, (s, r) in got.items()}
            rec.update(compare({k: r.x for k, (_, r) in got.items()}))
            keep(label, rec)

        for label, matvec, dt, bb in loops if "cg" in sections else ():
            note(label)
            torch.use_deterministic_algorithms(label.endswith("deterministic"), warn_only=True)
            blocks = cg.CGBlocks(matvec, None, bb, reduce=dt, eager_iters=0)

            def trips(k, captured, matvec=matvec, dt=dt, bb=bb, blocks=blocks, aligned=True):
                if aligned:
                    dist.barrier(group=group)
                t = time.perf_counter()
                if captured:
                    res = blocks.solve(bb, torch.zeros_like(bb), 0.0, k)
                else:
                    res = cg._cg_loop(matvec, None, bb, torch.zeros_like(bb), 0.0, k, dt)
                torch.cuda.synchronize()
                return time.perf_counter() - t, res

            rec = {"halo": halo if label.startswith("cg gather") else dsp.halo_ok}
            xs = {}
            for captured in (False, True):
                key = "captured" if captured else "eager"
                trips(5 + n, captured)  # captures every graph size the timed loops replay
                trips(5, captured)
                lo, hi = trips(5, captured)[0], trips(5 + n, captured)
                again = trips(5 + n, captured)[1]
                rec[f"{key} us"] = (hi[0] - lo) / n * 1e6
                xs[key], xs[f"{key} again"] = hi[1].x, again.x
                rec[f"{key} residual / |b|"] = [float(r.residual_norm) / bnorm
                                                for r in (hi[1], again)]
                rec[key] = split(lambda c=captured: trips(n, c, aligned=False), n, group,
                                 rec[f"{key} us"])
            rec.update(compare(xs))
            keep(label, rec)
        torch.use_deterministic_algorithms(False)

        for d in (c for c in (1, 2, 4) if c <= world and "steps" in sections):
            note(f"step D={d}")
            csr = banded_csr(d * args.rows_per_device, bandwidth=17, seed=11)
            mesh = make_mesh(d)  # every rank joins the sub-group's creation
            if rank < d:
                group = mesh.get_group()
                dsp = build_dist_swell(csr, d, mesh=mesh)
                step = _renormalised(dist_swell_spmv_fn(dsp, mesh), group)
                L = dsp.rows_local
                x = pad_global(dsp, torch.ones(csr.cols, dtype=torch.float64))
                x = x[rank * L: (rank + 1) * L].to(dev).contiguous()
                loop = graphs.Loop(step, x, unroll=n)
                loop.run(x, n)  # captured here

                def eager_chain(x=x, step=step):
                    v = x
                    for _ in range(n):
                        v = step(v)
                    return v

                rec = {"eager us": eager_us(step, x, group),
                       "captured us": _loop_us(step, x, n, dev, group),
                       "captured against eager": same(loop.run(x, n), eager_chain()),
                       "halo": dsp.halo_ok}
                rec["eager"] = split(eager_chain, n, group, rec["eager us"])
                rec["captured"] = split(lambda: loop.run(x, n), n, group, rec["captured us"])
                keep(f"step D={d}", rec)
            dist.barrier()

        if args.capture_modes and world == 1:  # a failed capture must not strand a peer
            x1 = torch.ones(1 << 16, dtype=torch.float64, device=dev)

            def reduced(v):
                s = v.sum()
                dist.all_reduce(s, group=group)
                return v * (1.0 / s.clamp(min=1e-30)) * v.numel()

            modes = {}
            for mode in ("global", "thread_local"):
                graphs.CAPTURE_MODE = mode
                fails, first = 0, None
                for _ in range(args.capture_modes):
                    for _ in range(8):  # eager collectives for the watchdog to poll
                        reduced(x1)
                    try:
                        graphs.Loop(reduced, x1, unroll=2).run(x1, 4)
                        torch.cuda.synchronize()
                    except Exception as e:  # noqa: BLE001  (counted and reported)
                        fails += 1
                        first = first or f"{type(e).__name__}: {str(e)[:300]}"
                modes[mode] = {"captures": args.capture_modes, "failed": fails, "first error": first}
            graphs.CAPTURE_MODE = "thread_local"
            keep("capture modes", modes)

    try:
        measure()
        # NCCL's communicators go after the graphs that captured their
        # collectives: with such graphs alive the end of a four-card run did
        # not return (utils/graphs.py)
        gc.collect()
        torch.cuda.synchronize()
        note("the records")
        ranks = [None] * world
        dist.all_gather_object(ranks, out)
    finally:
        note("leaving the group")
        shutdown_distributed()
        note("left")
        if td is not None:
            shutil.rmtree(td, ignore_errors=True)
    if rank == 0:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(json.dumps({"world size": world, "rows per device": args.rows_per_device,
                          "cg rows": args.cg_rows, "n": n, "per rank": ranks,
                          "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                          "torch": torch.__version__,
                          "cards": card.strip().splitlines()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
