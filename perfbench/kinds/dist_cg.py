"""Repeated distributed conjugate-gradient solves: one operator row-partitioned
over ``ranks`` processes, one card each, as an HPCG or FEM deployment solves it
for right-hand side after right-hand side.

The run's own process is rank 0, on its card (``cuda:0``).  ``Program``
starts ranks 1 .. ranks-1 (card r for rank r) as processes of their own,
joined with rank 0 in one group through the port's
``parallel.multihost.init_distributed``; each loads the configuration's
matrix from ``perfbench/.cache``, which rank 0 wrote before it started them,
and follows rank 0.  A request is one ``parallel.dist_swell.dist_swell_cg_solve``
on every rank: rank 0 broadcasts (seed, request) and each rank draws the
global b of that pair on its own card (``inputs.Draw``), unpreconditioned,
from x0 = 0; the call returns when the solve has, its iteration count read on
the host.  A solution's blocks stay on their ranks, and every rank decides
alone, from the broadcast (seed, request), which it keeps: the window's rule
(``inputs.kept`` with the mix's ``check_every``) and each seed's latest
request, so the window's last answer too.  An answer's x is gathered to rank
0 when first read, and at ``close`` for every block still held; a gathered
block leaves its ranks.  ``close`` then stops the followers, leaves the group
(``shutdown_distributed``) and joins them, before the check.

The deployment is served once set up: the kind refuses, when it is loaded, a
program whose distributed solve rebuilds its plan and captures at every call
(no public ``models.cg.clear_dist_solver_cache``, which a program that keeps
its distributed solvers needs before it leaves the group), since every
request would then measure the global plan's load on every rank instead of
the solve.

Traffic keys: ``tol``, ``max_iters``, ``check_every``, ``x_checked``,
``trace_requests``, ``limits`` (``residual_over_tol``, ``x_gap``).  The
configuration gives ``ranks``.  ``check`` and ``end_to_end`` are
``kinds/cg.py``'s, on a copy of that module whose reference preconditioner is
the identity.
"""

from __future__ import annotations

import importlib
import os
import shutil
import sys
import tempfile
import threading
import time

import torch

from perfbench import inputs, peaks, reference, run

UNIT = "cg_iter"

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))

# kinds/cg.py's check and end_to_end, on a copy whose reference preconditioner is M = I
_cg = run.load(os.path.join(_HERE, "cg.py"), "perfbench_kind_dist_cg_base")
_cg.reference_precond = lambda cell, op, dtype: _identity
check = _cg.check
end_to_end = _cg.end_to_end

try:
    from spmv_acc_tpu_torch.models.cg import clear_dist_solver_cache  # noqa: F401
except ImportError as e:
    raise ImportError("dist_cg needs dist_swell_cg_solve to keep its solver across calls "
                      "(spmv_acc_tpu_torch.models.cg.clear_dist_solver_cache): this program "
                      "loads the global plan on every rank at every solve") from e

SOLVE, GATHER, STOP = 1, 2, 0  # a command: [op, seed, request]
_JOIN_S = 60.0


def _identity(r):
    return r


def draw_b(draw, seed: int, i: int, n: int) -> torch.Tensor:
    """The global b of request (seed, i): what every rank draws."""
    return draw.vector(seed, i, n)


def _command(device) -> torch.Tensor:
    return torch.empty(3, dtype=torch.int64, device=device)


class _Rank:
    """What every rank holds: the group, the operator on the host, the solve,
    and its blocks of the answers kept, by (seed, request): those the
    window's rule keeps, and each seed's latest."""

    def __init__(self, cell_cfg, traffic, arrays):
        from spmv_acc_tpu_torch import CSR
        from spmv_acc_tpu_torch.parallel.dist_spmv import make_mesh

        self.traffic = traffic
        self.mesh = make_mesh(cell_cfg["ranks"])
        self.group = self.mesh.get_group()
        self.csr = CSR.from_numpy(*arrays)  # on the host: each rank's shard goes to its card
        self.rows = arrays[3][0]
        self.blocks = {}
        self.latest = {}  # seed -> its latest request

    def solve(self, seed: int, i: int, b):
        """Solve for ``b``, keep this rank's block under (seed, i), and drop
        the seed's previous latest unless the window's rule keeps it."""
        from spmv_acc_tpu_torch.parallel.dist_swell import dist_swell_cg_solve

        res, _ = dist_swell_cg_solve(self.csr, b, self.mesh, tol=self.traffic["tol"],
                                     max_iters=self.traffic["max_iters"])
        last = self.latest.get(seed)
        if last is not None and not inputs.kept(seed, last, self.traffic["check_every"]):
            self.blocks.pop((seed, last), None)
        self.latest[seed] = i
        self.blocks[seed, i] = res.x
        return res.iters

    def gather(self, key) -> torch.Tensor:
        """The global x of ``key`` on rank 0 (every rank calls it); the
        block leaves every rank."""
        from spmv_acc_tpu_torch.parallel.launch import gather_padded

        return gather_padded(self.blocks.pop(key), self.mesh)[: self.rows]


def _join(rank, world, init, device_type):
    from spmv_acc_tpu_torch.parallel.multihost import init_distributed

    init_distributed(coordinator_address=init, num_processes=world, process_id=rank,
                     local_device_ids=[rank] if device_type == "cuda" else None,
                     device=device_type)
    return torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")


def _watch_parent(ppid: int) -> None:
    """Leave at once when rank 0's process is gone: a collective would wait
    for it forever."""
    while True:
        time.sleep(1.0)
        if os.getppid() != ppid:
            os._exit(3)


def follow(rank, world, init, device_type, root, cfg, traffic, draw=None) -> None:
    """Rank ``rank``'s loop: join the group, load the matrix that rank 0
    wrote, then carry out rank 0's commands until it says stop.  ``draw``
    (None: ``draw_b``) is how this rank draws b, a function importable by
    its module's name."""
    threading.Thread(target=_watch_parent, args=(os.getppid(),), daemon=True).start()
    from spmv_acc_tpu_torch.parallel.multihost import shutdown_distributed

    device = _join(rank, world, init, device_type)
    try:
        matrix = run.load(os.path.join(root, "perfbench", "matrices", f"{cfg['generator']}.py"),
                          f"perfbench_matrix_{cfg['generator']}")
        me = _Rank(cfg, traffic, run.matrix_arrays(root, cfg, matrix))
        gen = inputs.Draw(device)
        draw = draw or draw_b
        cmd = _command(device)
        while True:
            torch.distributed.broadcast(cmd, src=0, group=me.group)
            op, seed, i = cmd.tolist()
            if op == SOLVE:
                me.solve(seed, i, draw(gen, seed, i, me.rows))
            elif op == GATHER:
                me.gather((seed, i))
            elif op == STOP:
                break
            else:
                raise RuntimeError(f"rank {rank}: unknown command {op}")
    finally:
        me = None
        shutdown_distributed()


class Answer(dict):
    """A solve's answer on rank 0: ``iters`` at once, ``x`` (every rank's
    block, gathered on rank 0) when first read."""

    def __init__(self, program, key, iters: int):
        super().__init__(iters=iters)
        self.program = program
        self.key = key

    def __missing__(self, key):
        if key != "x":
            raise KeyError(key)
        x = self["x"] = self.program.gather(self.key)
        return x


class Program:
    """Rank 0 of ``dist_swell_cg_solve`` over the configuration's ``ranks``.
    ``follower_draw`` (None: ``draw_b``) is how the other ranks draw b."""

    def __init__(self, cell, follower_draw=None):
        world = int(cell.cfg["ranks"])
        dev = cell.device
        if dev.type == "cuda" and torch.cuda.device_count() < world:
            raise RuntimeError(f"{world} ranks need {world} CUDA cards, "
                               f"{torch.cuda.device_count()} visible")
        self.cell = cell
        self.me = None
        self.procs = []
        self.answers = {}  # (seed, request) -> Answer, while its blocks are held
        self.stopping = False
        cache = os.path.join(_ROOT, "perfbench", ".cache")
        os.makedirs(cache, exist_ok=True)
        self.rdzv = tempfile.mkdtemp(prefix="rendezvous_", dir=cache)
        init = "file://" + os.path.join(self.rdzv, "store")
        # the followers' target by its real module name: a spawned process
        # cannot import this file under the name the harness loads it as
        real = importlib.import_module("perfbench.kinds.dist_cg")
        ctx = torch.multiprocessing.get_context("spawn")
        for rank in range(1, world):
            p = ctx.Process(target=real.follow, daemon=True,
                            args=(rank, world, init, dev.type, _ROOT, cell.cfg, cell.traffic,
                                  follower_draw))
            p.start()
            self.procs.append(p)
        print(f"dist_cg: followers {[p.pid for p in self.procs]}", file=sys.stderr)
        threading.Thread(target=self._watch, daemon=True).start()
        device = _join(0, world, init, dev.type)
        self.me = _Rank(cell.cfg, cell.traffic, cell.arrays)
        self.cmd = _command(device)

    def _watch(self):
        """A follower that exits before it is told to stop would leave rank 0
        waiting in a collective forever: end the run instead."""
        while not self.stopping:
            for p in self.procs:
                if p.exitcode is not None and not self.stopping:
                    print(f"dist_cg: follower {p.pid} exited with code {p.exitcode} before "
                          f"the run ended", file=sys.stderr, flush=True)
                    for q in self.procs:
                        q.kill()
                    os._exit(1)
            time.sleep(0.5)

    def _send(self, op: int, a: int = 0, b: int = 0) -> None:
        self.cmd.copy_(torch.tensor([op, a, b], dtype=torch.int64))
        torch.distributed.broadcast(self.cmd, src=0, group=self.me.group)

    def request(self, seed: int, i: int):
        self._send(SOLVE, seed, i)
        me = self.me
        iters = me.solve(seed, i, draw_b(self.cell.draw, seed, i, me.rows))
        ans = self.answers[seed, i] = Answer(self, (seed, i), iters)
        for key in [k for k in self.answers if k not in me.blocks]:
            del self.answers[key]  # its blocks were dropped
        return iters, ans

    def gather(self, key) -> torch.Tensor:
        if self.me is None:
            raise RuntimeError("the program is closed: its answers' blocks are gone")
        if key not in self.me.blocks:
            raise RuntimeError(f"request {key} was not kept: the ranks keep the blocks that "
                               f"inputs.kept keeps with the mix's check_every, and each "
                               f"seed's latest")
        self._send(GATHER, *key)
        self.answers.pop(key, None)
        return self.me.gather(key)

    def sync(self):
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def close(self):
        from spmv_acc_tpu_torch.parallel.multihost import shutdown_distributed

        if self.me is None:
            return
        try:
            held = list(self.answers.values())
            print(f"dist_cg: closing with {len(held)} blocks held on each rank",
                  file=sys.stderr)
            for ans in held:  # while every rank holds its block
                ans["x"] = self.gather(ans.key)
            self.stopping = True
            self._send(STOP)
        finally:
            self.stopping = True
            self.me = None
            shutdown_distributed()
            for p in self.procs:
                p.join(timeout=_JOIN_S)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            print(f"dist_cg: followers joined, exit codes {[p.exitcode for p in self.procs]}",
                  file=sys.stderr)
            shutil.rmtree(self.rdzv, ignore_errors=True)


class Control:
    """The reference's CG (M = I) put in the program's place, in float32, on
    rank 0's card alone."""

    def __init__(self, cell):
        self.cell = cell
        self.op = cell.matrix.Operator(cell.cfg, cell.arrays, cell.device, torch.float32)

    def request(self, seed: int, i: int):
        t = self.cell.traffic
        b = draw_b(self.cell.draw, seed, i, self.op.shape[0])
        x, it = reference.pcg(self.op, _identity, b, t["tol"], t["max_iters"])
        return it, {"x": x.double(), "iters": it}

    def sync(self):
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def close(self):
        self.op = None


def unit_bytes(cell) -> int:
    """One iteration's bytes on rank 0: its shard's SpMV by the reference's
    model (rank 0 owns the first m / ranks rows, as the port cuts them where
    128 divides the slab, as 1,124,864 = 8,788 x 128 does), the halo it needs
    from its one neighbour, the nx x ny plane next to its slab that the
    27-point stencil reads (the program receives the neighbour's whole
    block: ``halo_mb.solve`` shows that surplus), and the eight vector passes
    of CG's update."""
    rp, _, _, (m, _) = cell.arrays
    cfg = cell.cfg
    rows = m // int(cfg["ranks"])
    halo = 8 * cfg["nx"] * cfg["ny"] if int(cfg["ranks"]) > 1 else 0
    return peaks.spmv_bytes(rows, int(rp[rows])) + halo + 8 * 8 * rows
