"""A shifted power iteration: the chained SpMV loop of eigen-solvers.

A request is ``steps`` steps of s = A x + sigma x, x = s / sqrt(mean(s^2))
from a start vector drawn from (seed, request); the host then reads the last
step's sqrt(mean(s^2)), the eigenvalue estimate.  The program's step is
``dispatch.make_spmv_fn(csr, 1.0, sigma, strategy)`` on (x, x) and the
normalisation, and the ``steps`` run as one device program through the
port's ``utils.graphs.Loop`` (replays of a captured CUDA graph on the card).

Traffic keys: ``steps``, ``sigma``, ``strategy``, ``check_every`` (one
answer in that many is kept for the check), ``trace_requests``, ``limits``
(``x_err``, ``lam_err``).
"""

from __future__ import annotations

import torch

from perfbench import peaks, reference

UNIT = "spmv_step"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The port's power iteration on the cell's matrix."""

    def __init__(self, cell):
        from spmv_acc_tpu_torch import CSR
        from spmv_acc_tpu_torch.dispatch import make_spmv_fn
        from spmv_acc_tpu_torch.utils.graphs import Loop

        rp, ci, v, shape = cell.arrays
        self.cell = cell
        self.steps = cell.traffic["steps"]
        self.csr = CSR.from_numpy(rp, ci, v, shape, device=cell.device)
        spmv, self.strategy = make_spmv_fn(self.csr, 1.0, cell.traffic["sigma"],
                                           cell.traffic["strategy"])

        def step(carry):
            s = spmv(carry[0], carry[0])
            ms = torch.mean(s * s)
            return s * torch.rsqrt(ms), torch.sqrt(ms)

        self.zero = torch.zeros((), dtype=torch.float64, device=cell.device)
        self.loop = Loop(step, (torch.zeros(shape[1], dtype=torch.float64, device=cell.device),
                                self.zero))

    def request(self, seed: int, i: int):
        x0 = self.cell.draw.vector(seed, i, self.csr.cols)
        x, lam = self.loop.run((x0, self.zero), self.steps)
        return self.steps, {"x": x, "lam": float(lam)}

    def sync(self):
        _sync(self.cell.device)

    def close(self):
        self.loop = self.csr = None


class Control:
    """The reference put in the program's place, in float32."""

    def __init__(self, cell):
        self.cell = cell
        self.op = cell.matrix.Operator(cell.cfg, cell.arrays, cell.device, torch.float32)

    def request(self, seed: int, i: int):
        t = self.cell.traffic
        x0 = self.cell.draw.vector(seed, i, self.op.shape[1])
        x, lam = reference.power(self.op, x0, t["sigma"], t["steps"])
        return t["steps"], {"x": x.double(), "lam": float(lam)}

    def sync(self):
        _sync(self.cell.device)

    def close(self):
        self.op = None


def unit_bytes(cell) -> int:
    """One step's bytes: the reference's model of one SpMV (the
    normalisation's vector passes are not counted)."""
    rp, _, _, (m, _) = cell.arrays
    return peaks.spmv_bytes(m, int(rp[-1]))


def end_to_end(win) -> dict:
    return {"spmv_us": win.wall * 1e6 / sum(win.units)}


def check(cell, seed: int, win):
    """Each kept answer against the reference's steps from the same start:
    the largest |x - x_ref| over max |x_ref|, and the relative error of the
    estimate.  Returns (numbers with limits, answers failed, answers checked)."""
    t, lim = cell.traffic, cell.traffic["limits"]
    op = cell.matrix.Operator(cell.cfg, cell.arrays, cell.device, torch.float64)
    x_err = lam_err = 0.0
    failed = 0
    for i, ans in sorted(win.kept.items()):
        x0 = cell.draw.vector(seed, i, op.shape[1])
        xr, lr = reference.power(op, x0, t["sigma"], t["steps"])
        xe = float((ans["x"].to(xr.device) - xr).abs().max() / xr.abs().max())
        le = abs(ans["lam"] - float(lr)) / abs(float(lr))
        xe = xe if xe == xe else float("inf")  # NaN fails
        le = le if le == le else float("inf")
        failed += xe > lim["x_err"] or le > lim["lam_err"]
        x_err, lam_err = max(x_err, xe), max(lam_err, le)
    return [("x_err", x_err, lim["x_err"]), ("lam_err", lam_err, lim["lam_err"])], failed, len(
        win.kept)
