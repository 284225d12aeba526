"""The plain reference algorithms the program's answers are judged by.

Plain PyTorch on an operator and a preconditioner from ``perfbench/matrices``;
nothing here imports the program.  Each follows the textbook algorithm the
configuration states, in the ``dtype`` it is given: float64 for the judge,
float32 for the control (the reference put in the program's place one
precision below the configuration's).
"""

from __future__ import annotations

import torch


def power(op, x0: torch.Tensor, sigma: float, steps: int):
    """``steps`` steps of s = A x + sigma x, x = s / sqrt(mean(s^2)), in
    ``op.dtype``: (x, sqrt(mean(s^2)) of the last step)."""
    x = x0.to(op.dtype)
    lam = None
    for _ in range(steps):
        s = op(x) + sigma * x
        lam = torch.sqrt(torch.mean(s * s))
        x = s / lam
    return x, lam


def pcg(op, precond, b: torch.Tensor, tol: float, max_iters: int):
    """Preconditioned CG from x = 0, in ``op.dtype``: stops before an
    iteration when r.r <= tol^2 max(b.b, 1e-300), or after ``max_iters``.
    Returns (x, iterations)."""
    b = b.to(op.dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    z = precond(r)
    p = z.clone()
    rz = torch.dot(r, z)
    tol2 = tol * tol * max(float(torch.dot(b, b)), 1e-300)
    it = 0
    while it < max_iters and float(torch.dot(r, r)) > tol2:
        ap = op(p)
        alpha = rz / torch.dot(p, ap)
        x += alpha * p
        r -= alpha * ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x, it


def relative_residual(op, x: torch.Tensor, b: torch.Tensor) -> float:
    """||b - A x|| / ||b|| in ``op.dtype``."""
    b = b.to(op.dtype)
    return float(torch.linalg.vector_norm(b - op(x)) / torch.linalg.vector_norm(b))
