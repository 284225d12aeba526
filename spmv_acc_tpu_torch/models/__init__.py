"""Solvers driven by the SpMV kernels."""

from .cg import CGResult, cg_solve, jacobi_preconditioner

__all__ = ["CGResult", "cg_solve", "jacobi_preconditioner"]
