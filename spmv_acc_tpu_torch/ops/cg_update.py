"""F-2, the CG iteration's vector work around the matvec.

The JAX package jits its CG loop (``spmv_acc_tpu/models/cg.py::_cg_loop``,
body :74-84, cond :70-72) and XLA fuses the body's vector work into a
handful of kernels: the ``p·Ap`` reduction, one fused x/r/z update with its
dot products, the p update.  The port's counterpart is the hand-written
kernel of ``csrc/cg_update.cu`` in two forms.

The fused single-device form, one cooperative launch for the whole
iteration where M is the identity or Jacobi, two around any other M:

* :func:`cg_step` -- ``sums[0] = p·Ap``, ``alpha = rz / sums[0]``,
  ``x += alpha p``, ``r -= alpha Ap``, ``sums[1:] = [r·z, r·r]`` of the new r
  with ``z = inv * r`` (Jacobi) or ``z = r``, ``p = z + (sums[1] / rz) p``,
  then ``rz = sums[1]``, ``rr = sums[2]``, ``it += 1``;
* :func:`cg_dot_xr` -- its first half for the general form: ``sums[0] =
  p·Ap``, x and r, ``sums[2] = r·r``;
* :func:`cg_dot_p` -- its second half, given ``z = M(r)``: ``sums[1] = r·z``,
  p, then rz, rr and it.

The three-phase form, for the distributed solve, whose all-reduces of the
sums sit between the phases (``sums[:1]`` after ``cg_dot``, ``sums[1:]``
before ``cg_p``):

* :func:`cg_dot` -- ``sums[slot] = a·c`` (``p·Ap``; ``r·z`` in the general
  form);
* :func:`cg_xr` -- ``alpha = rz / sums[0]``, ``x += alpha p``, ``r -= alpha Ap``
  in place, and ``sums[1] = r·z``, ``sums[2] = r·r`` of the new r, with
  ``z = inv * r`` formed in registers (Jacobi) or ``z = r`` (identity); in the
  general form (``with_rz=False``) only ``sums[2]``;
* :func:`cg_p` -- ``beta = sums[1] / rz``, ``p = z + beta p`` in place (z
  formed again, or read in the general form), then ``rz = sums[1]``,
  ``rr = sums[2]``, ``it += 1``.

The carry is ``(x, r, p, rz, rr, it)``; z is a function of r and is not
carried.  With ``tol2`` and ``max_iters`` (0-d tensors) a call is masked:
``active = rr > tol2 and it < max_iters``, read from the carry as the
previous iteration left it, and where it is false the call writes nothing
to x, r, p, rz, rr, it or ``sums`` (``cg_dot`` alone is never masked).  A call
reads no device value on the host.  ``Work`` holds one solve's scratch: the
three sums and on the card the kernels' block partials and the phases'
ticket.

Each entry launches the kernel for CUDA tensors and runs its plain PyTorch
version (``*_plain``: ``torch.dot`` and the eager expressions, masked with
``torch.where``; the fused ones are the phases' in sequence) for CPU
tensors; there is no fallback from one to the other.  The kernel rounds each
elementwise operation as the plain version does (no contracted FMA), so
given the same sums x, r and p are the same bits; the dot products are
summed in another order (block partials folded in a fixed order, so two
launches give the same bits).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

__all__ = ["LAUNCHES", "PAP", "RZ", "RR", "Work", "cg_step", "cg_step_plain", "cg_dot_xr",
           "cg_dot_xr_plain", "cg_dot_p", "cg_dot_p_plain", "cg_dot", "cg_dot_plain", "cg_xr",
           "cg_xr_plain", "cg_p", "cg_p_plain", "eager_step"]

# Launches in this process by (dtype, entry): ("f64" | "f32", "step" | "dot_xr" |
# "dot_p" | "dot" | "xr" | "p").
# Only the launch sites add to it (and a captured graph's replays,
# utils/graphs.py); set to 0 with ``.clear()`` to count a run.
LAUNCHES: collections.Counter = collections.Counter()

PAP, RZ, RR = 0, 1, 2  # the slots of Work.sums
_DTYPES = {torch.float64: "f64", torch.float32: "f32"}
_MAX_BLOCKS = 2048  # csrc/cg_update.cu kMaxBlocks: the partials of one sum
# the kernels' z: r itself, inv * r, or read (csrc/cg_update.cu Form)
_IDENTITY, _JACOBI, _READ = 0, 1, 2


class Work:
    """The scratch of one CG solve on the device of ``like``: ``sums``
    ``[p·Ap, r·z, r·r]`` in its dtype, and on the card the block partials (three
    sums' worth) and the integer ticket the last block of a phase takes."""

    def __init__(self, like: torch.Tensor):
        self.sums = torch.zeros(3, dtype=like.dtype, device=like.device)
        self.partials = self.ticket = None
        if like.device.type == "cuda":
            self.partials = torch.empty(3 * _MAX_BLOCKS, dtype=like.dtype, device=like.device)
            self.ticket = torch.zeros(1, dtype=torch.int32, device=like.device)


def _active(rr, it, tol2, max_iters):
    """The stop test on the device (None: unmasked)."""
    if tol2 is None:
        return None
    return (rr > tol2) & (it < max_iters)


def _masked(act, new, old):
    """``old`` set to ``new`` where the iteration is active (always if unmasked)."""
    old.copy_(new if act is None else torch.where(act, new, old))


def cg_dot_plain(a, c, work: Work, slot: int) -> None:
    work.sums[slot] = torch.dot(a, c)


def cg_xr_plain(carry, ap, work: Work, inv=None, with_rz=True, tol2=None,
                max_iters=None) -> None:
    x, r, p, rz, rr, it = carry
    act = _active(rr, it, tol2, max_iters)
    alpha = rz / work.sums[PAP]
    r_new = r - alpha * ap
    rr_new = torch.dot(r_new, r_new)
    if with_rz:
        rz_new = rr_new if inv is None else torch.dot(r_new, inv * r_new)
        _masked(act, torch.stack([rz_new, rr_new]), work.sums[RZ:])
    else:
        _masked(act, rr_new, work.sums[RR])
    _masked(act, x + alpha * p, x)
    _masked(act, r_new, r)


def cg_p_plain(carry, work: Work, inv=None, z=None, tol2=None, max_iters=None) -> None:
    x, r, p, rz, rr, it = carry
    act = _active(rr, it, tol2, max_iters)
    if z is None:
        z = r if inv is None else inv * r
    _masked(act, z + (work.sums[RZ] / rz) * p, p)
    _masked(act, work.sums[RZ], rz)
    _masked(act, work.sums[RR], rr)
    it.add_(1 if act is None else act.to(it.dtype))


def cg_step_plain(carry, ap, work: Work, inv=None, tol2=None, max_iters=None) -> None:
    """:func:`cg_dot_plain` (p·Ap, masked as the kernel masks it),
    :func:`cg_xr_plain` and :func:`cg_p_plain` in sequence."""
    x, r, p, rz, rr, it = carry
    _masked(_active(rr, it, tol2, max_iters), torch.dot(p, ap), work.sums[PAP])
    cg_xr_plain(carry, ap, work, inv, True, tol2, max_iters)
    cg_p_plain(carry, work, inv, None, tol2, max_iters)


def cg_dot_xr_plain(carry, ap, work: Work, tol2=None, max_iters=None) -> None:
    """:func:`cg_dot_plain` (p·Ap, masked) and :func:`cg_xr_plain` without r·z."""
    x, r, p, rz, rr, it = carry
    _masked(_active(rr, it, tol2, max_iters), torch.dot(p, ap), work.sums[PAP])
    cg_xr_plain(carry, ap, work, None, False, tol2, max_iters)


def cg_dot_p_plain(carry, z, work: Work, tol2=None, max_iters=None) -> None:
    """:func:`cg_dot_plain` (r·z, masked) and :func:`cg_p_plain` with z read."""
    x, r, p, rz, rr, it = carry
    _masked(_active(rr, it, tol2, max_iters), torch.dot(r, z), work.sums[RZ])
    cg_p_plain(carry, work, None, z, tol2, max_iters)


def eager_step(carry, ap, M, tol2=None, max_iters=None):
    """The iteration's vector work as the CG loop ran it before F-2: eager
    PyTorch ops (three dots, the axpys, ``z = M(r)``, a ``torch.where`` for
    each carried value), the matvec's output ``ap`` given; returns the new
    carry and leaves ``carry`` as it was.  The reference F-2's phases are held
    to in the tests and timed beside on the card."""
    x, r, p, rz, rr, it = carry
    active = (torch.ones((), dtype=torch.bool, device=x.device) if tol2 is None
              else (rr > tol2) & (it < max_iters))
    alpha = rz / torch.dot(p, ap)
    x_new = x + alpha * p
    r_new = r - alpha * ap
    z_new = M(r_new)
    rz_new = torch.dot(r_new, z_new)
    p_new = z_new + (rz_new / rz) * p
    return (torch.where(active, x_new, x), torch.where(active, r_new, r),
            torch.where(active, p_new, p), torch.where(active, rz_new, rz),
            torch.where(active, torch.dot(r_new, r_new), rr), it + active)


def _check(phase, vectors, scalars, tol2, max_iters, work) -> torch.Tensor:
    """Every vector one contiguous 1-D float64/float32 tensor on one device
    and of one length, the scalars and the mask one element each; returns
    the first vector."""
    first = vectors[0][1]
    for name, t in vectors + scalars + [("tol2", tol2), ("max_iters", max_iters),
                                        ("work.sums", work.sums)]:
        if t is None and name in ("tol2", "max_iters"):
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{phase}: {name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != first.device:
            raise ValueError(f"{phase}: {name} is on {t.device}, {vectors[0][0]} on "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{phase}: {name} must be contiguous")
        want = torch.int64 if name in ("it", "max_iters") else first.dtype
        if t.dtype != want:
            raise ValueError(f"{phase}: {name} is {t.dtype}, not {want}")
    if first.dtype not in _DTYPES:
        raise ValueError(f"{phase} runs float64 and float32, not {first.dtype}")
    for name, t in vectors:
        if t.dim() != 1 or t.numel() != first.numel() or t.numel() == 0:
            raise ValueError(f"{phase}: {name} has shape {tuple(t.shape)}, "
                             f"{vectors[0][0]} {tuple(first.shape)} (non-empty 1-D)")
    for name, t in scalars + [("tol2", tol2), ("max_iters", max_iters)]:
        if t is not None and t.numel() != 1:
            raise ValueError(f"{phase}: {name} must hold one element, got {tuple(t.shape)}")
    if (tol2 is None) != (max_iters is None):
        raise ValueError(f"{phase}: give tol2 and max_iters together (the mask) or neither")
    if work.sums.shape != (3,):
        raise ValueError(f"{phase}: work.sums must hold 3 elements")
    return first


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(phase: str, first: torch.Tensor, entry: str, *args) -> None:
    from ._build import CG_UPDATE_SRC, load_lib

    lib = load_lib(CG_UPDATE_SRC)
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        rc = getattr(lib, entry)(int(first.dtype == torch.float64), *args,
                                 ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    LAUNCHES[(_DTYPES[first.dtype], phase)] += 1


def _device(phase: str, first: torch.Tensor) -> str:
    if first.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"{phase} has no kernel for device {first.device}")
    return first.device.type


def cg_dot(a: torch.Tensor, c: torch.Tensor, work: Work, slot: int) -> None:
    """``work.sums[slot] = a·c``.  Launches ``cg_dot`` of ``csrc/cg_update.cu``
    for CUDA tensors, runs :func:`cg_dot_plain` for CPU tensors."""
    first = _check("cg_dot", [("a", a), ("c", c)], [], None, None, work)
    if slot not in (PAP, RZ, RR):
        raise ValueError(f"cg_dot: slot must be 0, 1 or 2, got {slot!r}")
    if _device("cg_dot", first) == "cpu":
        return cg_dot_plain(a, c, work, slot)
    _launch("dot", first, "cg_dot", _ptr(a), _ptr(c), a.numel(),
            ctypes.c_void_p(work.sums.data_ptr() + slot * work.sums.element_size()),
            _ptr(work.partials), _ptr(work.ticket))


def cg_xr(carry, ap: torch.Tensor, work: Work, inv: Optional[torch.Tensor] = None,
          with_rz: bool = True, tol2=None, max_iters=None) -> None:
    """x += alpha p and r -= alpha Ap in place (``alpha = rz / sums[0]``), then
    ``sums[1:] = [r·z, r·r]`` of the new r with ``z = inv * r`` (``z = r``
    without ``inv``), or only ``sums[2]`` without ``with_rz`` (the general
    form, where z = M(r) comes after); masked by ``tol2`` and ``max_iters``
    (module docstring).  Launches ``cg_xr`` for CUDA tensors, runs
    :func:`cg_xr_plain` for CPU tensors."""
    x, r, p, rz, rr, it = carry
    vectors = [("x", x), ("r", r), ("p", p), ("ap", ap)] + ([] if inv is None else
                                                          [("inv", inv)])
    first = _check("cg_xr", vectors, [("rz", rz), ("rr", rr), ("it", it)], tol2, max_iters,
                   work)
    if inv is not None and not with_rz:
        raise ValueError("cg_xr: inv forms z = inv * r for r·z; it needs with_rz")
    if _device("cg_xr", first) == "cpu":
        return cg_xr_plain(carry, ap, work, inv, with_rz, tol2, max_iters)
    form = _READ if not with_rz else (_IDENTITY if inv is None else _JACOBI)
    _launch("xr", first, "cg_xr", form, _ptr(x), _ptr(r), _ptr(p), _ptr(ap), _ptr(inv),
            x.numel(), _ptr(rz), _ptr(rr), _ptr(it), _ptr(tol2), _ptr(max_iters),
            _ptr(work.sums), _ptr(work.partials), _ptr(work.ticket))


def cg_p(carry, work: Work, inv: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None,
         tol2=None, max_iters=None) -> None:
    """p = z + (sums[1] / rz) p in place, with ``z = inv * r``, ``z = r`` or the
    given ``z``; then rz = sums[1], rr = sums[2] and it += 1; masked by
    ``tol2`` and ``max_iters`` (module docstring).  Launches ``cg_p`` for CUDA
    tensors, runs :func:`cg_p_plain` for CPU tensors."""
    x, r, p, rz, rr, it = carry
    if inv is not None and z is not None:
        raise ValueError("cg_p: give inv (z = inv * r) or z, not both")
    vectors = [("p", p), ("r", r)] + [(n, t) for n, t in (("inv", inv), ("z", z))
                                      if t is not None]
    first = _check("cg_p", vectors, [("rz", rz), ("rr", rr), ("it", it)], tol2, max_iters,
                   work)
    if _device("cg_p", first) == "cpu":
        return cg_p_plain(carry, work, inv, z, tol2, max_iters)
    form = _READ if z is not None else (_IDENTITY if inv is None else _JACOBI)
    _launch("p", first, "cg_p", form, _ptr(p), _ptr(r), _ptr(z if z is not None else inv),
            p.numel(), _ptr(rz), _ptr(rr), _ptr(it), _ptr(tol2), _ptr(max_iters),
            _ptr(work.sums), _ptr(work.ticket))


def cg_step(carry, ap: torch.Tensor, work: Work, inv: Optional[torch.Tensor] = None, tol2=None,
            max_iters=None) -> None:
    """The whole iteration's vector work in place for M = I (``inv`` None) or
    Jacobi (``z = inv * r``): x, r, p and rz, rr, it, and ``sums`` as the
    phases leave them; masked by ``tol2`` and ``max_iters`` (module
    docstring).  Launches ``cg_step`` of ``csrc/cg_update.cu`` (one cooperative
    launch) for CUDA tensors, runs :func:`cg_step_plain` for CPU tensors."""
    x, r, p, rz, rr, it = carry
    vectors = [("x", x), ("r", r), ("p", p), ("ap", ap)] + ([] if inv is None else
                                                          [("inv", inv)])
    first = _check("cg_step", vectors, [("rz", rz), ("rr", rr), ("it", it)], tol2, max_iters,
                   work)
    if _device("cg_step", first) == "cpu":
        return cg_step_plain(carry, ap, work, inv, tol2, max_iters)
    _launch("step", first, "cg_step", _IDENTITY if inv is None else _JACOBI, _ptr(x), _ptr(r),
            _ptr(p), _ptr(ap), _ptr(inv), x.numel(), _ptr(rz), _ptr(rr), _ptr(it), _ptr(tol2),
            _ptr(max_iters), _ptr(work.sums), _ptr(work.partials))


def cg_dot_xr(carry, ap: torch.Tensor, work: Work, tol2=None, max_iters=None) -> None:
    """The general form's first half in place: ``sums[0] = p·Ap``, x += alpha
    p and r -= alpha Ap (``alpha = rz / sums[0]``), ``sums[2] = r·r`` of the
    new r; masked by ``tol2`` and ``max_iters``.  Launches ``cg_dot_xr`` (one
    cooperative launch) for CUDA tensors, runs :func:`cg_dot_xr_plain` for
    CPU tensors."""
    x, r, p, rz, rr, it = carry
    first = _check("cg_dot_xr", [("x", x), ("r", r), ("p", p), ("ap", ap)],
                   [("rz", rz), ("rr", rr), ("it", it)], tol2, max_iters, work)
    if _device("cg_dot_xr", first) == "cpu":
        return cg_dot_xr_plain(carry, ap, work, tol2, max_iters)
    _launch("dot_xr", first, "cg_dot_xr", _ptr(x), _ptr(r), _ptr(p), _ptr(ap), x.numel(),
            _ptr(rz), _ptr(rr), _ptr(it), _ptr(tol2), _ptr(max_iters), _ptr(work.sums),
            _ptr(work.partials))


def cg_dot_p(carry, z: torch.Tensor, work: Work, tol2=None, max_iters=None) -> None:
    """The general form's second half in place, given ``z = M(r)``:
    ``sums[1] = r·z``, p = z + (sums[1] / rz) p, then rz = sums[1], rr =
    sums[2] and it += 1; masked by ``tol2`` and ``max_iters``.  Launches
    ``cg_dot_p`` (one cooperative launch) for CUDA tensors, runs
    :func:`cg_dot_p_plain` for CPU tensors."""
    x, r, p, rz, rr, it = carry
    first = _check("cg_dot_p", [("p", p), ("r", r), ("z", z)], [("rz", rz), ("rr", rr),
                                                               ("it", it)], tol2, max_iters, work)
    if _device("cg_dot_p", first) == "cpu":
        return cg_dot_p_plain(carry, z, work, tol2, max_iters)
    _launch("dot_p", first, "cg_dot_p", _ptr(p), _ptr(r), _ptr(z), p.numel(), _ptr(rz),
            _ptr(rr), _ptr(it), _ptr(tol2), _ptr(max_iters), _ptr(work.sums), _ptr(work.partials))
