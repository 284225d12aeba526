"""F-2's fused single-device form (``ops/cg_update.py``: ``cg_step``,
``cg_dot_xr``, ``cg_dot_p``; one cooperative launch of ``csrc/cg_update.cu``
each on a card) on the CPU, where each runs its plain version: the plain
versions against the three phases in sequence, the routing of
``models.cg._step`` (fused where the sums stay on one device, the phases
where a ``reduce`` completes them over ranks), ``CGBlocks`` through the fused
form against ``_cg_loop`` and the JAX package's ``cg_solve``, the step with
host reads refused, and the argument checks.

Tolerances: the fused plain versions are the phases' operations in the same
order, so the carry is the same bits (and the sums, where the iteration is
active; masked off, the fused form writes no sum, where the phases' unmasked
``cg_dot`` does); ``CGBlocks`` equals ``_cg_loop`` bit for bit (the same
step); against JAX, which sums its dots in another order, iterations within
one and x within 1e-9 relative at tol 1e-10, at tol 0 (cut at
``max_iters``) the same count and x within 1e-9, as
``tests/test_torch_cg_update.py`` holds the phases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats.containers import CSR as RefCSR
from spmv_acc_tpu.formats.convert import csr_to_dense
from spmv_acc_tpu.models import cg as ref_cg
from spmv_acc_tpu.ops import trisolve as ref_tri
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.formats.generate import aniso_laplacian_csr
from spmv_acc_tpu_torch.models import cg
from spmv_acc_tpu_torch.ops import cg_update as cu
from spmv_acc_tpu_torch.ops import swell
from spmv_acc_tpu_torch.ops import trisolve as tri


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


def _carry(n, seed, dtype):
    """A random carry (x, r, p, rz, rr, it) with rr = r·r, Ap, a Jacobi
    vector and a z."""
    rng = np.random.default_rng(seed)
    x, r, p, ap, z = (torch.from_numpy(rng.uniform(-1, 1, n)).to(dtype) for _ in range(5))
    inv = torch.from_numpy(rng.uniform(0.5, 2.0, n)).to(dtype)
    rz = torch.tensor(rng.uniform(0.5, 2.0), dtype=dtype)
    return (x, r, p, rz, torch.dot(r, r), torch.tensor(5)), ap, inv, z


MASKS = {"unmasked": None, "active": 0.5, "masked off by tol2": 2.0,
         "masked off by max_iters": "max"}


def _mask(carry, name):
    how = MASKS[name]
    if how is None:
        return None, None
    return (carry[4] * (0.5 if how == "max" else how),
            torch.tensor(5 if how == "max" else 100))


def _copy(carry):
    return tuple(t.clone() for t in carry)


def _phases(form, carry, ap, inv, z, work, tol2, max_iters):
    """The three phases in sequence, as ``_step`` ran them on one device before
    the fused form."""
    cu.cg_dot(carry[2], ap, work, cu.PAP)
    if form == "general":
        cu.cg_xr(carry, ap, work, with_rz=False, tol2=tol2, max_iters=max_iters)
        cu.cg_dot(carry[1], z, work, cu.RZ)
        cu.cg_p(carry, work, z=z, tol2=tol2, max_iters=max_iters)
    else:
        cu.cg_xr(carry, ap, work, inv=inv, tol2=tol2, max_iters=max_iters)
        cu.cg_p(carry, work, inv=inv, tol2=tol2, max_iters=max_iters)


def _fused(form, carry, ap, inv, z, work, tol2, max_iters):
    if form == "general":
        cu.cg_dot_xr_plain(carry, ap, work, tol2, max_iters)
        cu.cg_dot_p_plain(carry, z, work, tol2, max_iters)
    else:
        cu.cg_step_plain(carry, ap, work, inv, tol2, max_iters)


# ---- the plain versions against the phases in sequence

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("form", ["identity", "jacobi", "general"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("n", [1, 300, 4097])
def test_fused_plain_equals_the_phases(dtype, form, mask, n):
    """cg_step_plain (cg_dot_xr_plain, then cg_dot_p_plain on the same z in
    the general form) leaves the carry the phases leave, bit for bit, and
    the same sums where active; masked off, the carry as it was and no sum
    written."""
    carry, ap, inv, z = _carry(n, n + len(form) + 7 * len(mask), dtype)
    inv = inv if form == "jacobi" else None
    tol2, max_iters = _mask(carry, mask)
    sums0 = torch.tensor([1.5, 2.5, 3.5], dtype=dtype)
    want, got = _copy(carry), _copy(carry)
    w_want, w_got = cu.Work(carry[0]), cu.Work(carry[0])
    w_want.sums.copy_(sums0)
    w_got.sums.copy_(sums0)
    _phases(form, want, ap, inv, z, w_want, tol2, max_iters)
    _fused(form, got, ap, inv, z, w_got, tol2, max_iters)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    active = mask in ("unmasked", "active")
    assert int(got[5]) == 5 + active
    if active:
        assert torch.equal(w_got.sums, w_want.sums)
    else:
        assert all(torch.equal(g, c) for g, c in zip(got, carry))
        assert torch.equal(w_got.sums, sums0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("form", ["identity", "jacobi", "general"])
def test_fused_plain_equals_the_old_masked_step(dtype, form):
    """Over several masked iterations from one carry, the fused plain form
    gives the old eager step's carry (``cg_update.eager_step``) bit for bit."""
    n = 257
    carry, _, inv, _ = _carry(n, 31, dtype)
    d = torch.linspace(0.5, 2.0, n, dtype=dtype)
    M = {"identity": cg.Jacobi(None), "jacobi": cg.Jacobi(inv),
         "general": lambda r: d * r + 0.25 * r.flip(0)}[form]
    A = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (n, n))).to(dtype)
    tol2, max_iters = carry[4] * 1e-3, torch.tensor(8)
    want, got, work = _copy(carry), _copy(carry), cu.Work(carry[0])
    for _ in range(4):
        ap = A @ want[2]
        want = cu.eager_step(want, ap, M, tol2, max_iters)
        cg._step(lambda v: A @ v, M, None, tol2, max_iters, work, got)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(got[5]) == 8


# ---- the routing of _step

def _recorder(monkeypatch):
    calls = []
    for name in ("cg_step", "cg_dot_xr", "cg_dot_p", "cg_dot", "cg_xr", "cg_p"):
        real = getattr(cu, name)

        def rec(*args, _real=real, _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(cu, name, rec)
    return calls


@pytest.mark.parametrize("form", ["identity", "jacobi", "general"])
@pytest.mark.parametrize("reduced", [False, True])
def test_step_routes_fused_only_on_one_device(form, reduced, monkeypatch):
    """Without ``reduce``: cg_step (identity, Jacobi) or cg_dot_xr, M and
    cg_dot_p (general); with it: the three phases, cg_dot twice in the general
    form, with the reduce called on p·Ap and then on [r·z, r·r]."""
    n = 60
    carry, _, inv, _ = _carry(n, 11, torch.float64)
    M = {"identity": cg.Jacobi(None), "jacobi": cg.Jacobi(inv), "general": lambda r: 2.0 * r}[form]
    reduces = []
    reduce = (lambda t: reduces.append(t.numel())) if reduced else None
    calls = _recorder(monkeypatch)
    cg._step(lambda v: 3.0 * v, M, reduce, None, None, cu.Work(carry[0]), carry)
    if not reduced:
        assert calls == (["cg_step"] if form != "general" else ["cg_dot_xr", "cg_dot_p"])
    else:
        assert calls == (["cg_dot", "cg_xr", "cg_p"] if form != "general"
                         else ["cg_dot", "cg_xr", "cg_dot", "cg_p"])
        assert reduces == [1, 2]


def test_masked_blocks_route_through_the_fused_form(monkeypatch):
    """CGBlocks on one device runs cg_step at every iteration, plain and
    masked, and never a phase."""
    arrays, b_np, _ = _aniso(8)
    csr = CSR.from_numpy(*arrays)
    layout = swell.get_swell_plan(csr)
    b = torch.from_numpy(b_np)
    calls = _recorder(monkeypatch)
    res = cg.CGBlocks(lambda v: swell.swell_ax(layout, v), cg.jacobi_preconditioner(csr), b,
                      block=4, eager_iters=3).solve(b, torch.zeros_like(b), 1e-10, 500)
    assert res.iters > 3 and set(calls) == {"cg_step"}
    assert len(calls) == 3 + -(-(res.iters - 3) // 4) * 4


# ---- CGBlocks through the fused form against _cg_loop and JAX's cg_solve

def _aniso(n=20):
    rp, ci, v, shape = aniso_laplacian_csr(n, n, 1e-2).to_numpy()
    x_true = np.random.default_rng(5).standard_normal(n * n)
    b = csr_to_dense(rp, ci, v, shape) @ x_true
    return (rp, ci, v, shape), b, x_true


def _preconds(kind, csr, ref_csr):
    if kind == "identity":
        return None, None
    if kind == "jacobi":
        return cg.jacobi_preconditioner(csr), ref_cg.jacobi_preconditioner(ref_csr)
    return tri.ilu0(csr, sweeps=3), ref_tri.ilu0(ref_csr, sweeps=3)


@pytest.mark.parametrize("kind", ["identity", "jacobi", "ilu"])
@pytest.mark.parametrize("case", ["stops inside a block", "cut at max_iters"])
@pytest.mark.parametrize("eager_iters", [0, 5])
def test_fused_blocks_equal_the_plain_loop_and_jax(kind, case, eager_iters):
    """CGBlocks (blocks of 8 after ``eager_iters`` plain iterations) equals
    _cg_loop bit for bit, both through the fused form; both match JAX's
    cg_solve on the same numpy inputs."""
    arrays, b_np, x_true = _aniso(16)
    csr, ref_csr = CSR.from_numpy(*arrays), RefCSR.from_numpy(*arrays)
    pre, pre_ref = _preconds(kind, csr, ref_csr)
    M = pre.solve if isinstance(pre, tri.ILU0) else pre
    tol, max_iters = (1e-10, 2000) if case == "stops inside a block" else (0.0, 11)
    layout = swell.get_swell_plan(csr)
    mv = lambda v: swell.swell_ax(layout, v)  # noqa: E731
    b = torch.from_numpy(b_np)
    want = cg._cg_loop(mv, M, b, torch.zeros_like(b), tol, max_iters)
    got = cg.CGBlocks(mv, M, b, block=8, eager_iters=eager_iters).solve(
        b, torch.zeros_like(b), tol, max_iters)
    assert got.iters == want.iters
    assert torch.equal(got.x, want.x) and torch.equal(got.residual_norm, want.residual_norm)
    ref = ref_cg.cg_solve(ref_csr, jnp.asarray(b_np), tol=tol, max_iters=max_iters,
                          strategy="swell", precond=pre_ref)
    ref_x = np.asarray(ref.x)
    assert np.linalg.norm(got.x.numpy() - ref_x) <= 1e-9 * np.linalg.norm(ref_x)
    if case == "cut at max_iters":
        assert got.iters == int(ref.iters) == 11
    else:
        assert abs(got.iters - int(ref.iters)) <= 1
        assert np.linalg.norm(got.x.numpy() - x_true) <= 1e-8 * np.linalg.norm(x_true)


# ---- no host read inside a fused step; argument checks

@pytest.mark.parametrize("form", ["identity", "jacobi", "general"])
def test_fused_masked_step_reads_nothing_on_the_host(form, monkeypatch):
    """One masked iteration through the fused form, with Tensor.item and
    __bool__ raising: the step the card captures makes no host read."""
    arrays, b_np, _ = _aniso(10)
    csr = CSR.from_numpy(*arrays)
    layout = swell.get_swell_plan(csr)
    mv = lambda v: swell.swell_ax(layout, v)  # noqa: E731
    b = torch.from_numpy(b_np)
    M = {"identity": cg.Jacobi(None), "jacobi": cg.jacobi_preconditioner(csr),
         "general": tri.ilu0(csr, sweeps=2).solve}[form]
    carry, tol2 = cg._cg_start(mv, M, b, torch.zeros_like(b), 1e-10)
    calls = _recorder(monkeypatch)

    def refuse(*_):
        raise RuntimeError("a host read inside a masked CG step")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    cg._masked_step(mv, M, None, tol2, torch.tensor(50), carry)
    monkeypatch.undo()
    assert int(carry[5]) == 1
    assert calls == (["cg_step"] if form != "general" else ["cg_dot_xr", "cg_dot_p"])


VECTOR_FAULTS = {
    "dtype": lambda t: t.float(),
    "device": lambda t: t.to("meta"),
    "contiguity": lambda t: torch.stack([t, t], 1)[:, 0],
    "length": lambda t: t[:-1],
    "not a tensor": lambda t: t.numpy(),
}
# each entry and the vector argument that is spoilt for a vector fault
ENTRIES = {"cg_step": "ap", "cg_step jacobi": "inv", "cg_dot_xr": "ap", "cg_dot_p": "z"}


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("bad", list(VECTOR_FAULTS) + ["it dtype", "half mask", "scalar shape",
                                                       "sums shape", "empty"])
def test_fused_argument_checks(entry, bad):
    """Each fused entry refuses what the kernel does not take, on the CPU too."""
    carry, ap, inv, z = _carry(40, 2, torch.float64)
    carry = list(carry)
    vecs = {"ap": ap, "inv": inv, "z": z}
    tol2, max_iters = torch.tensor(0.0, dtype=torch.float64), torch.tensor(9)
    work = cu.Work(carry[0])
    if bad in VECTOR_FAULTS:
        vecs[ENTRIES[entry]] = VECTOR_FAULTS[bad](vecs[ENTRIES[entry]])
    elif bad == "it dtype":
        carry[5] = carry[5].int()
    elif bad == "half mask":
        max_iters = None
    elif bad == "scalar shape":
        carry[3] = torch.ones(2, dtype=torch.float64)
    elif bad == "sums shape":
        work.sums = torch.zeros(2, dtype=torch.float64)
    elif bad == "empty":
        carry = [c[:0] if i < 3 else c for i, c in enumerate(carry)]
        vecs = {k: v[:0] for k, v in vecs.items()}
    carry = tuple(carry)
    with pytest.raises((TypeError, ValueError)):
        if entry == "cg_step":
            cu.cg_step(carry, vecs["ap"], work, tol2=tol2, max_iters=max_iters)
        elif entry == "cg_step jacobi":
            cu.cg_step(carry, vecs["ap"], work, inv=vecs["inv"], tol2=tol2, max_iters=max_iters)
        elif entry == "cg_dot_xr":
            cu.cg_dot_xr(carry, vecs["ap"], work, tol2=tol2, max_iters=max_iters)
        else:
            cu.cg_dot_p(carry, vecs["z"], work, tol2=tol2, max_iters=max_iters)


def test_fused_entries_have_no_kernel_for_another_device():
    carry, ap, inv, z = _carry(8, 1, torch.float64)
    meta = tuple(t.to("meta") for t in carry)
    work = cu.Work(meta[0])
    with pytest.raises(NotImplementedError):
        cu.cg_step(meta, ap.to("meta"), work)
    with pytest.raises(NotImplementedError):
        cu.cg_dot_xr(meta, ap.to("meta"), work)
    with pytest.raises(NotImplementedError):
        cu.cg_dot_p(meta, z.to("meta"), work)


def test_work_holds_three_sums_of_partials():
    """The partials the fused kernels fold (three sums of up to 2048 blocks)
    exist only on the card; the CPU Work holds the sums alone."""
    w = cu.Work(torch.zeros(3, dtype=torch.float64))
    assert w.partials is None and w.ticket is None and w.sums.shape == (3,)
    assert cu._MAX_BLOCKS == 2048
