"""F-2, the CG iteration's vector work (``ops/cg_update.py``; the kernel of
``csrc/cg_update.cu`` on a card), on the CPU, where each phase runs its plain
version: the phases against the masked step's arithmetic as the port wrote
it before them (``cg_update.eager_step``), the phase step in ``CGBlocks``
against ``_cg_loop`` and the JAX package's ``cg_solve``, ``Jacobi`` against the JAX
``jacobi_preconditioner``, the merged all-reduce in gloo ranks against the
JAX ``dist_cg_solve``, the step with host reads refused, and the argument
checks.

Tolerances: the phases equal the old step's arithmetic bit for bit (the
same torch operations in the same order); the blocks equal ``_cg_loop`` bit
for bit (the same phases); against JAX, which sums its dots in another
order, iterations within one and x within 1e-9 relative at tol 1e-10 (at tol
0, cut at ``max_iters``: the same count, x within 1e-9); the distributed
solves take JAX's iteration count, x within 1e-8 of JAX's, as
``tests/test_torch_dist_graphs.py`` holds them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats.containers import CSR as RefCSR
from spmv_acc_tpu.formats.convert import csr_to_dense
from spmv_acc_tpu.models import cg as ref_cg
from spmv_acc_tpu.ops import trisolve as ref_tri
from spmv_acc_tpu.parallel import make_mesh as ref_make_mesh
from spmv_acc_tpu.parallel import pad_vector as ref_pad_vector
from spmv_acc_tpu.parallel import partition_rows as ref_partition_rows
from spmv_acc_tpu.parallel import shard_partitioned as ref_shard_partitioned
from spmv_acc_tpu.parallel import unpad_vector as ref_unpad_vector
from spmv_acc_tpu.parallel.dist_swell import dist_swell_cg_solve as ref_dist_swell_cg_solve
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.formats.generate import aniso_laplacian_csr
from spmv_acc_tpu_torch.models import cg
from spmv_acc_tpu_torch.ops import cg_update as cu
from spmv_acc_tpu_torch.ops import swell
from spmv_acc_tpu_torch.ops import trisolve as tri
from spmv_acc_tpu_torch.parallel.launch import rank_cases, spawn


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


# ---- the phases against the old masked step's arithmetic

def _carry(n, seed, dtype=torch.float64):
    """A random carry (x, r, p, rz, rr, it) with rr = r·r, and Ap."""
    rng = np.random.default_rng(seed)
    x, r, p, ap = (torch.from_numpy(rng.uniform(-1, 1, n)).to(dtype) for _ in range(4))
    rz = torch.tensor(rng.uniform(0.5, 2.0), dtype=dtype)
    return (x, r, p, rz, torch.dot(r, r), torch.tensor(5)), ap


def _phases(M, tol2, max_iters, carry, ap, work):
    """One iteration as ``models.cg._step`` runs it, the matvec's output given."""
    cu.cg_dot(carry[2], ap, work, cu.PAP)
    if isinstance(M, cg.Jacobi):
        cu.cg_xr(carry, ap, work, inv=M.inv, tol2=tol2, max_iters=max_iters)
        z = None
    else:
        cu.cg_xr(carry, ap, work, with_rz=False, tol2=tol2, max_iters=max_iters)
        z = M(carry[1])
        cu.cg_dot(carry[1], z, work, cu.RZ)
    cu.cg_p(carry, work, inv=M.inv if z is None else None, z=z, tol2=tol2, max_iters=max_iters)
    return carry


def _form(name, n, seed):
    rng = np.random.default_rng(seed + 1)
    if name == "identity":
        return cg.Jacobi(None)
    if name == "jacobi":
        return cg.Jacobi(torch.from_numpy(rng.uniform(0.5, 2.0, n)))
    d = torch.from_numpy(rng.uniform(0.5, 2.0, n))
    return lambda r: d * r + 0.25 * r.flip(0)  # a general M (not symmetric: arithmetic only)


MASKS = {"unmasked": None, "active": 0.5, "converged": 2.0, "at max_iters": "max"}


@pytest.mark.parametrize("form", ["identity", "jacobi", "general"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("n", [1, 300, 4097])
def test_phases_equal_the_old_masked_step(form, mask, n):
    """The three phases (four and M's apply in the general form) give the
    carry the old masked step gave, bit for bit, active or not; inactive
    they write nothing, and the count adds the iteration only when active."""
    seed = n + len(form) + len(mask)
    carry, ap = _carry(n, seed)
    M = _form(form, n, seed)
    how = MASKS[mask]
    if how is None:
        tol2 = max_iters = None
    else:
        tol2 = carry[4] * (0.5 if how == "max" else how)
        max_iters = torch.tensor(5 if how == "max" else 100)
    want = cu.eager_step(carry, ap, M, tol2, max_iters)
    before = tuple(t.clone() for t in carry)
    work = cu.Work(carry[0])
    got = _phases(M, tol2, max_iters, tuple(t.clone() for t in carry), ap, work)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    active = mask in ("unmasked", "active")
    assert int(got[5]) == 5 + active
    if not active:
        for g, b in zip(got, before):
            assert torch.equal(g, b)
        # cg_xr wrote no sum; the general form's cg_dot(r, z) is not masked
        assert float(work.sums[cu.RR]) == 0.0
        assert form == "general" or float(work.sums[cu.RZ]) == 0.0


@pytest.mark.parametrize("mask", ["converged", "at max_iters"])
def test_an_inactive_phase_writes_no_sum(mask):
    """cg_xr and cg_p masked off leave the sums and the carry as they were."""
    carry, ap = _carry(50, 3)
    tol2 = carry[4] * (2.0 if mask == "converged" else 0.5)
    max_iters = torch.tensor(100 if mask == "converged" else 5)
    work = cu.Work(carry[0])
    work.sums.copy_(torch.tensor([1.5, 2.5, 3.5], dtype=torch.float64))
    before = tuple(t.clone() for t in carry)
    cu.cg_xr(carry, ap, work, inv=None, tol2=tol2, max_iters=max_iters)
    cu.cg_p(carry, work, tol2=tol2, max_iters=max_iters)
    assert torch.equal(work.sums, torch.tensor([1.5, 2.5, 3.5], dtype=torch.float64))
    assert all(torch.equal(a, b) for a, b in zip(carry, before))


def test_cg_dot_writes_its_slot():
    carry, ap = _carry(77, 9)
    work = cu.Work(carry[0])
    for slot in (cu.PAP, cu.RZ, cu.RR):
        cu.cg_dot(carry[2], ap, work, slot)
        assert torch.equal(work.sums[slot], torch.dot(carry[2], ap))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_phases_run_float32_and_float64(dtype):
    """The phase step in float32 equals the old arithmetic in float32."""
    carry, ap = _carry(333, 4, dtype)
    M = cg.Jacobi(torch.linspace(0.5, 2.0, 333, dtype=dtype))
    want = cu.eager_step(carry, ap, M)
    got = _phases(M, None, None, tuple(t.clone() for t in carry), ap, cu.Work(carry[0]))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].dtype == dtype


# ---- the phase step in CGBlocks against _cg_loop and JAX's cg_solve

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
    sweeps = 0 if kind == "ilu exact" else 3
    return tri.ilu0(csr, sweeps=sweeps), ref_tri.ilu0(ref_csr, sweeps=sweeps)


@pytest.mark.parametrize("kind", ["identity", "jacobi", "ilu exact", "ilu sweeps"])
@pytest.mark.parametrize("case", ["stops inside a block", "cut at max_iters"])
def test_phase_blocks_equal_the_plain_loop_and_jax(kind, case):
    """CGBlocks from the first iteration (masked blocks of 16, the last one
    cut) equals _cg_loop bit for bit: iterations, x and the residual; both
    match JAX's cg_solve on the same numpy inputs."""
    arrays, b_np, x_true = _aniso()
    csr, ref_csr = CSR.from_numpy(*arrays), RefCSR.from_numpy(*arrays)
    pre, pre_ref = _preconds(kind, csr, ref_csr)
    M = pre.solve if isinstance(pre, tri.ILU0) else pre
    tol, max_iters = (1e-10, 2000) if case == "stops inside a block" else (0.0, 13)
    layout = swell.get_swell_plan(csr)
    mv = lambda v: swell.swell_ax(layout, v)  # noqa: E731
    b = torch.from_numpy(b_np)
    want = cg._cg_loop(mv, M, b, torch.zeros_like(b), tol, max_iters)
    got = cg.CGBlocks(mv, M, b, block=16, eager_iters=0).solve(b, torch.zeros_like(b), tol,
                                                               max_iters)
    assert got.iters == want.iters
    assert torch.equal(got.x, want.x) and torch.equal(got.residual_norm, want.residual_norm)
    ref = ref_cg.cg_solve(ref_csr, jnp.asarray(b_np), tol=tol, max_iters=max_iters,
                          strategy="swell", precond=pre_ref)
    ref_x = np.asarray(ref.x)
    assert np.linalg.norm(got.x.numpy() - ref_x) <= 1e-9 * np.linalg.norm(ref_x)
    if case == "cut at max_iters":
        assert got.iters == int(ref.iters) == 13
    else:
        assert abs(got.iters - int(ref.iters)) <= 1 and got.iters % 16 != 0
        assert np.linalg.norm(got.x.numpy() - x_true) <= 1e-8 * np.linalg.norm(x_true)


def test_residual_is_the_carried_rr():
    """The result's residual is sqrt of the rr that cg_xr summed: the r·r of
    the returned r (the plain version sums it with torch.dot)."""
    arrays, b_np, _ = _aniso(12)
    csr = CSR.from_numpy(*arrays)
    layout = swell.get_swell_plan(csr)
    mv = lambda v: swell.swell_ax(layout, v)  # noqa: E731
    b = torch.from_numpy(b_np)
    res = cg._cg_loop(mv, cg.jacobi_preconditioner(csr), b, torch.zeros_like(b), 1e-10, 500)
    r = b - mv(res.x)
    assert abs(float(res.residual_norm) - float(torch.sqrt(torch.dot(r, r)))) <= 1e-9 * float(
        torch.linalg.norm(b))


# ---- Jacobi against the JAX package's jacobi_preconditioner

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_jacobi_matches_reference(dtype):
    """jacobi_preconditioner is a Jacobi object: its inv is 1/diag(A) (1 on
    rows with no stored diagonal), and M(r) equals the JAX lambda's."""
    arrays, _, _ = _aniso(9)
    rp, ci, v, shape = arrays
    keep = ~((ci == 4) & (np.repeat(np.arange(shape[0]), np.diff(rp)) == 4))  # row 4: no diagonal
    rp2 = np.concatenate([[0], np.cumsum(np.bincount(np.repeat(np.arange(shape[0]),
                                                               np.diff(rp))[keep],
                                                     minlength=shape[0]))])
    ci2, v2 = ci[keep], v[keep].astype(dtype)
    M = cg.jacobi_preconditioner(CSR.from_numpy(rp2, ci2, v2, shape))
    ref = ref_cg.jacobi_preconditioner(RefCSR.from_numpy(rp2, ci2, v2, shape))
    assert isinstance(M, cg.Jacobi) and M.inv.dtype == torch.from_numpy(v2).dtype
    assert float(M.inv[4]) == 1.0
    r = np.random.default_rng(3).standard_normal(shape[0]).astype(dtype)
    assert np.array_equal(M(torch.from_numpy(r)).numpy(), np.asarray(ref(jnp.asarray(r))))


def test_identity_is_jacobi_without_inv():
    r = torch.arange(5.0)
    assert cg.Jacobi(None)(r) is r
    assert isinstance(cg.CGBlocks(lambda v: v, None, r).M, cg.Jacobi)


# ---- the merged all-reduce in gloo ranks against JAX's dist_cg_solve

def _banded_spd():
    """test_torch_dist_graphs.py's 64-row system."""
    from spmv_acc_tpu.formats.convert import coo_to_csr_arrays
    from spmv_acc_tpu.formats.generate import banded_csr as ref_banded

    m = 64
    d = csr_to_dense(*ref_banded(m, bandwidth=3, seed=46).to_numpy())
    d = 0.5 * (d + d.T) + np.eye(m) * (np.abs(d).sum(axis=1) + 1.0)
    rr, cc = np.nonzero(d)
    rp, ci, v = coo_to_csr_arrays(rr, cc, d[rr, cc], (m, m))
    x_true = np.random.default_rng(47).random(m)
    return (rp, ci, v, (m, m)), d @ x_true


# (kind, tol, max_iters, CG_EAGER_ITERS): masked from the first iteration,
# all plain, and cut at max_iters inside a block
DIST_CASES = {
    "cg masked": ("cg", 1e-12, 200, 0),
    "cg plain": ("cg", 1e-12, 200, 10 ** 9),
    "cg cut at 13": ("cg", 0.0, 13, 0),
    "swell_cg masked": ("swell_cg", 1e-12, 200, 0),
    "swell_cg cut at 11": ("swell_cg", 0.0, 11, 0),
}
_RESULTS = {}


def _dist_results(D):
    if D not in _RESULTS:
        csr, b = _banded_spd()
        _RESULTS[D] = spawn(rank_cases, D, "cpu", [
            dict(kind=k, csr=csr, b=b, tol=tol, max_iters=mx, eager_iters=e, count_reduces=True)
            for k, tol, mx, e in DIST_CASES.values()])
    return _RESULTS[D]


def _dist_reference(kind, tol, max_iters, D):
    (rp, ci, v, shape), b = _banded_spd()
    mesh = ref_make_mesh(D)
    if kind == "cg":
        part = ref_shard_partitioned(ref_partition_rows(RefCSR.from_numpy(rp, ci, v, shape), D,
                                                        balance=False), mesh)
        res = ref_cg.dist_cg_solve(part, ref_pad_vector(part, b), mesh, tol=tol,
                                   max_iters=max_iters)
        return np.asarray(ref_unpad_vector(part, np.asarray(res.x))), int(res.iters)
    res, _ = ref_dist_swell_cg_solve(RefCSR.from_numpy(rp, ci, v, shape), jnp.asarray(b), mesh,
                                     tol=tol, max_iters=max_iters)
    return np.asarray(res.x)[: shape[0]], int(res.iters)


@pytest.mark.parametrize("case", list(DIST_CASES))
@pytest.mark.parametrize("D", [2, 4])
def test_merged_all_reduce_matches_reference(D, case):
    """Every rank takes JAX's iteration count and x within 1e-8 of JAX's;
    the solve all-reduces three scalars to start (b·b, r·z, r·r), then two
    all-reduces an iteration run, masked ones included: p·Ap alone and
    [r·z, r·r] merged."""
    kind, tol, max_iters, eager = DIST_CASES[case]
    i = list(DIST_CASES).index(case)
    results = _dist_results(D)
    x, iters, counts = results[0][i]
    assert [r[i][1] for r in results] == [iters] * D
    assert all(r[i][2] == counts for r in results)
    ref_x, ref_iters = _dist_reference(kind, tol, max_iters, D)
    assert iters == ref_iters
    assert np.linalg.norm(x - ref_x) <= 1e-8 * np.linalg.norm(ref_x)
    if eager >= max_iters:
        steps = iters
    else:
        steps = min(max_iters, -(-iters // cg.CG_BLOCK) * cg.CG_BLOCK)
    assert counts == {1: 3 + steps, 2: steps}


# ---- no host read inside a step; argument checks

@pytest.mark.parametrize("form", ["identity", "jacobi", "general"])
def test_masked_step_reads_nothing_on_the_host(form, monkeypatch):
    """One masked CG iteration through the phases, and each phase alone,
    with Tensor.item and __bool__ raising: the step the card captures makes
    no host read."""
    arrays, b_np, _ = _aniso(10)
    csr = CSR.from_numpy(*arrays)
    layout = swell.get_swell_plan(csr)
    mv = lambda v: swell.swell_ax(layout, v)  # noqa: E731
    b = torch.from_numpy(b_np)
    M = _form(form, b.numel(), 1)
    carry, tol2 = cg._cg_start(mv, M, b, torch.zeros_like(b), 1e-10)
    max_iters, work = torch.tensor(50), cu.Work(b)

    def refuse(*_):
        raise RuntimeError("a host read inside a masked CG step")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    cg._masked_step(mv, M, None, tol2, max_iters, carry, work=work)
    cg._masked_step(mv, M, None, tol2, max_iters, carry)
    monkeypatch.undo()
    assert int(carry[5]) == 2


def _checked_carry():
    carry, ap = _carry(40, 2)
    return list(carry), ap


@pytest.mark.parametrize("bad", ["dtype", "device", "contiguity", "length", "int dtype",
                                 "it dtype", "half mask", "scalar shape", "not a tensor",
                                 "empty"])
def test_phase_argument_checks(bad):
    """Each phase refuses what the kernel does not take, on the CPU too."""
    carry, ap = _checked_carry()
    work = cu.Work(carry[0])
    tol2, max_iters = torch.tensor(0.0, dtype=torch.float64), torch.tensor(9)
    if bad == "dtype":
        ap = ap.float()
    elif bad == "device":
        ap = ap.to("meta")
    elif bad == "contiguity":
        ap = torch.stack([ap, ap], 1)[:, 0]
    elif bad == "length":
        ap = ap[:-1]
    elif bad == "int dtype":
        carry, ap = [c.long() for c in carry], ap.long()
        work = cu.Work(carry[0])
    elif bad == "it dtype":
        carry[5] = carry[5].int()
    elif bad == "half mask":
        max_iters = None
    elif bad == "scalar shape":
        carry[3] = torch.ones(2, dtype=torch.float64)
    elif bad == "not a tensor":
        ap = ap.numpy()
    elif bad == "empty":
        carry = [c[:0] if i < 3 else c for i, c in enumerate(carry)]
        ap, work = ap[:0], cu.Work(carry[0])
    with pytest.raises((TypeError, ValueError)):
        cu.cg_xr(tuple(carry), ap, work, tol2=tol2, max_iters=max_iters)
    if bad in ("dtype", "device", "contiguity", "length", "not a tensor", "empty", "int dtype"):
        with pytest.raises((TypeError, ValueError)):
            cu.cg_dot(carry[2], ap, work, cu.PAP)
    if bad in ("it dtype", "half mask", "scalar shape", "int dtype", "empty"):
        with pytest.raises((TypeError, ValueError)):
            cu.cg_p(tuple(carry), work, tol2=tol2, max_iters=max_iters)


def test_phase_form_checks():
    carry, ap = _carry(20, 1)
    work = cu.Work(carry[0])
    inv = torch.ones(20, dtype=torch.float64)
    with pytest.raises(ValueError):
        cu.cg_xr(carry, ap, work, inv=inv, with_rz=False)
    with pytest.raises(ValueError):
        cu.cg_p(carry, work, inv=inv, z=inv)
    with pytest.raises(ValueError):
        cu.cg_dot(carry[2], ap, work, 3)


def test_phases_have_no_kernel_for_another_device():
    carry, ap = _carry(8, 1)
    meta = tuple(t.to("meta") for t in carry)
    with pytest.raises(NotImplementedError):
        cu.cg_dot(meta[2], ap.to("meta"), cu.Work(meta[0]), cu.PAP)


def test_graph_us_needs_a_card(monkeypatch):
    """The graph timer F-2 is timed with takes no time from the CPU."""
    from spmv_acc_tpu_torch.utils.timer import graph_us

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        graph_us(lambda: None)
