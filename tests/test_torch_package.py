"""Package-level checks of the port: it never imports JAX, its kernels are built
for Hopper from the repo's CUDA sources, and (on a card) the swell, tile and
ELL row-sum kernels match their plain versions.

The ``cuda`` tests need an NVIDIA GPU and skip without one; run them there with
``python -m pytest tests/test_torch_package.py -m cuda --noconftest`` (the
shared conftest imports JAX, which the card's machine need not have)."""

import ast
import functools
import gc
import os
import sys

import numpy as np
import pytest
import torch

from spmv_acc_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "spmv_acc_tpu_torch")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_never_imports_jax():
    sources = list(_port_sources()) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(sources) > 15
    for path in sources:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "spmv_acc_tpu"), f"{path} imports {mod}"


def test_nvcc_command_targets_hopper():
    cmd = _build.nvcc_command(_build.SWELL_SRC, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    assert cmd[-1] == _build.SWELL_SRC


def test_swell_kernel_source_exists():
    with open(os.path.join(PKG, "csrc", "swell_spmv.cu")) as f:
        src = f.read()
    assert 'extern "C" int swell_spmm(' in src
    assert "cudaGetLastError" in src
    assert _build.SWELL_SRC == os.path.join(PKG, "csrc", "swell_spmv.cu")
    assert _build.BUILD_DIR == os.path.join(REPO, "build")


@pytest.mark.parametrize("src", sorted(_build.SOURCES))
def test_kernel_sources_have_their_c_entry(src):
    entries = _build.SOURCES[src]
    assert entries and os.path.dirname(src) == os.path.join(PKG, "csrc")
    with open(src) as f:
        text = f.read()
    assert "cudaGetLastError" in text
    for entry in entries:
        assert f'extern "C" int {entry}(' in text
    assert _build.nvcc_command(src, "o.so")[-1] == src


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 300, 1500), (40000, 300, 9000), (300, 40000, 9000)])
def test_h1_matches_plain_on_card(cuda_device, shape):
    from spmv_acc_tpu_torch.formats import random_csr, random_x_y
    from spmv_acc_tpu_torch.ops import swell

    m, n, nnz = shape
    csr = random_csr(m, n, nnz, seed=m + n).to(cuda_device)
    x = torch.from_numpy(random_x_y(n, m, seed=1)[0]).to(cuda_device)
    layout = swell.get_swell_plan(csr)
    before = swell.LAUNCHES[("f64", 1, 1)]
    a = swell.swell_ax(layout, x)
    p = swell.swell_ax_plain(layout, x)
    torch.cuda.synchronize()
    assert swell.LAUNCHES[("f64", 1, 1)] == before + 1
    rp, ci, v, _ = csr.to_numpy()
    bound = np.zeros(m)
    np.add.at(bound, np.repeat(np.arange(m), np.diff(rp)), np.abs(v * x.cpu().numpy()[ci]))
    assert (np.abs(a.cpu().numpy() - p.cpu().numpy()) <= 1e-12 * bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("r,k", [(1, 1), (1, 3), (1, 8), (2, 3), (3, 5), (4, 1), (4, 8)])
def test_kernel_variants_match_plain_on_card(cuda_device, dtype, r, k):
    """Every (dtype, r, column group) the port launches, against the plain
    version: float64 within 1e-12 (|A|·|X|); float32 within one float32 ulp of
    the plain version plus that bound (both round an FP64 sum once)."""
    from spmv_acc_tpu_torch.formats import fem_like_csr
    from spmv_acc_tpu_torch.ops import swell

    csr = fem_like_csr(3001, 3001, 90000, block=6, seed=5, dtype=dtype).to(cuda_device)
    X = np.random.default_rng(2).standard_normal((3001, k)).astype(dtype)
    layout = swell.get_swell_plan(csr, r=r)
    dX = torch.from_numpy(X).to(cuda_device)
    before = swell.LAUNCHES[("f64" if dtype == np.float64 else "f32", r, k)]
    a = swell.swell_amx(layout, dX)
    p = swell.swell_amx_plain(layout, dX)
    torch.cuda.synchronize()
    assert swell.LAUNCHES[("f64" if dtype == np.float64 else "f32", r, k)] == before + 1
    rp, ci, v, _ = csr.to_numpy()
    bound = np.zeros((3001, k))
    np.add.at(bound, np.repeat(np.arange(3001), np.diff(rp)),
              np.abs(v.astype(np.float64)[:, None] * X.astype(np.float64)[ci]))
    a, p = a.cpu().numpy().astype(np.float64), p.cpu().numpy().astype(np.float64)
    ulp = 0.0 if dtype == np.float64 else 2.0**-23
    assert (np.abs(a - p) <= ulp * np.abs(p) + 1e-12 * bound).all()


def _row_bound(csr, x):
    rp, ci, v, _ = csr.to_numpy()
    bound = np.zeros(csr.rows)
    np.add.at(bound, np.repeat(np.arange(csr.rows), np.diff(rp)),
              np.abs(v.astype(np.float64) * x.astype(np.float64)[ci]))
    return bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", [(300, 300, 1500), (64, 100, 3000), (300, 40000, 9000)])
def test_tile_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    """tile_spmv against tile_spmv_plain: float64 within 1e-12 (|A|·|x|);
    float32 within one float32 ulp of the plain version on top."""
    from spmv_acc_tpu_torch.formats import random_csr, random_x_y
    from spmv_acc_tpu_torch.ops import adaptive_plus as ap

    m, n, nnz = shape
    csr = random_csr(m, n, nnz, seed=m + n, dtype=dtype).to(cuda_device)
    x = random_x_y(n, m, seed=2, dtype=dtype)[0]
    dp = ap.get_tile_plan(csr)
    key = "f64" if dtype == np.float64 else "f32"
    before = ap.LAUNCHES[key]
    a = ap.tile_spmv(dp, torch.from_numpy(x).to(cuda_device))
    p = ap.tile_spmv_plain(dp, torch.from_numpy(x).to(cuda_device))
    torch.cuda.synchronize()
    assert ap.LAUNCHES[key] == before + 1
    a, p = a.cpu().numpy().astype(np.float64), p.cpu().numpy().astype(np.float64)
    ulp = 0.0 if dtype == np.float64 else 2.0**-23
    assert (np.abs(a - p) <= ulp * np.abs(p) + 1e-12 * _row_bound(csr, x)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("vs", [2, 4, 8, 16, 32])
def test_ell_kernel_matches_plain_on_card(cuda_device, dtype, vs):
    """ell_rowsum at every vector size against ell_rowsum_plain, same bounds:
    the slab read to each row's length, read to the width (no row_len), and at
    an odd width (the single-cell walk); two launches equal bit for bit."""
    from spmv_acc_tpu_torch.formats import ELL, csr_to_ell, powerlaw_csr, random_x_y
    from spmv_acc_tpu_torch.ops import vector_row as vr

    csr = powerlaw_csr(3000, 3000, avg_nnz=12, seed=9, dtype=dtype).to(cuda_device)
    x = random_x_y(3000, 3000, seed=3, dtype=dtype)[0]
    dx = torch.from_numpy(x).to(cuda_device)
    ell = csr_to_ell(csr)
    pad = torch.nn.functional.pad
    slabs = (ell, ELL(ell.col_idx, ell.values, ell.shape),
             ELL(pad(ell.col_idx, (0, 1)), pad(ell.values, (0, 1)), ell.shape, ell.row_len))
    key = ("f64" if dtype == np.float64 else "f32", vs)
    before = vr.LAUNCHES[key]
    for slab in slabs:
        a, b = vr._launch(slab, dx, vs), vr._launch(slab, dx, vs)
        p = vr.ell_rowsum_plain(slab, dx)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        a, p = (t.cpu().numpy().astype(np.float64)[:3000] for t in (a, p))
        ulp = 0.0 if dtype == np.float64 else 2.0**-23
        assert (np.abs(a - p) <= ulp * np.abs(p) + 1e-12 * _row_bound(csr, x)).all()
    assert vr.LAUNCHES[key] == before + 2 * len(slabs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("vs", [2, 4, 8, 16, 32])
def test_ell_kernel_inf_at_x0_on_card(cuda_device, dtype, vs):
    """x[0] = inf: the kernel, which reads only each row's stored cells, is
    non-finite on exactly the rows where the whole-slab plain version is (rows
    with padding, rows that hold column 0) and agrees with it elsewhere."""
    from spmv_acc_tpu_torch.formats import CSR, csr_to_ell, random_x_y
    from spmv_acc_tpu_torch.ops import vector_row as vr

    # half the rows reach the width of 16 (no padding); only every fifth may hold column 0
    rng = np.random.default_rng(9)
    lens = np.where(np.arange(3000) % 2 == 1, 16, rng.integers(0, 17, 3000))
    cols = [np.sort(rng.choice(np.arange(i % 5 != 0, 3000), ln, replace=False))
            for i, ln in enumerate(lens)]
    csr = CSR.from_numpy(np.concatenate([[0], np.cumsum(lens)]), np.concatenate(cols),
                         rng.standard_normal(lens.sum()).astype(dtype), (3000, 3000),
                         device=cuda_device)
    x = random_x_y(3000, 3000, seed=3, dtype=dtype)[0]
    x[0] = np.inf
    dx = torch.from_numpy(x).to(cuda_device)
    ell = csr_to_ell(csr)
    a, p = vr._launch(ell, dx, vs), vr.ell_rowsum_plain(ell, dx)
    torch.cuda.synchronize()
    a, p = a.cpu().numpy().astype(np.float64), p.cpu().numpy().astype(np.float64)
    bad = ~np.isfinite(p)
    assert bad.any() and not bad.all()
    assert np.array_equal(~np.isfinite(a), bad)
    x[0] = 0.0
    ulp = 0.0 if dtype == np.float64 else 2.0**-23
    bound = np.concatenate([_row_bound(csr, x), np.zeros(ell.padded_rows - 3000)])
    assert (np.abs(a - p)[~bad] <= (ulp * np.abs(p) + 1e-12 * bound)[~bad]).all()


# delta 2 (banded), 117 (tall) and three x chunks (wide)
PLANE_SHAPES = {"banded": None, "tall": (40000, 300, 9000), "wide": (300, 40000, 9000)}


def _plane_case(name, dtype, device):
    from spmv_acc_tpu_torch.formats import banded_csr, random_csr, random_x_y
    from spmv_acc_tpu_torch.ops import swell

    shape = PLANE_SHAPES[name]
    csr = (banded_csr(300, bandwidth=5, seed=70, dtype=dtype) if shape is None
           else random_csr(*shape, seed=sum(shape), dtype=dtype)).to(device)
    layout = swell.get_swell_plan(csr, r=1)
    x = torch.from_numpy(random_x_y(csr.cols, csr.rows, seed=4, dtype=dtype)[0]).to(device)
    return csr, layout, x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(PLANE_SHAPES))
def test_plane_split_kernel_matches_plain_on_card(cuda_device, dtype, name):
    """prep_x's kernel against prep_x_plain, bit for bit (as int16)."""
    from spmv_acc_tpu_torch.ops import swell

    _, layout, x = _plane_case(name, dtype, cuda_device)
    key = ("f64" if dtype == np.float64 else "f32", "plane_split")
    before = swell.LAUNCHES[key]
    got = swell.prep_x(layout, x)
    want = swell.prep_x_plain(layout, x)
    torch.cuda.synchronize()
    assert swell.LAUNCHES[key] == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(PLANE_SHAPES))
def test_plane_form_kernel_matches_plain_on_card(cuda_device, dtype, name):
    """swell_ax_planes against swell_ax_planes_plain within 1e-12 (|A|·|x|)
    (plus one float32 ulp); in float32 equal to the direct kernel bit for bit."""
    from spmv_acc_tpu_torch.ops import swell

    csr, layout, x = _plane_case(name, dtype, cuda_device)
    planes = swell.prep_x_plain(layout, x)
    key = ("f64" if dtype == np.float64 else "f32", 1, 1, "planes")
    before = swell.LAUNCHES[key]
    a = swell.swell_ax_planes(layout, planes)
    p = swell.swell_ax_planes_plain(layout, planes)
    direct = swell.swell_ax(layout, x)
    torch.cuda.synchronize()
    assert swell.LAUNCHES[key] == before + 1
    a64, p64 = a.cpu().numpy().astype(np.float64), p.cpu().numpy().astype(np.float64)
    ulp = 0.0 if dtype == np.float64 else 2.0**-23
    assert (np.abs(a64 - p64) <= ulp * np.abs(p64) + 1e-12 * _row_bound(csr, x.cpu().numpy())).all()
    if dtype == np.float32:
        assert torch.equal(a, direct)


@pytest.mark.cuda
def test_preconditioned_cg_on_card(cuda_device, monkeypatch):
    """CG with ILU(0) sweeps on the swell kernel, on the card and on the CPU,
    and the plane form of the matvec: iterations within one (two for the plane
    form), solutions within 1e-8 of x_true."""
    from spmv_acc_tpu_torch.formats import aniso_laplacian_csr
    from spmv_acc_tpu_torch.models.cg import _cg_loop, cg_solve, jacobi_preconditioner
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.ops import trisolve as tri

    monkeypatch.setattr(tri, "ILU_SWELL_MIN", 0)  # the sweeps on the swell kernel
    host = aniso_laplacian_csr(48, 48, 0.01)
    rp, ci, v, shape = host.to_numpy()
    x_true = np.random.default_rng(5).standard_normal(shape[0])
    from spmv_acc_tpu_torch.ops.golden import host_spmv

    b = host_spmv(1.0, 0.0, rp, ci, v, x_true, np.zeros(shape[0]))
    runs = {}
    for dev in (torch.device("cpu"), cuda_device):
        csr = host.to(dev)
        fact = tri.ilu0(csr, sweeps=3)
        assert fact.swell is not None
        res = cg_solve(csr, torch.from_numpy(b).to(dev), tol=1e-10, max_iters=2000,
                       strategy="swell", precond=fact)
        runs[dev.type] = (res.iters, res.x.cpu().numpy())
    assert abs(runs["cpu"][0] - runs["cuda"][0]) <= 1 and runs["cuda"][0] < 2000
    for _, x in runs.values():
        assert np.linalg.norm(x - x_true) < 1e-8 * np.linalg.norm(x_true)
    csr = host.to(cuda_device)
    layout = swell.get_swell_plan(csr)
    db = torch.from_numpy(b).to(cuda_device)
    direct = cg_solve(csr, db, tol=1e-10, max_iters=2000, strategy="swell",
                      precond=jacobi_preconditioner(csr))
    planes = _cg_loop(lambda p: swell.swell_ax_planes(layout, swell.prep_x(layout, p)),
                      jacobi_preconditioner(csr), db, torch.zeros_like(db), 1e-10, 2000)
    assert abs(planes.iters - direct.iters) <= max(2, direct.iters // 50)
    assert np.linalg.norm(planes.x.cpu().numpy() - x_true) < 1e-8 * np.linalg.norm(x_true)


def _cut_swell_plan(csr, r, max_rows, monkeypatch):
    """A fresh r x r swell plan whose chunks hold at most ``max_rows`` slot
    rows: built with SWELL_CHUNK_ROWS = max_rows * r."""
    from spmv_acc_tpu_torch.ops import swell, swell_plan

    monkeypatch.setattr(swell_plan, "SWELL_CHUNK_ROWS", max_rows * r)
    swell.clear_swell_cache()
    layout = swell.get_swell_plan(csr, r=r)
    assert layout.schedule.max_rows == max_rows and layout.schedule.nsplit > 0
    return layout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("r,k", [(1, 1), (1, 8), (4, 1), (4, 8)])
@pytest.mark.parametrize("max_rows", [1, 4])
def test_split_swell_kernel_matches_plain_on_card(cuda_device, monkeypatch, dtype, r, k,
                                                  max_rows):
    """Row blocks cut into chunks of 1 or 4 slot rows (partials and the fix-up
    pass): the kernel against swell_amx_plain in the bounds above, and two
    launches equal bit for bit."""
    from spmv_acc_tpu_torch.formats import fem_like_csr
    from spmv_acc_tpu_torch.ops import swell

    csr = fem_like_csr(3001, 3001, 90000, block=6, seed=5, dtype=dtype).to(cuda_device)
    layout = _cut_swell_plan(csr, r, max_rows, monkeypatch)
    X = np.random.default_rng(2).standard_normal((3001, k)).astype(dtype)
    dX = torch.from_numpy(X).to(cuda_device)
    key = ("f64" if dtype == np.float64 else "f32", r, k)
    before, fix = swell.LAUNCHES[key], swell.LAUNCHES[(*key, "fixup")]
    a, b = swell.swell_amx(layout, dX), swell.swell_amx(layout, dX)
    p = swell.swell_amx_plain(layout, dX)
    torch.cuda.synchronize()
    assert swell.LAUNCHES[key] == before + 2 and swell.LAUNCHES[(*key, "fixup")] == fix + 2
    assert torch.equal(a, b)
    rp, ci, v, _ = csr.to_numpy()
    bound = np.zeros((3001, k))
    np.add.at(bound, np.repeat(np.arange(3001), np.diff(rp)),
              np.abs(v.astype(np.float64)[:, None] * X.astype(np.float64)[ci]))
    a, p = a.cpu().numpy().astype(np.float64), p.cpu().numpy().astype(np.float64)
    ulp = 0.0 if dtype == np.float64 else 2.0**-23
    assert (np.abs(a - p) <= ulp * np.abs(p) + 1e-12 * bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_split_tile_kernel_matches_plain_on_card(cuda_device, monkeypatch, dtype):
    """The tile kernel with TILE_CHUNK_ROWS = 1 (every block its own chunk)
    against tile_spmv_plain; two launches equal bit for bit."""
    from spmv_acc_tpu_torch.formats import fem_like_csr, random_x_y
    from spmv_acc_tpu_torch.ops import adaptive_plus as ap
    from spmv_acc_tpu_torch.ops import tile_plan

    monkeypatch.setattr(tile_plan, "TILE_CHUNK_ROWS", 1)
    ap.clear_tile_cache()
    csr = fem_like_csr(3001, 3001, 90000, block=6, seed=5, dtype=dtype).to(cuda_device)
    dp = ap.get_tile_plan(csr)
    assert dp.schedule.max_rows == 1 and dp.schedule.nsplit > 0
    x = random_x_y(3001, 3001, seed=2, dtype=dtype)[0]
    dx = torch.from_numpy(x).to(cuda_device)
    key = "f64" if dtype == np.float64 else "f32"
    before = ap.LAUNCHES[(key, "fixup")]
    a, b, p = ap.tile_spmv(dp, dx), ap.tile_spmv(dp, dx), ap.tile_spmv_plain(dp, dx)
    torch.cuda.synchronize()
    assert ap.LAUNCHES[(key, "fixup")] == before + 2 and torch.equal(a, b)
    a, p = a.cpu().numpy().astype(np.float64), p.cpu().numpy().astype(np.float64)
    ulp = 0.0 if dtype == np.float64 else 2.0**-23
    assert (np.abs(a - p) <= ulp * np.abs(p) + 1e-12 * _row_bound(csr, x)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("max_rows", [1, 4])
def test_split_plane_form_equals_direct_on_card(cuda_device, monkeypatch, max_rows):
    """Under a cut schedule the float32 plane form still equals the direct
    kernel bit for bit (both keep FP64 partials), and float64 stays within
    1e-12 (|A|·|x|) of its plain version."""
    from spmv_acc_tpu_torch.formats import banded_csr, random_x_y
    from spmv_acc_tpu_torch.ops import swell

    for dtype in (np.float32, np.float64):
        csr = banded_csr(3000, bandwidth=40, seed=70, dtype=dtype).to(cuda_device)
        layout = _cut_swell_plan(csr, 1, max_rows, monkeypatch)
        x = random_x_y(3000, 3000, seed=4, dtype=dtype)[0]
        dx = torch.from_numpy(x).to(cuda_device)
        planes = swell.prep_x(layout, dx)
        a = swell.swell_ax_planes(layout, planes)
        p = swell.swell_ax_planes_plain(layout, planes)
        direct = swell.swell_ax(layout, dx)
        torch.cuda.synchronize()
        if dtype == np.float32:
            assert torch.equal(a, direct)
        else:
            xt = swell._planes_x(layout, planes, torch.arange(3000, device=cuda_device))
            gap = np.abs(a.cpu().numpy() - p.cpu().numpy())
            assert (gap <= 1e-12 * _row_bound(csr, xt.cpu().numpy())).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("r", [None, 1, 4])
def test_disk_cached_layout_runs_the_kernel_on_card(cuda_device, tmp_path, monkeypatch, dtype, r):
    """A CUDA matrix's layout is saved by default; with the process's cache
    dropped it is loaded (not rebuilt), equals the live layout tensor for
    tensor, and the kernel over both gives the same bytes."""
    import dataclasses

    from spmv_acc_tpu_torch.formats import fem_like_csr, random_x_y
    from spmv_acc_tpu_torch.ops import swell

    monkeypatch.setenv("SPMV_TPU_PLAN_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("SPMV_TPU_NO_PLAN_CACHE", raising=False)
    csr = fem_like_csr(3001, 3001, 90000, block=4, seed=5, dtype=dtype).to(cuda_device)
    swell.clear_swell_cache()
    live = swell.get_swell_plan(csr, r=r)
    assert len(list(tmp_path.glob("torch_swell_*.npz"))) == 1
    swell.clear_swell_cache()
    loaded = swell.get_swell_plan(csr, r=r)
    assert "load" in swell.PLAN_TIMES and "slabs" not in swell.PLAN_TIMES
    for f in dataclasses.fields(live):
        a, b = getattr(live, f.name), getattr(loaded, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b), f.name
    x = torch.from_numpy(random_x_y(3001, 3001, seed=2, dtype=dtype)[0]).to(cuda_device)
    a, b = swell.swell_ax(live, x), swell.swell_ax(loaded, x)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dw4096", "epb1"])
def test_spgemm_on_card(cuda_device, name):
    """A @ A on the card: the host golden's pattern, values within 1e-12
    (|A|·|A|), the result on the card."""
    from spmv_acc_tpu_torch import spgemm
    from spmv_acc_tpu_torch.formats import example_like
    from spmv_acc_tpu_torch.ops.spgemm import spgemm_host

    host = example_like(name)
    c = spgemm(host.to(cuda_device), host.to(cuda_device))
    assert c.values.device.type == "cuda" and c.row_ptr.device.type == "cuda"
    rp, ci, v, shape = host.to_numpy()
    g_rp, g_ci, g_v, _ = spgemm_host(rp, ci, v, shape, rp, ci, v, shape)
    scale = spgemm_host(rp, ci, np.abs(v), shape, rp, ci, np.abs(v), shape)[2]
    c_rp, c_ci, c_v, _ = c.to_numpy()
    assert np.array_equal(c_rp, g_rp) and np.array_equal(c_ci, g_ci)
    assert (np.abs(c_v - g_v) <= 1e-12 * scale).all()


@pytest.fixture
def nccl_group(cuda_device, tmp_path):
    """A one-rank NCCL group on the card (one H100 is one device: NCCL
    refuses two ranks on one card)."""
    import torch.distributed as dist

    from spmv_acc_tpu_torch.parallel.multihost import init_distributed

    init_distributed(coordinator_address="file://" + str(tmp_path / "rendezvous"),
                     num_processes=1, process_id=0, device="cuda")
    try:
        yield cuda_device
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_dist_spmv_and_cg_on_card(nccl_group):
    """NCCL at world size 1: the all-gather and halo SpMV pass the f64 gate,
    dist_cg_solve reaches x_true, every block on the card."""
    from spmv_acc_tpu_torch.cli.solve import spdize
    from spmv_acc_tpu_torch.formats import banded_csr, random_x_y
    from spmv_acc_tpu_torch.formats.containers import CSR
    from spmv_acc_tpu_torch.models.cg import dist_cg_solve
    from spmv_acc_tpu_torch.ops.golden import host_spmv_plain
    from spmv_acc_tpu_torch.parallel import (dist_spmv, gather_padded, make_mesh, pad_vector,
                                             partition_rows, unpad_y, unpad_vector)
    from spmv_acc_tpu_torch.utils import verify_y

    csr = banded_csr(4000, bandwidth=9, seed=13)
    x = random_x_y(4000, 4000, seed=5)[0]
    mesh = make_mesh(1)
    part = partition_rows(csr, 1, balance=False)
    for halo in (True, False):
        y = dist_spmv(part, x, mesh, halo=halo)
        assert y.device.type == "cuda"
        assert verify_y(unpad_y(part, gather_padded(y, mesh)), host_spmv_plain(
            *csr.to_numpy()[:3], x)).ok
    rp, ci, v, _ = csr.to_numpy()
    spd = spdize(rp.astype(np.int64), ci.astype(np.int64), v, 4000)
    a = CSR.from_numpy(*spd, (4000, 4000))
    x_true = np.random.default_rng(3).standard_normal(4000)
    b = host_spmv_plain(*spd, x_true)
    pa = partition_rows(a, 1, balance=False)
    res = dist_cg_solve(pa, pad_vector(pa, b), mesh, tol=1e-10, max_iters=500)
    xs = unpad_vector(pa, gather_padded(res.x, mesh)).cpu().numpy()
    assert res.x.device.type == "cuda" and 0 < res.iters < 500
    assert np.linalg.norm(xs - x_true) < 1e-8 * np.linalg.norm(x_true)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("halo", [None, False])
def test_dist_swell_equals_swell_ax_on_card(nccl_group, dtype, halo):
    """dist_swell_spmv_fn over NCCL at world size 1 launches the swell kernel
    once a call and equals the single-device swell_ax bit for bit (the same
    slots in the same order; the halo path reads x through a rebased
    window); the serial baseline at D = 4 launches it 4 times, equal too."""
    from spmv_acc_tpu_torch.formats import fem_like_csr, random_x_y
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.parallel import make_mesh
    from spmv_acc_tpu_torch.parallel.dist_swell import (build_dist_swell, dist_swell_serial_fn,
                                                        dist_swell_spmv_fn, pad_global)

    m = 16384
    csr = fem_like_csr(m, m, 6 * m, block=3, seed=21, dtype=dtype).to(nccl_group)
    x = torch.from_numpy(random_x_y(m, m, seed=22, dtype=dtype)[0]).to(nccl_group)
    whole = swell.swell_ax(swell.get_swell_plan(csr), x)
    mesh = make_mesh(1)
    dsp = build_dist_swell(csr, 1, halo=halo, mesh=mesh)
    assert dsp.halo_ok == (halo is None)
    run = dist_swell_spmv_fn(dsp, mesh)
    key = ("f64" if dtype == np.float64 else "f32", dsp.r, 1)
    before = swell.LAUNCHES[key]
    y = run(pad_global(dsp, x).contiguous())
    torch.cuda.synchronize()
    assert swell.LAUNCHES[key] == before + 1
    assert torch.equal(y[:m].view(torch.uint8), whole.view(torch.uint8))
    d4 = build_dist_swell(csr, 4, halo=halo)
    before = swell.LAUNCHES[key]
    y4 = dist_swell_serial_fn(d4, nccl_group)(pad_global(d4, x))
    torch.cuda.synchronize()
    assert swell.LAUNCHES[key] == before + 4
    assert torch.equal(y4[:m].view(torch.uint8), whole.view(torch.uint8))


@pytest.mark.cuda
def test_dist_swell_cg_on_card(nccl_group):
    """dist_swell_cg_solve over NCCL at world size 1 takes cg_solve's
    iterations (the same kernel sums, dots all-reduced over one rank)."""
    from spmv_acc_tpu_torch.cli.solve import spdize
    from spmv_acc_tpu_torch.formats import fem_like_csr
    from spmv_acc_tpu_torch.formats.containers import CSR
    from spmv_acc_tpu_torch.models.cg import cg_solve
    from spmv_acc_tpu_torch.ops.golden import host_spmv_plain
    from spmv_acc_tpu_torch.parallel import make_mesh
    from spmv_acc_tpu_torch.parallel.dist_swell import dist_swell_cg_solve

    m = 8192
    rp, ci, v, _ = fem_like_csr(m, m, 6 * m, block=3, seed=31).to_numpy()
    spd = spdize(rp.astype(np.int64), ci.astype(np.int64), v, m)
    csr = CSR.from_numpy(*spd, (m, m), device=nccl_group)
    x_true = np.random.default_rng(32).uniform(-1, 1, size=m)
    b = torch.from_numpy(host_spmv_plain(*spd, x_true))
    res, dsp = dist_swell_cg_solve(csr, b, make_mesh(1), tol=1e-10, max_iters=300)
    ref = cg_solve(csr, b.to(nccl_group), tol=1e-10, max_iters=300, strategy="swell")
    assert res.iters == ref.iters and 0 < res.iters < 300
    assert np.linalg.norm(res.x[:m].cpu().numpy() - x_true) < 1e-7 * np.linalg.norm(x_true)


@pytest.mark.cuda
def test_dryrun_one_card(cuda_device):
    """The dry run in a spawned rank on the card (NCCL at world size 1)."""
    from spmv_acc_tpu_torch.dryrun import dryrun_multichip
    from spmv_acc_tpu_torch.parallel import spawn

    assert spawn(dryrun_multichip, 1, "cuda", 1, "cuda") == [None]


@pytest.mark.cuda
def test_entry_on_card(cuda_device):
    """entry()'s step on the card launches the float32 swell kernel once and
    matches its plain version within 1e-12 (|A|·|x|) plus one float32 ulp of
    each rounding: A @ x to float32, then the sum with y."""
    from spmv_acc_tpu_torch.entry import entry
    from spmv_acc_tpu_torch.formats import random_csr
    from spmv_acc_tpu_torch.ops import swell

    fn, (layout, x, y) = entry()
    assert layout.device.type == x.device.type == y.device.type == "cuda"
    before = swell.LAUNCHES[("f32", 1, 1)]
    a = fn(layout, x, y)
    torch.cuda.synchronize()
    assert swell.LAUNCHES[("f32", 1, 1)] == before + 1
    ax = swell.swell_ax_plain(layout, x)
    p = (ax + y).cpu().numpy().astype(np.float64)
    ax = ax.cpu().numpy().astype(np.float64)
    a = a.cpu().numpy().astype(np.float64)
    xs = x.cpu().numpy().astype(np.float64)
    bound = _row_bound(random_csr(512, 512, 4096, seed=7, dtype=np.float32), np.abs(xs))
    assert np.isfinite(a).all()
    assert (np.abs(a - p) <= 2.0**-23 * (np.abs(ax) + np.abs(p)) + 1e-12 * bound).all()


# ---- captured loops (utils/graphs.py) and the feedback kernel (F-1) on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["spmv", "rect", "spmm", "spmv big", "spmm big"])
def test_feedback_kernel_matches_plain_on_card(cuda_device, dtype, case):
    """F-1 against its plain version: x bit for bit where the multiplier rounds
    to 1 (the bench's data).  Where it does not (|s| ~ 1e11 in float64, 1e15 in
    float32) the float32 mean is summed in another order, 1e-5 relative at
    most, which moves the multiplier 1 + mean * 1e-30 by 1e-5 of mean * 1e-30:
    x within that plus 4 ulps."""
    from spmv_acc_tpu_torch.ops import feedback

    m, n, k = {"spmv": (100003, 100003, 1), "rect": (70001, 33, 1),
               "spmm": (30011, 30011, 8)}[case.split()[0]]
    scale = (1e11 if dtype == torch.float64 else 1e15) if case.endswith("big") else 1.0
    rng = np.random.default_rng(len(case))
    shape_ax, shape_x = ((m,), (n,)) if k == 1 else ((m, k), (n, k))
    ax = torch.from_numpy(rng.uniform(-1, 1, shape_ax) * scale).to(cuda_device, dtype)
    y = (torch.from_numpy(rng.uniform(-1, 1, shape_ax) * scale).to(cuda_device, dtype)
         if k == 1 else None)
    x = torch.from_numpy(rng.uniform(-1, 1, shape_x)).to(cuda_device, dtype)
    plain = feedback.feedback_plain(x, ax, y, 2.0, -0.5)
    feedback.LAUNCHES.clear()
    out = feedback.feedback_(x.clone(), ax, y, 2.0, -0.5)
    torch.cuda.synchronize()
    assert sum(feedback.LAUNCHES.values()) == 1
    if scale == 1.0:
        assert torch.equal(out, plain) and torch.equal(plain, x)
    else:
        s = (ax if y is None else 2.0 * ax - 0.5 * y).float()
        moved = float((s * s).mean()) * 1e-30
        assert not torch.equal(plain, x) and moved > 1e-9
        allowed = (1e-5 * moved + 4 * torch.finfo(dtype).eps) * plain.abs()
        assert ((out - plain).abs() <= allowed).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["below one block", "odd length", "boneS10", "rect", "spmm"])
@pytest.mark.parametrize("moves", [False, True])
def test_one_pass_feedback_on_card(cuda_device, dtype, case, moves):
    """The one-pass F-1 (one cooperative launch a call) against its plain
    version at sizes below one block (and below one vector), at lengths that
    are no multiple of the 16-B vector width, at boneS10's m and as SpMM:
    bit for bit where the multiplier rounds to 1, within 1e-5 of the
    multiplier's move plus 4 ulps where x moves (the float32 mean summed in
    another order); two calls give the same bits."""
    from spmv_acc_tpu_torch.ops import feedback

    m, n, k = {"below one block": (3, 5, 1), "odd length": (100003, 99999, 1),
               "boneS10": (914898, 914898, 1), "rect": (70001, 33, 1),
               "spmm": (30011, 30011, 8)}[case]
    scale = (1e11 if dtype == torch.float64 else 1e15) if moves else 1.0
    rng = np.random.default_rng(m + k)
    shape_ax, shape_x = ((m,), (n,)) if k == 1 else ((m, k), (n, k))
    ax = torch.from_numpy(rng.uniform(-1, 1, shape_ax) * scale).to(cuda_device, dtype)
    y = (torch.from_numpy(rng.uniform(-1, 1, shape_ax) * scale).to(cuda_device, dtype)
         if k == 1 else None)
    x = torch.from_numpy(rng.uniform(-1, 1, shape_x)).to(cuda_device, dtype)
    plain = feedback.feedback_plain(x, ax, y, 2.0, -0.5)
    feedback.LAUNCHES.clear()
    out = [feedback.feedback_(x.clone(), ax, y, 2.0, -0.5) for _ in range(2)]
    torch.cuda.synchronize()
    assert sum(feedback.LAUNCHES.values()) == 2
    assert torch.equal(out[0].view(torch.uint8), out[1].view(torch.uint8))
    if not moves:
        assert torch.equal(out[0], plain) and torch.equal(plain, x)
    else:
        s = (ax if y is None else 2.0 * ax - 0.5 * y).float()
        moved = float((s * s).mean()) * 1e-30
        assert not torch.equal(plain, x) and moved > 1e-9
        allowed = (1e-5 * moved + 4 * torch.finfo(dtype).eps) * plain.abs()
        assert ((out[0] - plain).abs() <= allowed).all()


@pytest.mark.cuda
def test_one_pass_feedback_captured_on_card(cuda_device):
    """F-1's cooperative launch inside a captured graph (``Loop``): the
    replays equal the same launches from the host bit for bit, on data that
    moves x, and count one launch a step."""
    from spmv_acc_tpu_torch.ops import feedback
    from spmv_acc_tpu_torch.utils.graphs import Loop

    rng = np.random.default_rng(9)
    ax = torch.from_numpy(rng.uniform(-1, 1, 200003) * 1e11).to(cuda_device)
    y = torch.from_numpy(rng.uniform(-1, 1, 200003) * 1e11).to(cuda_device)
    x = torch.from_numpy(rng.uniform(-1, 1, 200003)).to(cuda_device)
    loop = Loop(lambda v: feedback.feedback_(v, ax, y, 2.0, -0.5), x, unroll=4)
    loop.run(x, 11)  # the warm-ups and captures
    feedback.LAUNCHES.clear()
    got = loop.run(x, 11)
    torch.cuda.synchronize()
    assert feedback.LAUNCHES["f64"] == 11
    want = x.clone()
    for _ in range(11):
        feedback.feedback_(want, ax, y, 2.0, -0.5)
    assert not torch.equal(want, x) and torch.equal(got, want)


@pytest.mark.cuda
def test_captured_dist_swell_cg_block_on_card(nccl_group, monkeypatch):
    """dist_swell_cg_solve over NCCL at world size 1 with its blocks captured
    from the first iteration (the all-reduced dots inside the graphs): the
    iterations and x bit for bit the plain loop's (the same solve with every
    iteration plain; within 1e-12 if a COO tail's atomics keep the plain loop
    from repeating itself), the swell launches of every replay counted."""
    from spmv_acc_tpu_torch.cli.solve import spdize
    from spmv_acc_tpu_torch.formats import fem_like_csr
    from spmv_acc_tpu_torch.formats.containers import CSR
    from spmv_acc_tpu_torch.models import cg
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.ops.golden import host_spmv_plain
    from spmv_acc_tpu_torch.parallel import make_mesh
    from spmv_acc_tpu_torch.parallel.dist_swell import dist_swell_cg_solve

    m = 8192
    rp, ci, v, _ = fem_like_csr(m, m, 6 * m, block=3, seed=31).to_numpy()
    spd = spdize(rp.astype(np.int64), ci.astype(np.int64), v, m)
    csr = CSR.from_numpy(*spd, (m, m), device=nccl_group)
    b = torch.from_numpy(host_spmv_plain(*spd, np.random.default_rng(32).uniform(-1, 1, m)))
    mesh = make_mesh(1)
    monkeypatch.setattr(cg, "CG_EAGER_ITERS", 10 ** 9)
    plain = [dist_swell_cg_solve(csr, b, mesh, tol=1e-10, max_iters=300)[0] for _ in range(2)]
    monkeypatch.setattr(cg, "CG_EAGER_ITERS", 0)
    swell.LAUNCHES.clear()
    got, _ = dist_swell_cg_solve(csr, b, mesh, tol=1e-10, max_iters=300)
    torch.cuda.synchronize()
    assert got.iters == plain[0].iters and 0 < got.iters < 300
    if torch.equal(plain[0].x, plain[1].x):
        assert torch.equal(got.x, plain[0].x)
    else:
        assert float((got.x - plain[0].x).norm() / plain[0].x.norm()) <= 1e-12
    blocks = -(-got.iters // cg.CG_BLOCK)
    chunk_launches = sum(n for key, n in swell.LAUNCHES.items() if len(key) == 3)
    assert chunk_launches == 1 + blocks * cg.CG_BLOCK


@pytest.mark.cuda
def test_captured_dist_cg_and_scaling_step_on_card(nccl_group, monkeypatch):
    """dist_cg_solve over NCCL at world size 1, its all-gather path (forced:
    at world size 1 the halo path issues no collective) captured from the
    first iteration against the plain loop: the same iterations, x within
    1e-12 (index_add_'s atomics need not repeat); the weak-scaling step
    through Loop (an all-reduced max inside the graph) equal to its eager
    chain bit for bit, and timed by scaling_bench._loop_us."""
    from spmv_acc_tpu_torch.cli.solve import spdize
    from spmv_acc_tpu_torch.formats import banded_csr
    from spmv_acc_tpu_torch.formats.containers import CSR
    from spmv_acc_tpu_torch.models import cg
    from spmv_acc_tpu_torch.ops.golden import host_spmv_plain
    from spmv_acc_tpu_torch.parallel import make_mesh, pad_vector, partition_rows
    from spmv_acc_tpu_torch.parallel.dist_swell import (build_dist_swell, dist_swell_spmv_fn,
                                                        pad_global)
    from spmv_acc_tpu_torch.parallel.scaling_bench import _loop_us, _renormalised
    from spmv_acc_tpu_torch.utils.graphs import Loop

    rp, ci, v, _ = banded_csr(4000, bandwidth=9, seed=13).to_numpy()
    spd = spdize(rp.astype(np.int64), ci.astype(np.int64), v, 4000)
    a = CSR.from_numpy(*spd, (4000, 4000))
    b = host_spmv_plain(*spd, np.random.default_rng(3).standard_normal(4000))
    mesh = make_mesh(1)
    pa = partition_rows(a, 1, balance=False)
    monkeypatch.setattr(sys.modules["spmv_acc_tpu_torch.parallel.dist_spmv"], "halo_feasible",
                        lambda *args, **kw: False)
    monkeypatch.setattr(cg, "CG_EAGER_ITERS", 10 ** 9)
    plain = cg.dist_cg_solve(pa, pad_vector(pa, b), mesh, tol=1e-10, max_iters=500)
    monkeypatch.setattr(cg, "CG_EAGER_ITERS", 0)
    got = cg.dist_cg_solve(pa, pad_vector(pa, b), mesh, tol=1e-10, max_iters=500)
    assert got.iters == plain.iters and 0 < got.iters < 500
    assert float((got.x - plain.x).norm() / plain.x.norm()) <= 1e-12

    band = banded_csr(65536, bandwidth=17, seed=11).to(nccl_group)
    dsp = build_dist_swell(band, 1, mesh=mesh)
    step = _renormalised(dist_swell_spmv_fn(dsp, mesh), mesh.get_group())
    x = pad_global(dsp, torch.ones(band.cols, dtype=torch.float64, device=nccl_group))
    want = x
    for _ in range(21):
        want = step(want)
    assert torch.equal(Loop(step, x, unroll=8).run(x, 21), want)
    assert _loop_us(step, x, 20, nccl_group, mesh.get_group()) > 0


def _eager_chain(layout, x, y, n):
    """The chain as eager PyTorch ops: swell_ax, then the feedback out of place."""
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.ops.feedback import feedback_plain

    for _ in range(n):
        x = feedback_plain(x, swell.swell_ax(layout, x), y)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 300, 1500), (40000, 300, 9000)])
def test_captured_chain_equals_eager_on_card(cuda_device, shape):
    """make_swell_run's graph replays against the eager chain, bit for bit, at
    loop lengths below, at and past the graph length, with the launches of
    every replay counted."""
    from spmv_acc_tpu_torch.formats import random_csr, random_x_y
    from spmv_acc_tpu_torch.ops import feedback, swell
    from spmv_acc_tpu_torch.utils.graphs import UNROLL

    m, n, nnz = shape
    csr = random_csr(m, n, nnz, seed=m + n).to(cuda_device)
    x, y = (torch.from_numpy(a).to(cuda_device) for a in random_x_y(n, m, seed=2))
    layout = swell.get_swell_plan(csr)
    run = swell.make_swell_run(csr)
    for steps in (3, UNROLL, 2 * UNROLL + 5):
        run(x, y, steps)  # capture and warm-up launches
        swell.LAUNCHES.clear()
        feedback.LAUNCHES.clear()
        out = run(x, y, steps)
        torch.cuda.synchronize()
        assert swell.LAUNCHES[("f64", layout.r, 1)] == steps
        assert feedback.LAUNCHES["f64"] == steps
        assert torch.equal(out, _eager_chain(layout, x, y, steps))
    # the graphs point at the layout's tensors: run keeps them alive after the
    # plan cache lets go and the freed memory is reused
    want = _eager_chain(layout, x, y, 7)
    del layout
    swell.clear_swell_cache()
    gc.collect()
    torch.cuda.empty_cache()
    junk = torch.full((1 << 24,), float("nan"), dtype=torch.float64, device=cuda_device)
    assert torch.equal(run(x, y, 7), want)
    del junk


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
def test_captured_chain_moves_x_on_card(cuda_device, k):
    """On data that moves x (x and y scaled until the multiplier is 1 + 1e-9
    a step), the replayed chain equals the same steps launched from the host
    bit for bit, and the eager PyTorch chain within n·(1e-5·(multiplier - 1)
    + 4 ulps) relative (F-1's float32 mean is summed in another order)."""
    from spmv_acc_tpu_torch.formats import fem_like_csr, random_x_y
    from spmv_acc_tpu_torch.ops import feedback, swell
    from spmv_acc_tpu_torch.utils.graphs import UNROLL

    csr = fem_like_csr(3001, 3001, 90000, block=6, seed=5).to(cuda_device)
    layout = swell.get_swell_plan(csr)
    if k == 1:
        x, y = (torch.from_numpy(a).to(cuda_device) for a in random_x_y(3001, 3001, seed=2))
        product = functools.partial(swell.swell_ax, layout)
        run = swell.make_swell_run(csr)
    else:
        x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (3001, k))).to(cuda_device)
        y = None
        product = functools.partial(swell.swell_amx, layout)
        amx = swell.make_swell_amx_run(csr, k)
        run = lambda v, _, n: amx(v, n)  # noqa: E731
    s0 = product(x) if y is None else product(x) + y
    sigma = (1e21 / float((s0.float() ** 2).mean())) ** 0.5
    xm, ym = x * sigma, (None if y is None else y * sigma)
    n = UNROLL + 3
    got = run(xm, ym, n)
    steps, plain = xm.clone(), xm
    for _ in range(n):
        feedback.feedback_(steps, product(steps), ym)
        plain = feedback.feedback_plain(plain, product(plain), ym)
    s1 = product(xm) if y is None else product(xm) + ym
    mult = float((s1.float() ** 2).mean()) * 1e-30
    assert float(((got - xm).abs() / xm.abs()).max()) > 0.5 * n * mult > 1e-8
    assert torch.equal(got, steps)
    allowed = n * (1e-5 * mult + 4 * torch.finfo(torch.float64).eps)
    assert float(((got - plain).abs() / plain.abs()).max()) <= allowed


@pytest.mark.cuda
def test_cg_solve_plain_start_then_captured_on_card(cuda_device, monkeypatch):
    """cg_solve as called, with its plain start at several lengths (the
    hand-over to the captured blocks inside, at and past the solve's end):
    iterations and x bit for bit the eager loop's."""
    from spmv_acc_tpu_torch.models import cg
    from spmv_acc_tpu_torch.ops import swell

    csr, b = _cg_system(cuda_device)
    layout = swell.get_swell_plan(csr)
    M = cg.jacobi_preconditioner(csr)
    want = cg._cg_loop(lambda v: swell.swell_ax(layout, v), M, b, torch.zeros_like(b), 1e-10,
                       2000)
    assert want.iters > 2 * cg.CG_BLOCK
    for eager in (cg.CG_EAGER_ITERS, 1, want.iters - 3, want.iters, want.iters + 5):
        monkeypatch.setattr(cg, "CG_EAGER_ITERS", eager)
        got = cg.cg_solve(csr, b, tol=1e-10, max_iters=2000, strategy="swell", precond=M)
        assert got.iters == want.iters and torch.equal(got.x, want.x), eager


@pytest.mark.cuda
def test_captured_amx_chain_equals_eager_on_card(cuda_device):
    from spmv_acc_tpu_torch.formats import fem_like_csr
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.ops.feedback import feedback_plain

    csr = fem_like_csr(3001, 3001, 90000, block=6, seed=5).to(cuda_device)
    X = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (3001, 8))).to(cuda_device)
    layout = swell.get_swell_plan(csr)
    run = swell.make_swell_amx_run(csr, 8)
    ref = X
    for _ in range(37):
        ref = feedback_plain(ref, swell.swell_amx(layout, ref))
    assert torch.equal(run(X, 37), ref)


@pytest.mark.cuda
def test_time_device_loop_on_card(cuda_device):
    from spmv_acc_tpu_torch.utils.timer import time_device_loop

    x = torch.ones(1 << 16, dtype=torch.float64, device=cuda_device)
    per_us, carry = time_device_loop(lambda v: v * 0.5 + 1.0, x, iters=64)
    ref = x
    for _ in range(65):
        ref = ref * 0.5 + 1.0
    assert per_us > 0 and torch.equal(carry, ref)


@pytest.mark.cuda
def test_graph_us_replays_its_calls_on_card(cuda_device):
    """graph_us runs the function once to warm up, then replays its graph of
    ``calls`` calls once untimed and ``replays`` times timed."""
    from spmv_acc_tpu_torch.utils.timer import graph_us

    x = torch.zeros(1 << 16, dtype=torch.float64, device=cuda_device)
    us = graph_us(lambda: x.add_(1.0), calls=4, replays=3)
    torch.cuda.synchronize()
    assert us > 0 and bool((x == 1 + 4 * (1 + 3)).all())


def _cg_system(device, n=40):
    from spmv_acc_tpu_torch.formats import aniso_laplacian_csr
    from spmv_acc_tpu_torch.ops.golden import host_spmv

    host = aniso_laplacian_csr(n, n, 0.01)
    rp, ci, v, shape = host.to_numpy()
    x_true = np.random.default_rng(5).standard_normal(shape[0])
    b = host_spmv(1.0, 0.0, rp, ci, v, x_true, np.zeros(shape[0]))
    return host.to(device), torch.from_numpy(b).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["none", "jacobi", "ilu sweeps", "ilu swell", "ilu exact"])
def test_captured_cg_equals_eager_on_card(cuda_device, monkeypatch, precond):
    """cg_solve's captured blocks, from the first iteration, against the eager
    loop on the swell matvec: the same iterations and x bit for bit (the
    ILU solves run F-3, which repeats itself bit for bit)."""
    from spmv_acc_tpu_torch.models import cg
    from spmv_acc_tpu_torch.models.cg import _cg_loop, cg_solve, jacobi_preconditioner
    from spmv_acc_tpu_torch.ops import swell
    from spmv_acc_tpu_torch.ops import trisolve as tri

    monkeypatch.setattr(cg, "CG_EAGER_ITERS", 0)
    if precond == "ilu swell":
        monkeypatch.setattr(tri, "ILU_SWELL_MIN", 0)
    csr, b = _cg_system(cuda_device)
    if precond == "none":
        pre = None
    elif precond == "jacobi":
        pre = jacobi_preconditioner(csr)
    else:
        pre = tri.ilu0(csr, sweeps=0 if precond == "ilu exact" else 3)
        assert (pre.swell is not None) == (precond == "ilu swell")
    layout = swell.get_swell_plan(csr)
    M = pre.solve if isinstance(pre, tri.ILU0) else pre
    eager = [_cg_loop(lambda v: swell.swell_ax(layout, v), M, b, torch.zeros_like(b), 1e-10,
                      2000) for _ in range(2)]
    got = cg_solve(csr, b, tol=1e-10, max_iters=2000, strategy="swell", precond=pre)
    assert got.iters == eager[0].iters == eager[1].iters < 2000
    assert torch.equal(eager[0].x, eager[1].x) and torch.equal(got.x, eager[0].x)


@pytest.mark.cuda
def test_captured_cg_every_strategy_on_card(cuda_device, monkeypatch):
    """Every strategy runs CG as captured blocks on the card, from the first
    iteration (no host read inside the graph; flat's chunk spans come from
    the plan).  Several strategies sum with index_add_'s atomics, which need
    not repeat even eagerly, so iterations may differ by one and x by 1e-8
    relative (tol 1e-10, cond ~1e2)."""
    from spmv_acc_tpu_torch.dispatch import STRATEGIES, spmv
    from spmv_acc_tpu_torch.models import cg
    from spmv_acc_tpu_torch.models.cg import _cg_loop, cg_solve

    monkeypatch.setattr(cg, "CG_EAGER_ITERS", 0)
    csr, b = _cg_system(cuda_device, 24)
    for strategy in sorted(STRATEGIES - {"adaptive"}):
        eager = _cg_loop(lambda v: spmv(csr, v, strategy=strategy), None, b,
                         torch.zeros_like(b), 1e-10, 1000)
        got = cg_solve(csr, b, tol=1e-10, max_iters=1000, strategy=strategy)
        assert abs(got.iters - eager.iters) <= 1, strategy
        assert float((got.x - eager.x).norm() / eager.x.norm()) <= 1e-8, strategy


# ---- F-2, the CG update (csrc/cg_update.cu) against its plain version

def _cg_case(device, dtype, n, form, mask, seed):
    """A random CG carry of n rows with M = I, Jacobi or a read z, the mask
    none / active / inactive (rr below tol2), and the sums a phase reads."""
    rng = np.random.default_rng(seed)

    def vec(lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, n)).to(device, dtype)

    def scalar(v, dt=dtype):
        return torch.tensor(v, dtype=dt, device=device)

    carry = (vec(), vec(), vec(), scalar(rng.uniform(0.5, 2.0)), scalar(rng.uniform(0.5, 2.0)),
             scalar(5, torch.int64))
    ap = vec()
    inv = vec(0.5, 2.0) if form == "jacobi" else None
    z = vec() if form == "read" else None
    rr = float(carry[4])
    tol2 = {"none": None, "active": scalar(0.5 * rr), "inactive": scalar(2.0 * rr)}[mask]
    max_iters = None if mask == "none" else scalar(100, torch.int64)
    sums = torch.from_numpy(rng.uniform(0.5, 2.0, 3)).to(device, dtype)
    return carry, ap, inv, z, tol2, max_iters, sums


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [77, 100003, 1000003])
@pytest.mark.parametrize("form", ["identity", "jacobi", "read"])
@pytest.mark.parametrize("mask", ["none", "active", "inactive"])
def test_cg_update_phases_match_plain_on_card(cuda_device, dtype, n, form, mask):
    """Each F-2 phase against its plain version from the same carry and sums,
    at n below one block, not a multiple of it, and past the grid's cap
    (every thread walks several elements).  Dots within 1e-12 (float64) or
    1e-5 (float32) of sum|a_i c_i| (another summation order); x, r and p
    within 1e-12 (|alpha||p| + |x|) elementwise, plus one ulp in float32 (the
    same IEEE operations, given the same sums); rz, rr and it equal.
    Inactive: nothing written.  Two launches give the same bits."""
    from spmv_acc_tpu_torch.ops import cg_update as cu

    carry, ap, inv, z, tol2, max_iters, sums = _cg_case(cuda_device, dtype, n, form, mask,
                                                         n + len(form) + len(mask))
    f32 = dtype == torch.float32
    dot_tol = 1e-5 if f32 else 1e-12
    ulp = torch.finfo(torch.float32).eps if f32 else 0.0
    active = mask != "inactive"

    def work():
        w = cu.Work(carry[0])
        w.sums.copy_(sums)
        return w

    def copy(c):
        return tuple(t.clone() for t in c)

    def close(got, want, scale):
        return bool(((got - want).abs() <= 1e-12 * scale + ulp * want.abs()).all())

    # cg_dot, twice
    wk, wk2, wp = work(), work(), work()
    cu.LAUNCHES.clear()
    cu.cg_dot(carry[2], ap, wk, cu.PAP)
    cu.cg_dot(carry[2], ap, wk2, cu.PAP)
    cu.cg_dot_plain(carry[2], ap, wp, cu.PAP)
    torch.cuda.synchronize()
    assert cu.LAUNCHES == {(("f32" if f32 else "f64"), "dot"): 2}
    assert torch.equal(wk.sums, wk2.sums)
    assert abs(float(wk.sums[0] - wp.sums[0])) <= dot_tol * float((carry[2] * ap).abs().sum())

    # cg_xr from the same sums, twice
    with_rz = form != "read"
    ck, ck2, cp = copy(carry), copy(carry), copy(carry)
    wk, wk2, wp = work(), work(), work()
    cu.cg_xr(ck, ap, wk, inv, with_rz, tol2, max_iters)
    cu.cg_xr(ck2, ap, wk2, inv, with_rz, tol2, max_iters)
    cu.cg_xr_plain(cp, ap, wp, inv, with_rz, tol2, max_iters)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(ck + (wk.sums,), ck2 + (wk2.sums,)))
    if not active:
        assert all(torch.equal(a, b) for a, b in zip(ck + (wk.sums,), carry + (sums,)))
    alpha = (carry[3] / sums[0]).abs()
    assert close(ck[0], cp[0], alpha * carry[2].abs() + carry[0].abs())
    assert close(ck[1], cp[1], alpha * ap.abs() + carry[1].abs())
    rn = cp[1]
    zn = rn if inv is None else inv * rn
    for slot, scale in ((cu.RZ, (rn * zn).abs().sum()), (cu.RR, (rn * rn).sum())):
        if slot == cu.RZ and not with_rz:
            assert torch.equal(wk.sums[slot], sums[slot])
            continue
        assert abs(float(wk.sums[slot] - wp.sums[slot])) <= dot_tol * float(scale) + ulp * float(
            wp.sums[slot].abs())

    # cg_p from the plain cg_xr's carry and sums, twice
    ck, ck2 = copy(cp), copy(cp)
    wk, wk2 = cu.Work(carry[0]), cu.Work(carry[0])
    for w in (wk, wk2):
        w.sums.copy_(wp.sums)
    cu.cg_p(ck, wk, inv, z, tol2, max_iters)
    cu.cg_p(ck2, wk2, inv, z, tol2, max_iters)
    cu.cg_p_plain(cp, wp, inv, z, tol2, max_iters)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(ck, ck2))
    assert all(torch.equal(a, b) for a, b in zip(ck[3:], cp[3:]))
    zp = z if z is not None else (ck[1] if inv is None else inv * ck[1])
    beta = (wp.sums[1] / carry[3]).abs()
    assert close(ck[2], cp[2], beta * carry[2].abs() + zp.abs())
    assert int(ck[5]) == 5 + active
    if not active:
        assert torch.equal(ck[2], carry[2]) and torch.equal(ck[3], carry[3])


@pytest.mark.cuda
@pytest.mark.parametrize("precond,dtype", [("none", torch.float64), ("jacobi", torch.float64),
                                          ("ilu sweeps", torch.float64),
                                          ("none", torch.float32), ("jacobi", torch.float32)])
def test_cg_solve_launches_f2_on_card(cuda_device, monkeypatch, precond, dtype):
    """cg_solve on the card runs F-2's fused form at every iteration, plain
    and masked: one cg_step launch an iteration with M = I or Jacobi,
    cg_dot_xr and cg_dot_p around M with ILU, and no phase; the captured
    blocks give the eager loop's iterations and x bit for bit, in both
    dtypes."""
    from spmv_acc_tpu_torch.models import cg
    from spmv_acc_tpu_torch.ops import cg_update, swell
    from spmv_acc_tpu_torch.ops import trisolve as tri

    monkeypatch.setattr(tri, "ILU_SWELL_MIN", 0)
    csr, b = _cg_system(cuda_device)
    csr, b = csr.astype(dtype), b.to(dtype)
    pre = (None if precond == "none" else cg.jacobi_preconditioner(csr) if precond == "jacobi"
           else tri.ilu0(csr, sweeps=3))
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    layout = swell.get_swell_plan(csr)
    M = pre.solve if isinstance(pre, tri.ILU0) else pre
    eager = cg._cg_loop(lambda v: swell.swell_ax(layout, v), M, b, torch.zeros_like(b), tol,
                        2000)
    for eager_iters in (10 ** 9, 0):
        monkeypatch.setattr(cg, "CG_EAGER_ITERS", eager_iters)
        cg_update.LAUNCHES.clear()
        got = cg.cg_solve(csr, b, tol=tol, max_iters=2000, strategy="swell", precond=pre)
        torch.cuda.synchronize()
        dk = "f64" if dtype == torch.float64 else "f32"
        keys = ["dot_xr", "dot_p"] if precond == "ilu sweeps" else ["step"]
        steps = cg_update.LAUNCHES[(dk, keys[0])]
        assert got.iters == eager.iters and torch.equal(got.x, eager.x)
        assert steps >= got.iters > 0
        if eager_iters:
            assert steps == got.iters
        assert dict(cg_update.LAUNCHES) == {(dk, k): steps for k in keys}


@pytest.mark.cuda
def test_dist_cg_launches_f2_on_card(nccl_group, monkeypatch):
    """dist_cg_solve over NCCL at world size 1, plain and captured: F-2's
    three phases at every iteration (cg_dot, cg_xr, cg_p: three launches,
    the all-reduces between them), never the fused form; the same
    iterations and x."""
    from spmv_acc_tpu_torch.cli.solve import spdize
    from spmv_acc_tpu_torch.formats import banded_csr
    from spmv_acc_tpu_torch.formats.containers import CSR
    from spmv_acc_tpu_torch.models import cg
    from spmv_acc_tpu_torch.ops import cg_update
    from spmv_acc_tpu_torch.ops.golden import host_spmv_plain
    from spmv_acc_tpu_torch.parallel import make_mesh, pad_vector, partition_rows

    rp, ci, v, _ = banded_csr(4000, bandwidth=9, seed=13).to_numpy()
    spd = spdize(rp.astype(np.int64), ci.astype(np.int64), v, 4000)
    pa = partition_rows(CSR.from_numpy(*spd, (4000, 4000)), 1, balance=False)
    b = host_spmv_plain(*spd, np.random.default_rng(3).standard_normal(4000))
    mesh = make_mesh(1)
    runs = []
    for eager_iters in (10 ** 9, 0):
        monkeypatch.setattr(cg, "CG_EAGER_ITERS", eager_iters)
        cg_update.LAUNCHES.clear()
        runs.append(cg.dist_cg_solve(pa, pad_vector(pa, b), mesh, tol=1e-10, max_iters=500))
        torch.cuda.synchronize()
        steps = cg_update.LAUNCHES[("f64", "xr")]
        assert steps >= runs[-1].iters > 0
        assert dict(cg_update.LAUNCHES) == {("f64", k): steps for k in ("dot", "xr", "p")}
    assert runs[0].iters == runs[1].iters
    assert float((runs[1].x - runs[0].x).norm() / runs[0].x.norm()) <= 1e-12


# ---- F-2's fused form (cg_step, cg_dot_xr, cg_dot_p) against its plain version

def _fused_inputs(device, dtype, n, form, mask, seed, misaligned):
    """A random carry of n rows (views one element into their storage where
    ``misaligned``: not 16-B aligned), Ap, inv (Jacobi) or z (general), the
    mask none / active / off by tol2 / off by max_iters, and the sums."""
    rng = np.random.default_rng(seed)
    k = int(misaligned)

    def vec(lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, n + k)).to(device, dtype)[k:]

    def scalar(v, dt=dtype):
        return torch.tensor(v, dtype=dt, device=device)

    carry = (vec(), vec(), vec(), scalar(rng.uniform(0.5, 2.0)), scalar(rng.uniform(0.5, 2.0)),
             scalar(5, torch.int64))
    ap = vec()
    inv = vec(0.5, 2.0) if form == "jacobi" else None
    z = vec() if form == "general" else None
    rr = float(carry[4])
    tol2 = {"none": None, "active": scalar(0.5 * rr), "off by tol2": scalar(2.0 * rr),
            "off by max_iters": scalar(0.5 * rr)}[mask]
    max_iters = None if mask == "none" else scalar(5 if mask == "off by max_iters" else 100,
                                                   torch.int64)
    sums = torch.from_numpy(rng.uniform(0.5, 2.0, 3)).to(device, dtype)
    return carry, ap, inv, z, tol2, max_iters, sums


def _run_fused(cu, carry, ap, inv, z, tol2, max_iters, sums):
    """The fused form on a copy of ``carry``: (the carry, the sums)."""
    c = tuple(t.clone() for t in carry)
    w = cu.Work(carry[0])
    w.sums.copy_(sums)
    if z is None:
        cu.cg_step(c, ap, w, inv, tol2, max_iters)
    else:
        cu.cg_dot_xr(c, ap, w, tol2, max_iters)
        cu.cg_dot_p(c, z, w, tol2, max_iters)
    return c, w.sums


def check_fused(cu, carry, ap, inv, z, tol2, max_iters, sums):
    """The fused kernel against its plain version from one carry, or an
    AssertionError: the sums within 1e-12 (float64) or 1e-5 (float32) of
    sum|a_i c_i| of the plain version's (p·Ap from the same p and Ap; r·z and
    r·r of the same new r, another summation order); x, r and p within 1e-12
    (|alpha||p| + |x|) elementwise plus one float32 ulp of the plain
    version's given the kernel's sums (the same IEEE operations); rz, rr and
    it the kernel's sums and the count.  Masked off: nothing written.  Two
    launches: the same bits.  Returns max|kernel - plain| of x, r, p."""
    f32 = carry[0].dtype == torch.float32
    dot_tol = 1e-5 if f32 else 1e-12
    ulp = torch.finfo(torch.float32).eps if f32 else 0.0
    got, ks = _run_fused(cu, carry, ap, inv, z, tol2, max_iters, sums)
    got2, ks2 = _run_fused(cu, carry, ap, inv, z, tol2, max_iters, sums)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got + (ks,), got2 + (ks2,))), "two launches"
    active = tol2 is None or bool((carry[4] > tol2) & (carry[5] < max_iters))
    if not active:
        assert all(torch.equal(a, b) for a, b in zip(got + (ks,), carry + (sums,))), "masked"
        return 0.0
    # the plain version given the kernel's sums
    want, w = tuple(t.clone() for t in carry), cu.Work(carry[0])
    w.sums.copy_(ks)
    cu.cg_xr_plain(want, ap, w, inv, z is None, tol2, max_iters)
    plain_sums = w.sums.clone()
    w.sums[1:] = ks[1:]
    cu.cg_p_plain(want, w, inv, z, tol2, max_iters)
    rn = want[1]
    zn = z if z is not None else (rn if inv is None else inv * rn)
    pap = torch.dot(carry[2], ap)
    for k, (got_s, want_s, scale) in enumerate((
            (ks[0], pap, (carry[2] * ap).abs().sum()),
            (ks[1], torch.dot(rn, zn), (rn * zn).abs().sum()),
            (ks[2], plain_sums[2], (rn * rn).sum()))):
        assert abs(float(got_s - want_s)) <= dot_tol * float(scale), f"sums[{k}]"
    alpha = (carry[3] / ks[0]).abs()
    beta = (ks[1] / carry[3]).abs()
    gaps = []
    for name, g, wv, scale in (("x", got[0], want[0], alpha * carry[2].abs() + carry[0].abs()),
                               ("r", got[1], want[1], alpha * ap.abs() + carry[1].abs()),
                               ("p", got[2], want[2], beta * carry[2].abs() + zn.abs())):
        gap = (g - wv).abs()
        gaps.append(float(gap.max()))
        assert bool((gap <= 1e-12 * scale + ulp * wv.abs()).all()), name
    assert torch.equal(got[3], ks[1]) and torch.equal(got[4], ks[2]) and int(got[5]) == 6
    return max(gaps)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,misaligned", [(23560, False), (262144, False), (4194319, False),
                                          (100003, False), (262144, True), (77, True)])
@pytest.mark.parametrize("form", ["identity", "jacobi", "general"])
@pytest.mark.parametrize("mask", ["none", "active", "off by tol2", "off by max_iters"])
def test_fused_cg_update_matches_plain_on_card(cuda_device, dtype, n, misaligned, form, mask):
    """cg_step (identity, Jacobi) and cg_dot_xr + cg_dot_p (general) against
    their plain versions (``check_fused``) at af23560's and aniso 512^2's n,
    past what the grid holds in registers (4,194,319: the walk that reads
    again), an odd n (the ragged tail) and views that are not 16-B aligned
    (one element at a time); each launch counted once."""
    from spmv_acc_tpu_torch.ops import cg_update as cu

    args = _fused_inputs(cuda_device, dtype, n, form, mask, n + len(form) + len(mask), misaligned)
    assert misaligned == (args[0][0].data_ptr() % 16 != 0)
    cu.LAUNCHES.clear()
    check_fused(cu, *args)
    dk = "f64" if dtype == torch.float64 else "f32"
    keys = ["dot_xr", "dot_p"] if form == "general" else ["step"]
    assert dict(cu.LAUNCHES) == {(dk, k): 2 for k in keys}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["jacobi", "general"])
def test_fused_cg_update_captured_on_card(cuda_device, form):
    """A CUDA graph of 12 captured fused steps (the last 3 masked off by
    max_iters) replays to the bits of the same 12 steps launched from the
    host."""
    from spmv_acc_tpu_torch.ops import cg_update as cu

    carry, ap, inv, z, tol2, _, _ = _fused_inputs(cuda_device, torch.float64, 262144, form,
                                                  "active", 3, False)
    max_iters = torch.tensor(5 + 9, dtype=torch.int64, device=cuda_device)

    def steps(c, w):
        for _ in range(12):
            if z is None:
                cu.cg_step(c, ap, w, inv, tol2, max_iters)
            else:
                cu.cg_dot_xr(c, ap, w, tol2, max_iters)
                cu.cg_dot_p(c, z, w, tol2, max_iters)

    host, wh = tuple(t.clone() for t in carry), cu.Work(carry[0])
    steps(host, wh)
    graphed, wg = tuple(t.clone() for t in carry), cu.Work(carry[0])
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        steps(graphed, wg)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(graphed, carry))  # captured, not run
    g.replay()
    torch.cuda.synchronize()
    assert int(host[5]) == 14
    assert all(torch.equal(a, b) for a, b in zip(graphed + (wg.sums,), host + (wh.sums,)))


# ---- F-3, the triangular solves (csrc/trisolve.cu) against their plain version

def _f3_factors(name):
    """(host CSR arrays, combined ILU(0) values) of an F-3 test system; "wide"
    is a lower triangle whose first level holds 3000 rows (the grid form)."""
    from spmv_acc_tpu_torch.cli.solve import spdize
    from spmv_acc_tpu_torch.formats import aniso_laplacian_csr, coo_to_csr_arrays, example_like
    from spmv_acc_tpu_torch.ops import trisolve as tri

    if name == "wide":
        rng = np.random.default_rng(3)
        m = 5000
        deps = rng.integers(0, 3000, size=(2000, 3))
        rows = np.concatenate([np.arange(m), np.repeat(np.arange(3000, m), 3)])
        cols = np.concatenate([np.arange(m), deps.ravel()])
        vals = np.concatenate([rng.random(m) + 1.0, rng.standard_normal(6000)])
        rp, ci, v = coo_to_csr_arrays(rows, cols, vals, (m, m))
        return (rp, ci, v, (m, m)), v
    if name == "aniso48":
        rp, ci, v, shape = aniso_laplacian_csr(48, 48, 0.01).to_numpy()
    else:  # dw4096-SPD
        rp, ci, v, (m, _) = example_like("dw4096").to_numpy()
        rp, ci, v = spdize(rp.astype(np.int64), ci.astype(np.int64), v, m)
        shape = (m, m)
    return (rp, ci, v, shape), tri.ilu0_host(rp, ci, v, shape)


def _f3_plan_pairs(name, device):
    """[(plan on the card, the same plan on the CPU)] for L (unit diagonal)
    and U, or the one lower factor of "wide"."""
    from spmv_acc_tpu_torch.ops import trisolve as tri

    (rp, ci, _, shape), lu = _f3_factors(name)
    kinds = [(True, False)] if name == "wide" else [(True, True), (False, False)]
    return [tuple(tri.analyze_trisolve(rp, ci, lu, shape, lower=lower, unit_diag=unit,
                                       device=dev) for dev in (device, "cpu"))
            for lower, unit in kinds]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["aniso48", "dw4096-SPD", "wide"])
@pytest.mark.parametrize("form", ["as planned", "grid"])
def test_f3_matches_plain_on_card(cuda_device, monkeypatch, dtype, name, form):
    """tri_levels (one block where the widest level fits 1024 rows, else the
    cooperative grid; "grid" forces the grid on every plan) and tri_sweeps
    (0, 1, 3 sweeps) against the plain versions run on a CPU copy of the
    plan: bit for bit, in both dtypes; a second launch gives the same bits;
    one launch a call, counted by form."""
    from spmv_acc_tpu_torch.ops import trisolve as tri

    if form == "grid":
        monkeypatch.setattr(tri, "_BLOCK_MAX", 0)
    dk = "f64" if dtype == torch.float64 else "f32"
    for plan, cplan in _f3_plan_pairs(name, cuda_device):
        if name == "dw4096-SPD":
            assert int(plan.dep_len.max()) >= 3
        b_host = torch.from_numpy(np.random.default_rng(plan.m).standard_normal(plan.m)).to(dtype)
        b = b_host.to(cuda_device)
        key = "levels_grid" if plan.widest_level > tri._BLOCK_MAX else "levels_block"
        tri.LAUNCHES.clear()
        y1, y2 = tri.trisolve(plan, b), tri.trisolve(plan, b)
        torch.cuda.synchronize()
        assert dict(tri.LAUNCHES) == {(dk, key): 2}
        want = tri.trisolve_plain(cplan, b_host)
        assert y1.dtype == dtype and torch.equal(y1.cpu(), want) and torch.equal(y1, y2)
        for sweeps in (0, 1, 3):
            tri.LAUNCHES.clear()
            s1, s2 = tri.trisolve_sweeps(plan, b, sweeps), tri.trisolve_sweeps(plan, b, sweeps)
            torch.cuda.synchronize()
            assert dict(tri.LAUNCHES) == {(dk, "sweeps"): 2}
            assert torch.equal(s1.cpu(), tri.trisolve_sweeps_plain(cplan, b_host, sweeps))
            assert torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_f3_past_the_level_cap_on_card(cuda_device, monkeypatch, dtype):
    """A factor past _EXACT_MAX_LEVELS: trisolve is one tri_sweeps launch of
    num_levels sweeps, the plain version's bits."""
    from spmv_acc_tpu_torch.ops import trisolve as tri

    monkeypatch.setattr(tri, "_EXACT_MAX_LEVELS", 8)
    dk = "f64" if dtype == torch.float64 else "f32"
    for plan, cplan in _f3_plan_pairs("aniso48", cuda_device):
        assert plan.rows_sorted is None and plan.num_levels > 8
        b_host = torch.from_numpy(np.random.default_rng(4).standard_normal(plan.m)).to(dtype)
        tri.LAUNCHES.clear()
        y = tri.trisolve(plan, b_host.to(cuda_device))
        torch.cuda.synchronize()
        assert dict(tri.LAUNCHES) == {(dk, "sweeps"): 1}
        assert torch.equal(y.cpu(), tri.trisolve_plain(cplan, b_host))


@pytest.mark.cuda
def test_f3_argument_checks_on_card(cuda_device):
    """A non-contiguous vector and a vector on another device than the plan
    raise before any launch."""
    from spmv_acc_tpu_torch.ops import trisolve as tri

    plan, cplan = _f3_plan_pairs("aniso48", cuda_device)[0]
    b = torch.zeros(2 * plan.m, dtype=torch.float64, device=cuda_device)
    tri.LAUNCHES.clear()
    with pytest.raises(ValueError, match="must be contiguous"):
        tri.trisolve(plan, b[::2])
    with pytest.raises(ValueError, match="the plan on cuda"):
        tri.trisolve(plan, torch.zeros(plan.m, dtype=torch.float64))
    with pytest.raises(ValueError, match="the plan on cpu"):
        tri.trisolve_sweeps(cplan, b[:plan.m], 2)
    assert not tri.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["ilu exact", "ilu sweeps"])
def test_cg_solve_launches_f3_on_card(cuda_device, monkeypatch, precond):
    """cg_solve with ILU(0) on the gather path: two F-3 launches an apply
    (one a factor), no index_add_, in the plain loop (1 + iterations
    applies) and in captured blocks, whose x is the plain loop's bit for bit."""
    from spmv_acc_tpu_torch.models import cg
    from spmv_acc_tpu_torch.ops import trisolve as tri

    monkeypatch.setattr(tri, "ILU_SWELL_MIN", 1 << 60)
    csr, b = _cg_system(cuda_device)
    pre = tri.ilu0(csr, sweeps=0 if precond == "ilu exact" else 3)
    assert pre.swell is None
    keys = ({("f64", "levels_block")} if precond == "ilu exact" else {("f64", "sweeps")})

    def no_index_add(*a, **k):
        raise AssertionError("index_add_ on the ILU path")

    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "index_add_", no_index_add)
        pre.solve(b)
    runs = {}
    for eager_iters in (10 ** 9, 0):
        monkeypatch.setattr(cg, "CG_EAGER_ITERS", eager_iters)
        tri.LAUNCHES.clear()
        got = cg.cg_solve(csr, b, tol=1e-10, max_iters=2000, strategy="swell", precond=pre)
        torch.cuda.synchronize()
        assert set(tri.LAUNCHES) == keys and 0 < got.iters < 2000
        launches = sum(tri.LAUNCHES.values())
        if eager_iters:
            assert launches == 2 * (got.iters + 1)
        else:
            assert launches % 2 == 0 and launches >= 2 * (got.iters + 1)
        runs[eager_iters] = got
    assert runs[0].iters == runs[10 ** 9].iters and torch.equal(runs[0].x, runs[10 ** 9].x)

