"""Package-level checks of the port: it never imports JAX, its kernels are built
for Hopper from the repo's CUDA sources, and (on a card) the swell, tile and
ELL row-sum kernels match their plain versions.

The ``cuda`` tests need an NVIDIA GPU and skip without one; run them there with
``python -m pytest tests/test_torch_package.py -m cuda --noconftest`` (the
shared conftest imports JAX, which the card's machine need not have)."""

import ast
import os

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
