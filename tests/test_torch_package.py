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
    entry, argtypes = _build.SOURCES[src]
    assert os.path.dirname(src) == os.path.join(PKG, "csrc")
    with open(src) as f:
        text = f.read()
    assert f'extern "C" int {entry}(' in text and "cudaGetLastError" in text
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
    """ell_rowsum at every vector size against ell_rowsum_plain, same bounds."""
    from spmv_acc_tpu_torch.formats import csr_to_ell, powerlaw_csr, random_x_y
    from spmv_acc_tpu_torch.ops import vector_row as vr

    csr = powerlaw_csr(3000, 3000, avg_nnz=12, seed=9, dtype=dtype).to(cuda_device)
    x = random_x_y(3000, 3000, seed=3, dtype=dtype)[0]
    ell = csr_to_ell(csr)
    key = ("f64" if dtype == np.float64 else "f32", vs)
    before = vr.LAUNCHES[key]
    a = vr._launch(ell, torch.from_numpy(x).to(cuda_device), vs)
    p = vr.ell_rowsum_plain(ell, torch.from_numpy(x).to(cuda_device))
    torch.cuda.synchronize()
    assert vr.LAUNCHES[key] == before + 1
    a, p = (t.cpu().numpy().astype(np.float64)[:3000] for t in (a, p))
    ulp = 0.0 if dtype == np.float64 else 2.0**-23
    assert (np.abs(a - p) <= ulp * np.abs(p) + 1e-12 * _row_bound(csr, x)).all()
