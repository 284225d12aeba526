"""The benchmark's imports, matrices, byte counts, readers and trace reduction,
on the CPU at small sizes."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import inputs, peaks, readers, reference, trace
from perfbench.matrices import fem_like, hpcg27
from perfbench.tests.helpers import kind_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PB = os.path.join(ROOT, "perfbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "spmv_acc_tpu"}
# the yardstick: none of these may import the program
YARDSTICK = ["reference.py", "inputs.py", "peaks.py", "readers.py", "trace.py",
             "matrices/fem_like.py", "matrices/hpcg27.py"]


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names += [node.module] + [f"{node.module}.{a.name}" for a in node.names]
    return names


def _sources():
    for d, _, files in os.walk(PB):
        for f in files:
            if f.endswith(".py") and "__pycache__" not in d:
                yield os.path.join(d, f)


def test_no_jax_no_bench_import():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
            assert not name.startswith("spmv_acc_tpu_torch.bench"), (path, name)


@pytest.mark.parametrize("rel", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(rel):
    for name in _imports(os.path.join(PB, rel)):
        assert name.split(".")[0] != "spmv_acc_tpu_torch", (rel, name)


def test_harness_and_reference_load_no_jax():
    code = ("import sys; import perfbench.run, perfbench.reference, perfbench.calibrate, "
            "perfbench.trace; from perfbench.matrices import fem_like, hpcg27; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'spmv_acc_tpu', 'spmv_acc_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def _csr(arrays):
    import scipy.sparse as sp

    rp, ci, v, shape = arrays
    return sp.csr_matrix((v, ci, rp), shape=shape)


@pytest.mark.parametrize("grid", [(6, 5, 4), (3, 3, 3), (7, 2, 5)])
def test_hpcg27_shape_and_operator(grid):
    cfg = dict(zip(("nx", "ny", "nz"), grid))
    arrays = hpcg27.build(cfg)
    nx, ny, nz = grid
    a = _csr(arrays)
    assert a.shape == (nx * ny * nz,) * 2
    assert a.nnz == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    assert (a != a.T).nnz == 0 and np.all(a.diagonal() == 26)
    assert np.all(np.diff(arrays[1][arrays[0][0]:arrays[0][1]]) > 0)  # sorted columns
    x = torch.rand(a.shape[0], dtype=torch.float64)
    ref = hpcg27.Operator(cfg, None, "cpu")(x).numpy()
    np.testing.assert_allclose(a @ x.numpy(), ref, rtol=0, atol=1e-12)


def test_hpcg104_config_states_its_size():
    cfg = json.load(open(os.path.join(PB, "configs", "hpcg104.json")))
    assert cfg["rows"] == 104 ** 3 == 1_124_864
    assert cfg["nnz"] == (3 * 104 - 2) ** 3 == 29_791_000


def test_hpcg27_ilu0_equals_the_ports_factor():
    from spmv_acc_tpu_torch.ops.trisolve import ilu0_host

    cfg = {"nx": 6, "ny": 5, "nz": 4}
    rp, ci, v, shape = hpcg27.build(cfg)
    lu = ilu0_host(rp, ci, v, shape)
    c = hpcg27.ilu0_coeffs(cfg)
    nx, ny = cfg["nx"], cfg["ny"]
    rows = np.repeat(np.arange(shape[0]), np.diff(rp))
    cols = ci.astype(np.int64)
    k = [hpcg27.OFFSETS.index(t) for t in zip(cols // (nx * ny) - rows // (nx * ny),
                                                (cols // nx) % ny - (rows // nx) % ny,
                                                cols % nx - rows % nx)]
    mine = c[k, rows // (nx * ny), (rows // nx) % ny, rows % nx]
    np.testing.assert_array_equal(mine, lu)


def test_hpcg27_sweeps_equal_the_ports_apply():
    from spmv_acc_tpu_torch import CSR
    from spmv_acc_tpu_torch.ops.trisolve import ilu0

    cfg = {"nx": 5, "ny": 4, "nz": 6}
    rp, ci, v, shape = hpcg27.build(cfg)
    port = ilu0(CSR.from_numpy(rp, ci, v, shape), sweeps=3)
    mine = hpcg27.ILU0Sweeps(cfg, hpcg27.ilu0_coeffs(cfg), 3, "cpu")
    r = torch.rand(shape[0], dtype=torch.float64)
    torch.testing.assert_close(mine(r), port.solve(r), rtol=1e-13, atol=1e-13)


def test_fem_like_is_the_ports_stand_in():
    from spmv_acc_tpu_torch.formats.generate import EXAMPLE_SHAPES, fem_like_csr

    cfg = json.load(open(os.path.join(PB, "configs", "boneS10.json")))
    # the port's table holds the symmetric file's stored triangle; the matrix
    # mirrors it, its diagonal once
    rows, cols, stored = EXAMPLE_SHAPES["boneS10"]
    assert (cfg["rows"], cfg["cols"], cfg["nnz"]) == (rows, cols, 2 * stored - rows) == (
        914_898, 914_898, 55_468_422)
    # the published shape is too large to make here: the same code at a smaller one
    small = dict(cfg, rows=9_000, cols=9_000, nnz=277_000)
    rp, ci, v, shape = fem_like.build(small)
    port = fem_like_csr(9_000, 9_000, 277_000, block=cfg["block"],
                        spread_frac=cfg["spread_frac"], seed=cfg["data_seed"]).to_numpy()
    assert rp[-1] == 277_000 and shape == (9_000, 9_000)
    for mine, theirs in zip((rp, ci, v), port[:3]):
        np.testing.assert_array_equal(mine, theirs)
    x = torch.rand(9_000, dtype=torch.float64)
    ref = fem_like.Operator(small, (rp, ci, v, shape), "cpu")(x).numpy()
    np.testing.assert_allclose(_csr((rp, ci, v, shape)) @ x.numpy(), ref, atol=1e-12)


def test_byte_models():
    # the reference's model of one SpMV, and the bounds at 3352.32 GB/s
    assert peaks.spmv_bytes(914_898, 55_468_422) == 683_919_028
    assert peaks.spmv_bytes(1_124_864, 29_791_000) == 379_989_284
    assert abs(peaks.spmv_bytes(914_898, 55_468_422) / 3352.32e3 - 204.01) < 0.01
    assert abs(peaks.spmv_bytes(1_124_864, 29_791_000) / 3352.32e3 - 113.35) < 0.01
    assert peaks.csr_bytes(10, 30) == 8 * 30 + 4 * (30 + 11)


@pytest.mark.parametrize("precond", ["jacobi", "ilu0"])
def test_cg_iteration_bytes(precond):
    cg = kind_module("cg")
    cfg = {"nx": 6, "ny": 5, "nz": 4}
    arrays = hpcg27.build(cfg)
    m, nnz = arrays[3][0], int(arrays[0][-1])

    class Cell:
        traffic = {"precond": precond}

    Cell.arrays = arrays
    want = peaks.spmv_bytes(m, nnz) + 64 * m
    if precond == "ilu0":
        lower = (nnz - m) // 2
        want += (12 * lower + 4 * (m + 1)) + (12 * (nnz - lower) + 4 * (m + 1)) + 16 * m
    assert cg.unit_bytes(Cell) == want


def test_power_step_bytes():
    power = kind_module("power")

    class Cell:
        arrays = fem_like.build({"rows": 300, "cols": 300, "nnz": 6000, "block": 3,
                                 "spread_frac": 0.02, "data_seed": 7})

    assert power.unit_bytes(Cell) == peaks.spmv_bytes(300, 6000)


def test_readers():
    r = {"unit": "cg_iter", "window_s": 2.0, "units": 400, "requests": 4, "unit_bytes": 1e9,
         "peak_gbs": 1000.0, "trace": {"kernels": 90, "units": 30, "busy_s": 0.05,
                                       "window_s": 0.1}}
    assert readers.roofline(r, "cg_iter") == pytest.approx(60.0)
    assert readers.idle_share(r, "cg_iter") == pytest.approx(50.0)
    assert readers.kernels_per_unit(r, "cg_iter") == 3.0
    assert readers.units_per_request(r, "cg_iter") == 100.0
    assert readers.us_per_unit(r, "cg_iter") == 5000.0
    lat = dict(r, latencies=[0.001 * k for k in range(1, 101)])
    assert readers.latency_quantile_ms(lat, "cg_iter", 95) == pytest.approx(95.05)
    # another unit: nothing to read
    for f in (readers.roofline, readers.idle_share, readers.kernels_per_unit,
              readers.units_per_request, readers.us_per_unit):
        assert f(r, "spmv_step") is None
    assert readers.latency_quantile_ms(lat, "spmv_step", 95) is None
    for empty in (None, {"kernels": 0, "units": 30, "busy_s": 0.0, "window_s": 0.1}):
        assert readers.roofline(dict(r, trace=empty), "cg_iter") is None
        assert readers.idle_share(dict(r, trace=empty), "cg_iter") is None


def test_metric_files_read_by_name():
    from perfbench import run

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in bench["per_layer"]:
        mod = run.load(os.path.join(PB, "metrics", f"{m['name']}.py"), "metric_under_test")
        assert mod.read({"unit": "none"}) is None


def test_trace_summary_unions_and_labels():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#0", "ts": 0, "dur": 50},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 90, "dur": 20},    # clipped to 10
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 105, "dur": 20},   # overlaps k1
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 150, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 190, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 124, "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 126,
         "dur": 25},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 162, "dur": 30},
    ]
    s = trace.summarize(ev)
    assert s["kernels"] == 3
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((125 - 100 + 10 + 5) * 1e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::item > cudaStreamSynchronize"] == pytest.approx(25e-6)
    assert gaps["cudaGraphLaunch"] == pytest.approx(30e-6)
    assert gaps["host (no recorded op)"] == pytest.approx(5e-6)
    assert dict(s["device_ops"])["k1"] == pytest.approx(15e-6)
    assert trace.summarize([{"ph": "X", "cat": "cpu_op", "name": "a", "ts": 0, "dur": 1}]) == {
        "kernels": 0}


def test_inputs_repeat_and_differ():
    d = inputs.Draw("cpu")
    big = 2 ** 31 + 12345678901
    a, b = d.vector(big, 3, 100), d.vector(big, 3, 100)
    assert torch.equal(a, b) and not torch.equal(a, d.vector(big, 4, 100))
    assert a.dtype == torch.float64 and a.abs().max() <= 1
    share = np.mean([inputs.kept(big, i, 8) for i in range(4000)])
    assert 0.09 < share < 0.16


def test_resolved_covers_the_window():
    cg = kind_module("cg")
    big = 2 ** 31 + 12345678901
    kept = list(range(3, 4000, 4))
    again = cg.resolved(big, kept, 8)
    assert again == cg.resolved(big, kept, 8) and len(again) == 8
    assert again[-1] == kept[-1] and again == sorted(set(again))
    # one in each eighth of the window's first seven eighths and the last
    stretch = len(kept) // 7
    assert [kept.index(i) // stretch for i in again[:-1]] == list(range(7))
    assert again != cg.resolved(big + 1, kept, 8)
    assert cg.resolved(big, kept[:5], 8) == kept[:5]


def test_reference_pcg_solves():
    cfg = {"nx": 5, "ny": 5, "nz": 5}
    op = hpcg27.Operator(cfg, None, "cpu")
    b = inputs.Draw("cpu").vector(1, 0, 125)
    x, it = reference.pcg(op, lambda r: r / 26.0, b, 1e-8, 500)
    assert 0 < it < 100 and reference.relative_residual(op, x, b) < 1e-8
