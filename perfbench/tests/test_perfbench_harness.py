"""The harness end to end on the CPU with the port's plain versions, at tiny
sizes: the result line, cells, mixes and metrics added as files alone, the
control and the faults coming out not correct, the refusals."""

import json
import os
import shutil

import pytest

from perfbench.tests.helpers import CELLS, ROOT, result, run_cell, tiny_root

KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_cell_runs_and_is_correct(root, workload):
    rc, out, err = run_cell(root, workload)
    assert rc == 0, err[-3000:]
    res = result(out)
    assert KEYS <= set(res) and list(res)[-1] == "check"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    want = {m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]}
    assert set(res["metrics"]) == want and "setup_s" in want
    assert res["device"]["count"] == 1
    # the compared numbers close standard error, each beside its limit
    tail = err.strip().splitlines()[-len(res["check"]):]
    assert [t.split()[0] for t in tail] == list(res["check"])


def test_added_by_files_alone(root, tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries: the harness finds each by name."""
    new = tiny_root(str(tmp_path), extra_cells={"hpcg_small.cg_loose": ("hpcg_small", "cg_loose")})
    with open(os.path.join(new, "perfbench", "configs", "hpcg_small.json"), "w") as f:
        json.dump({"name": "hpcg_small", "generator": "hpcg27", "nx": 6, "ny": 6, "nz": 6,
                   "reduced": []}, f)
    traffic = json.load(open(os.path.join(new, "perfbench", "traffic", "cg_jacobi.json")))
    with open(os.path.join(new, "perfbench", "traffic", "cg_loose.json"), "w") as f:
        json.dump(dict(traffic, tol=1e-6), f)
    with open(os.path.join(new, "perfbench", "metrics", "solves_seen.py"), "w") as f:
        f.write("def read(readings):\n    return readings['requests']\n")
    bench = json.load(open(os.path.join(new, "BENCHMARK.json")))
    bench["configs"].append({"name": "hpcg_small", "source": "test",
                             "file": "perfbench/configs/hpcg_small.json", "reduced": [],
                             "why": "test"})
    bench["per_layer"].append({"name": "solves_seen", "unit": "solves", "better": "higher",
                               "source": "host_clock", "layer": "solver", "moves": "solve_ms",
                               "workloads": ["hpcg_small.cg_loose"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("solve_ms", "solve_p95_ms", "cg_iters.solve", "iter_us.solve",
                         "idle_share.solve", "kernels_per_iter.solve"):
            m["workloads"].append("hpcg_small.cg_loose")
    json.dump(bench, open(os.path.join(new, "BENCHMARK.json"), "w"))
    rc, out, err = run_cell(new, "hpcg_small.cg_loose")
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["correct"] is True and {"solve_ms", "setup_s"} == set(res["metrics"])
    # the traced run's readers, on a stand-in trace (the profiler needs the card)
    prelude = ("import perfbench.trace as t\n"
               "t.traced = lambda run, path: dict(kernels=5, units=run(False), busy_s=0.01, "
               "window_s=0.02, device_ops=[['k', 0.01]], idle_gaps=[['h', 0.01]])\n")
    rc, out, err = run_cell(new, "hpcg_small.cg_loose", trace=1, prelude=prelude)
    assert rc == 0, err[-3000:]
    res = result(out)
    assert set(res["metrics"]) == {"solves_seen", "cg_iters.solve", "iter_us.solve",
                                   "idle_share.solve", "kernels_per_iter.solve", "solve_p95_ms"}
    assert res["metrics"]["solves_seen"]["value"] == res["attempted"]
    assert res["metrics"]["idle_share.solve"]["value"] == pytest.approx(50.0)
    assert res["breakdown"] == {"device_ops": [["k", 0.01]], "idle_gaps": [["h", 0.01]]}
    assert res["device"]["busy_s"] == 0.01 and res["device"]["window_s"] == 0.02


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_not_correct(root, workload):
    """The reference in float32 in the program's place fails the check."""
    rc, out, err = run_cell(root, workload, factory="lambda kind, cell: kind.Control(cell)")
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["correct"] is False and res["failed"] > 0


POWER_FAULTS = {
    # the step returns its state unchanged: s = sigma x, no product
    "state_unchanged": "lambda spmv: (lambda x, y: y)",
    # the answer altered where it is produced: one element of the product moved
    "answer_altered": "lambda spmv: (lambda x, y: spmv(x, y).index_add(0, z, o))",
}
CG_FAULTS = {
    "state_unchanged": "lambda res: res._replace(x=res.x * 0)",
    "answer_altered": "lambda res: res._replace(x=res.x.index_add(0, z, o * 1e-6))",
}


@pytest.mark.parametrize("fault", sorted(POWER_FAULTS))
def test_power_fault_is_not_correct(root, fault):
    prelude = (
        "import torch\nimport spmv_acc_tpu_torch.dispatch as d\n"
        "z = torch.zeros(1, dtype=torch.long); o = torch.full((1,), 1e-3, dtype=torch.float64)\n"
        f"fault = {POWER_FAULTS[fault]}\n_real = d.make_spmv_fn\n"
        "def make(*a, **k):\n    spmv, chosen = _real(*a, **k)\n    return fault(spmv), chosen\n"
        "d.make_spmv_fn = make\n")
    rc, out, err = run_cell(root, "fem_tiny.power", prelude=prelude)
    assert rc == 0, err[-3000:]
    assert result(out)["correct"] is False


@pytest.mark.parametrize("fault", sorted(CG_FAULTS))
@pytest.mark.parametrize("workload", ["hpcg_tiny.cg_jacobi", "hpcg_tiny.cg_ilu0"])
def test_cg_fault_is_not_correct(root, fault, workload):
    prelude = (
        "import torch\nimport spmv_acc_tpu_torch.models.cg as cg\n"
        "z = torch.zeros(1, dtype=torch.long); o = torch.ones(1, dtype=torch.float64)\n"
        f"fault = {CG_FAULTS[fault]}\n_real = cg.cg_solve\n"
        "cg.cg_solve = lambda *a, **k: fault(_real(*a, **k))\n")
    rc, out, err = run_cell(root, workload, prelude=prelude)
    assert rc == 0, err[-3000:]
    assert result(out)["correct"] is False


@pytest.mark.parametrize("workload", ["hpcg_tiny.cg_jacobi", "hpcg_tiny.cg_ilu0"])
def test_cg_fault_late_in_the_window_is_not_correct(root, workload):
    """From the 40th call on, each solve stops by another rule (a hundredth of
    the tolerance), as a stale captured solver could: every residual still
    passes, and the gap to the reference's solution of the same b fails in a
    solve late in the window."""
    prelude = (
        "import itertools\nimport spmv_acc_tpu_torch.models.cg as cg\n"
        "calls = itertools.count()\n_real = cg.cg_solve\n"
        "def solve(*a, **k):\n"
        "    if next(calls) >= 40:\n"
        "        k['tol'] = k['tol'] / 100\n"
        "    return _real(*a, **k)\n"
        "cg.cg_solve = solve\n")
    rc, out, err = run_cell(root, workload, seconds=4, prelude=prelude)
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["attempted"] > 45 and res["correct"] is False, err[-3000:]
    check = res["check"]
    assert check["residual_over_tol"]["value"] <= check["residual_over_tol"]["limit"]
    assert check["x_gap"]["value"] > check["x_gap"]["limit"]


def test_refuses_without_a_card(root):
    rc, out, err = run_cell(root, "hpcg_tiny.cg_jacobi", require_cuda=True)
    assert rc != 0 and out.strip() == "" and "CUDA" in err


def test_refuses_when_jax_is_loaded(root):
    prelude = "import types\nsys.modules['jax'] = types.ModuleType('jax')\n"
    rc, out, err = run_cell(root, "hpcg_tiny.cg_jacobi", prelude=prelude)
    assert rc != 0 and out.strip() == "" and "jax" in err


def test_refuses_in_a_directory_without_the_program(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no result."""
    import subprocess
    import sys

    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; from perfbench import run; sys.exit(run.main(['--workload', "
            "'hpcg104.cg_jacobi', '--seed', '1', '--seconds', '1'], require_cuda=False, "
            "device='cpu'))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "spmv_acc_tpu_torch" in p.stderr
