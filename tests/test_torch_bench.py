"""The port's benchmark (``spmv_acc_tpu_torch/bench.py``) against the JAX
package's ``bench.py``.

A matrix's ``y`` is held against the JAX package's ``spmv`` (x64, CPU) and
``host_spmv`` under the reference's gate (rel 1e-7, abs 1e-14 near zero).
The JSON keys are read from both sources with ``ast`` (``bench.py`` is not
imported: importing it points JAX at its persistent compilation cache) and
must be the same; f-string keys compare as patterns.  The run's control flow
(a partial line after every matrix, SIGTERM, the budget, the subset, the
device rules) is driven through ``main`` with a stubbed ``bench_matrix``, so
it costs no timing loop.  Everything runs on the CPU (``--device cpu``, with a
given peak)."""

import ast
import io
import json
import os
import re
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu.dispatch import spmv as ref_spmv
from spmv_acc_tpu.formats.generate import example_like as ref_example_like
from spmv_acc_tpu.formats.generate import random_x_y as ref_random_x_y
from spmv_acc_tpu.ops.golden import host_spmv as ref_host_spmv
from spmv_acc_tpu_torch import bench
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.utils.verify import verify_y

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BENCH = os.path.join(REPO, "bench.py")
PORT_BENCH = os.path.join(REPO, "spmv_acc_tpu_torch", "bench.py")
KEYED = ("emit", "bench_spgemm", "bench_solver", "bench_solver_aniso")
CPU = ["--device", "cpu", "--peak-gbs", "100"]


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


@pytest.fixture
def handlers():
    """main() installs SIGTERM/SIGINT handlers; give pytest its own back."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def _key(node):
    """A literal key: ('key', text), or ('pattern', regex) for an f-string."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return ("key", node.value)
    if isinstance(node, ast.JoinedStr):
        return ("pattern", "".join(re.escape(v.value) if isinstance(v, ast.Constant) else ".+"
                                   for v in node.values))
    return None


def json_keys(path):
    """The literal keys the functions of ``KEYED`` put into a result dict:
    keys of dict literals and of ``out[...] = ...``, per function."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    found = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name not in KEYED:
            continue
        keys = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                keys |= {k for k in map(_key, node.keys) if k}
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                            and t.value.id == "out" and _key(t.slice)):
                        keys.add(_key(t.slice))
        found[fn.name] = keys
    return found


def _matches(key, keys):
    return any((kind == "key" and key == k) or (kind == "pattern" and re.fullmatch(k, key))
               for kind, k in keys)


def _stub_result(frac=0.5):
    return bench.MatrixResult(frac, 10.0, True, True, 100.0, np.zeros(1))


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("name", ["rajat03", "dw4096"])
def test_bench_matrix_matches_jax_and_golden(name):
    log = io.StringIO()
    res = bench.bench_matrix(name, log, device="cpu", peak_gbs=100.0, iters=8)
    ref = ref_example_like(name)
    m, n = ref.shape
    x, y0 = ref_random_x_y(n, m, seed=42)
    jy = np.asarray(ref_spmv(ref, jnp.asarray(x), jnp.asarray(y0), alpha=1.0, beta=1.0,
                             strategy="adaptive"))
    golden = ref_host_spmv(1.0, 1.0, *ref.to_numpy()[:3], x, y0)
    assert res.y.shape == (m,) and np.isfinite(res.y).all()
    assert verify_y(res.y, jy).ok and verify_y(res.y, golden).ok
    assert res.ok and res.raw_ok and res.per_us > 0
    # the roofline under the reference bytes model at the given peak
    b = 8 * (2 * m + ref.nnz) + 4 * (m + 1 + ref.nnz)
    assert res.frac == pytest.approx(b / (res.per_us * 1e-6) / 1e9 / 100.0)
    text = log.getvalue()
    assert f"PERFORMANCE,{name},swell,{m},{n},{ref.nnz}," in text
    assert f"  {name}: " in text and "verify=OK raw=OK" in text and "r=1" in text


def test_json_keys_match_the_reference():
    ref, port = json_keys(REF_BENCH), json_keys(PORT_BENCH)
    assert set(ref) == set(port) == set(KEYED)
    for fn in KEYED:
        assert port[fn] == ref[fn], fn
    assert ("pattern", "spgemm_.+_numeric_us") in ref["bench_spgemm"]
    assert ("key", "solver_total_wall_win") in ref["bench_solver_aniso"]


def test_emitted_keys_are_the_references(capsys, monkeypatch, handlers):
    """Every key main() prints, with every section filled, is one of
    bench.py's, and each of emit's literal keys is printed."""
    ref = json_keys(REF_BENCH)
    keys = set().union(*ref.values())
    monkeypatch.setattr(bench, "bench_matrix", lambda name, *a, **k: _stub_result())
    monkeypatch.setattr(bench, "bench_spmm", lambda *a, **k: 1.5)
    monkeypatch.setattr(bench, "bench_spgemm",
                        lambda *a, **k: {"spgemm_dw4096_c_nnz": 1, "spgemm_verify_all_pass": True})
    monkeypatch.setattr(bench, "bench_solver", lambda *a, **k: {"solver_spmv_us": 1.0})
    monkeypatch.setenv("SPMV_TPU_BENCH_ONLY", "boneS10,rajat03")
    assert bench.main(CPU) == 0
    last = _lines(capsys.readouterr().out)[-1]
    assert all(_matches(k, keys) for k in last), sorted(k for k in last if not _matches(k, keys))
    emitted = {("key", k) for k in last}
    assert {k for k in ref["emit"] if k[1] not in ("partial", "skipped")} <= emitted
    assert last["spmm_k8_speedup_geomean"] == 1.5 and last["large_done"] == 1


def test_spgemm_section_on_cpu(monkeypatch):
    monkeypatch.setattr(bench, "SPGEMM_MATRICES", ["dw4096"])
    out = bench.bench_spgemm(io.StringIO(), "cpu")
    keys = json_keys(REF_BENCH)["bench_spgemm"]
    assert set(out) == {"spgemm_dw4096_symbolic_s", "spgemm_dw4096_numeric_us",
                        "spgemm_dw4096_c_nnz", "spgemm_verify_all_pass"}
    assert all(_matches(k, keys) for k in out)
    assert out["spgemm_verify_all_pass"] is True and out["spgemm_dw4096_c_nnz"] > 41746


def test_solver_sections_on_cpu(monkeypatch):
    """bench_solver on a small SPD-ized matrix and the aniso section at 24^2:
    every key of both reference sections, CG converging in both."""
    monkeypatch.setenv("SPMV_TPU_BENCH_SOLVER_MATRIX", "dw4096")
    monkeypatch.setattr(bench, "ANISO_NX", 24)
    monkeypatch.setattr(bench, "ANISO_TRIPS", (3, 33))
    log = io.StringIO()
    out = bench.bench_solver(log, "cpu")
    ref = json_keys(REF_BENCH)
    assert {("key", k) for k in out} == ref["bench_solver"] | ref["bench_solver_aniso"]
    assert 0 < out["solver_cg_iters_ilu"] <= out["solver_cg_iters_jacobi"] < 300
    assert 0 < out["solver_aniso_cg_iters_ilu"] < out["solver_aniso_cg_iters_jacobi"] < 4000
    assert out["solver_spmv_us"] > 0 and out["solver_total_wall_win"] > 0
    assert "ERROR" not in log.getvalue() and "solver dw4096-SPD" in log.getvalue()


def test_a_partial_line_after_every_matrix(capsys, monkeypatch, handlers):
    fracs = {"rajat03": 0.25, "largebasis": 0.5}
    monkeypatch.setattr(bench, "bench_matrix", lambda name, *a, **k: _stub_result(fracs[name]))
    monkeypatch.setenv("SPMV_TPU_BENCH_ONLY", "rajat03,largebasis")
    monkeypatch.setenv("SPMV_TPU_BENCH_SPGEMM", "0")
    monkeypatch.setenv("SPMV_TPU_BENCH_SOLVER", "0")
    assert bench.main(CPU) == 0
    first, second, last = _lines(capsys.readouterr().out)
    assert first["partial"] and first["corpus"] == 1 and first["large_done"] == 0
    assert first["metric"].endswith("SMALL_SET_FALLBACK_large_set_failed")
    assert second["partial"] and second["corpus"] == 2 and second["large_done"] == 1
    assert "partial" not in last and last["metric"] == "spmv_roofline_fraction_f64_geomean_large_set"
    assert last["value"] == 0.5 and last["vs_baseline"] == 0.625
    assert last["per_matrix_roofline"] == fracs and "skipped" not in last


def test_a_failed_matrix_fails_the_verify_flag(capsys, monkeypatch, handlers):
    def stub(name, *a, **k):
        if name == "dw4096":
            raise RuntimeError("out of memory")
        return _stub_result()

    monkeypatch.setattr(bench, "bench_matrix", stub)
    monkeypatch.setenv("SPMV_TPU_BENCH_ONLY", "rajat03,dw4096")
    monkeypatch.setenv("SPMV_TPU_BENCH_SPGEMM", "0")
    monkeypatch.setenv("SPMV_TPU_BENCH_SOLVER", "0")
    assert bench.main(CPU) == 0
    captured = capsys.readouterr()
    last = _lines(captured.out)[-1]
    assert last["verify_all_pass"] is False and last["corpus"] == 1
    assert "dw4096: ERROR RuntimeError: out of memory" in captured.err


def test_sigterm_prints_a_parseable_partial_line(tmp_path):
    script = tmp_path / "run.py"
    script.write_text(
        "import os, signal, sys, time\n"
        "from spmv_acc_tpu_torch import bench\n"
        "def stub(name, *a, **k):\n"
        "    if name == 'dw4096':\n"
        "        os.kill(os.getpid(), signal.SIGTERM)\n"
        "        time.sleep(60)\n"
        "    return bench.MatrixResult(0.5, 1.0, True, True, 10.0, None)\n"
        "bench.bench_matrix = stub\n"
        "sys.exit(bench.main(['--device', 'cpu', '--peak-gbs', '100']))\n")
    env = dict(os.environ, SPMV_TPU_BENCH_ONLY="rajat03,dw4096,epb1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["partial"] is True and last["skipped"] == [f"signal_{int(signal.SIGTERM)}"]
    assert last["per_matrix_roofline"] == {"rajat03": 0.5}


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_no_card_exits_non_zero(capsys, monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "bench_matrix", lambda *a, **k: pytest.fail("ran a matrix"))
    assert bench.main(argv) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_cpu_without_a_peak_is_refused(capsys, monkeypatch):
    monkeypatch.setattr(bench, "bench_matrix", lambda *a, **k: pytest.fail("ran a matrix"))
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu"])
    assert e.value.code != 0 and "--peak-gbs" in capsys.readouterr().err


def test_the_budget_and_the_subset_fill_skipped(capsys, monkeypatch, handlers):
    ran = []

    def stub(name, *a, **k):  # the first matrix takes the whole budget
        ran.append(name)
        bench._STATE["t_start"] -= 101
        return _stub_result()

    monkeypatch.setattr(bench, "bench_matrix", stub)
    monkeypatch.setenv("SPMV_TPU_BENCH_BUDGET_S", "100")
    monkeypatch.setenv("SPMV_TPU_BENCH_ONLY", "dw4096,rajat03,TSOPF_RS_b2383")
    assert bench.main(CPU) == 0
    last = _lines(capsys.readouterr().out)[-1]
    assert ran == ["dw4096"] and list(last["per_matrix_roofline"]) == ["dw4096"]
    # past the budget: the other matrices, then both SpMM entries, as bench.py lists them
    assert last["skipped"] == ["rajat03", "TSOPF_RS_b2383", "spmm_TSOPF_RS_b2383",
                               "spmm_boneS10"]
    assert "spgemm_verify_all_pass" not in last and "solver_spmv_us" not in last


def test_a_budget_of_zero_runs_nothing(capsys, monkeypatch, handlers):
    monkeypatch.setattr(bench, "bench_matrix", lambda *a, **k: pytest.fail("ran a matrix"))
    monkeypatch.setenv("SPMV_TPU_BENCH_BUDGET_S", "0")
    assert bench.main(CPU) == 1
    out = _lines(capsys.readouterr().out)
    assert out == [{"metric": "spmv_roofline_fraction", "value": 0.0, "unit": "fraction",
                    "vs_baseline": 0.0}]
