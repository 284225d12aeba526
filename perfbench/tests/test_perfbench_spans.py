"""The readers of the program's span table (``perfbench/spans.py`` and the
seven metrics over it): None where there is no table, an empty one or no
request; the formula's value on a seeded table; and a traced run on the CPU
that reports them, or leaves them out where the program keeps no table."""

import os
import sys
import types
from collections import namedtuple

import pytest

from perfbench import run
from perfbench.tests.helpers import result, run_cell, tiny_root
from perfbench.tests.test_perfbench_static import PB, _imports

Entry = namedtuple("Entry", "count seconds self_seconds total")
SEVEN = ["eager_ms.solve", "blocks_ms.solve", "capture_ms.solve", "captures.solve",
         "pool_mb.solve", "plan_s.setup", "ilu0_s.setup"]
SOLVE = {"unit": "cg_iter", "requests": 10}

# 4 solves; 2 captures in 0.02 s of 0.3 s of blocks; 1 s of eager starts
TABLE = {
    "cg.solve": Entry(4, 1.5, 0.1, 0),
    "cg.eager": Entry(4, 1.0, 1.0, 0),
    "cg.blocks": Entry(3, 0.3, 0.28, 0),
    "graphs.capture": Entry(2, 0.02, 0.02, 0),
    "graphs.pool_bytes": Entry(2, 0.0, 0.0, 96_000_000),
    "swell.plan": Entry(3, 2.5, 0.5, 0),
    "swell.plan.load": Entry(3, 2.0, 2.0, 0),
    "ilu0": Entry(1, 9.0, 7.5, 0),
}
WANT = {
    "eager_ms.solve": 1.0 / 4 * 1e3,
    "blocks_ms.solve": (0.3 - 0.02) / 4 * 1e3,
    "capture_ms.solve": 0.02 / 4 * 1e3,
    "captures.solve": 2 / 4,
    "pool_mb.solve": 96.0 / 4,
    "plan_s.setup": 2.5,
    "ilu0_s.setup": 7.5,
}


def _reader(name):
    return run.load(os.path.join(PB, "metrics", f"{name}.py"), f"reader_{name.replace('.', '_')}")


def _program(monkeypatch, table):
    mod = types.ModuleType("profiling")
    if table is not None:
        mod.spans = lambda: dict(table)
    monkeypatch.setitem(sys.modules, "spmv_acc_tpu_torch.utils.profiling", mod)


@pytest.mark.parametrize("name", SEVEN)
def test_reads_the_formula_on_a_seeded_table(monkeypatch, name):
    _program(monkeypatch, TABLE)
    assert _reader(name).read(SOLVE) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", SEVEN)
@pytest.mark.parametrize("table", ["absent", "no spans()", "empty"])
def test_reads_none_without_a_table(monkeypatch, name, table):
    if table == "absent":
        monkeypatch.delitem(sys.modules, "spmv_acc_tpu_torch.utils.profiling", raising=False)
    else:
        _program(monkeypatch, None if table == "no spans()" else {})
    assert _reader(name).read(SOLVE) is None


@pytest.mark.parametrize("name", SEVEN)
def test_reads_none_where_the_run_made_no_request(monkeypatch, name):
    _program(monkeypatch, TABLE)
    assert _reader(name).read({"unit": "none"}) is None
    assert _reader(name).read(dict(SOLVE, requests=0)) is None


def test_per_solve_needs_a_solve_and_counts_a_missing_span_as_zero(monkeypatch):
    _program(monkeypatch, {k: v for k, v in TABLE.items() if not k.startswith("graphs.")})
    assert _reader("captures.solve").read(SOLVE) == 0
    assert _reader("blocks_ms.solve").read(SOLVE) == pytest.approx(0.3 / 4 * 1e3)
    _program(monkeypatch, {k: v for k, v in TABLE.items() if k != "cg.solve"})
    for name in SEVEN[:5]:
        assert _reader(name).read(SOLVE) is None
    assert _reader("plan_s.setup").read(SOLVE) == 2.5


def test_spans_reader_imports_nothing_of_the_program():
    for name in _imports(os.path.join(PB, "spans.py")):
        assert name.split(".")[0] != "spmv_acc_tpu_torch", name


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("spans")))


# the traced run's other readers on a stand-in trace (the profiler needs the card)
STAND_IN = ("import perfbench.trace as t\n"
            "t.traced = lambda run, path: dict(kernels=5, units=run(False), busy_s=0.01, "
            "window_s=0.02, device_ops=[['k', 0.01]], idle_gaps=[['h', 0.01]])\n")


@pytest.mark.parametrize("workload,want", [
    ("hpcg_tiny.cg_ilu0", set(SEVEN)),
    ("hpcg_tiny.cg_jacobi", set(SEVEN) - {"ilu0_s.setup"}),
    ("fem_tiny.power", {"plan_s.setup"}),
])
def test_traced_cpu_run_reports_them(root, workload, want):
    rc, out, err = run_cell(root, workload, trace=1, prelude=STAND_IN)
    assert rc == 0, err[-3000:]
    metrics = result(out)["metrics"]
    assert want <= set(metrics) and not (set(SEVEN) - want) & set(metrics)
    assert metrics["plan_s.setup"]["value"] > 0
    if "eager_ms.solve" in want:
        assert metrics["eager_ms.solve"]["value"] > 0
        assert metrics["captures.solve"]["value"] == 0  # no graph on the CPU
        assert metrics["capture_ms.solve"]["value"] == 0
        assert metrics["pool_mb.solve"]["value"] == 0
    if "ilu0_s.setup" in want:
        assert metrics["ilu0_s.setup"]["value"] > 0


def test_a_program_without_the_table_leaves_them_out(root):
    """A version of the program older than the table: the readers find
    nothing, and the run still ends with its result."""
    prelude = STAND_IN + ("import spmv_acc_tpu_torch.utils.profiling as p\n"
                          "del p.spans\n")
    rc, out, err = run_cell(root, "hpcg_tiny.cg_ilu0", trace=1, prelude=prelude)
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["correct"] is True and not set(SEVEN) & set(res["metrics"])
    assert "cg_iters.solve" in res["metrics"]
