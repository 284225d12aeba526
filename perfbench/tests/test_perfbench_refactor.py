"""The mix ``refactor`` (new values on one pattern, ILU(0) refactored, a CG
solve) on the CPU at a small size, added as files alone: the program
correct, its float32 control not; a stale factor (the set-up's, or the
previous request's) fails ``x_gap``, stale values fail
``residual_over_tol``, also when the fault starts late in the window; the
kind refuses a program without the API; a traced run's new readers, and
their silence off their cell."""

import json
import os

import pytest

from perfbench import run
from perfbench.tests.helpers import PB, result, run_cell, tiny_root

VC_TINY = {"name": "vc_tiny", "generator": "hpcg27vc", "nx": 12, "ny": 10, "nz": 8,
           "rows": 960, "nnz": 34 * 28 * 22, "reduced": []}
CELL = "vc_tiny.refactor"
# a trace as the card's profiler would leave it: F-4 10 % of busy
FAKE_TRACE = ("import perfbench.trace as t\n"
              "t.traced = lambda run, path: dict(kernels=5, units=run(False), busy_s=0.01, "
              "window_s=0.02, device_ops=[['sweep_kernel', 0.006], "
              "['ilu0_factor_kernel', 0.001], ['swell_kernel', 0.002]], "
              "idle_gaps=[['h', 0.01]])\n")

FAULTS = {
    # the set-up's factor kept: refactor does nothing
    "stale_factor": ("x_gap", "import spmv_acc_tpu_torch.ops.trisolve as t\n"
                              "t.ILU0.refactor = lambda self, csr: None\n"),
    # the previous request's values factored
    "previous_factor": ("x_gap", "import spmv_acc_tpu_torch.ops.trisolve as t\n"
                                 "_real, _prev = t.ILU0.refactor, {}\n"
                                 "def _lag(self, csr):\n"
                                 "    now = csr.values.clone()\n"
                                 "    old = _prev.get('v', now)\n"
                                 "    _prev['v'] = now\n"
                                 "    csr.values.copy_(old)\n"
                                 "    _real(self, csr)\n"
                                 "    csr.values.copy_(now)\n"
                                 "t.ILU0.refactor = _lag\n"),
    # the new values written into csr.values, the matvec's layout not told
    "stale_values": ("residual_over_tol",
                     "import spmv_acc_tpu_torch as p\n"
                     "p.replace_values = lambda csr, v: csr.values.copy_(v)\n"),
    # a stale factor from the 12th refactor on
    "late_stale_factor": ("x_gap", "import spmv_acc_tpu_torch.ops.trisolve as t\n"
                                   "_real, _n = t.ILU0.refactor, [0]\n"
                                   "def _late(self, csr):\n"
                                   "    _n[0] += 1\n"
                                   "    if _n[0] < 12:\n"
                                   "        _real(self, csr)\n"
                                   "t.ILU0.refactor = _late\n"),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    new = tiny_root(str(tmp_path_factory.mktemp("bench")),
                    extra_cells={CELL: ("vc_tiny", "refactor")})
    path = "perfbench/configs/vc_tiny.json"
    with open(os.path.join(new, path), "w") as f:
        json.dump(VC_TINY, f)
    bench = json.load(open(os.path.join(new, "BENCHMARK.json")))
    bench["configs"].append({"name": "vc_tiny", "source": "test", "file": path,
                             "reduced": [], "why": "test"})
    json.dump(bench, open(os.path.join(new, "BENCHMARK.json"), "w"))
    return new


def test_new_cell_runs_and_is_correct(root):
    rc, out, err = run_cell(root, CELL)
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"solve_ms", "setup_s"}
    assert res["check"]["x_gap"]["value"] < 1e-13


def test_new_cell_control_is_not_correct(root):
    rc, out, err = run_cell(root, CELL, factory="lambda kind, cell: kind.Control(cell)")
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["correct"] is False and res["failed"] > 0
    assert res["check"]["x_gap"]["value"] > res["check"]["x_gap"]["limit"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(root, fault):
    number, prelude = FAULTS[fault]
    rc, out, err = run_cell(root, CELL, prelude=prelude, seconds=1.5)
    assert rc == 0, err[-3000:]
    res = result(out)
    if fault.startswith("late"):
        assert res["attempted"] > 12
    assert res["correct"] is False and res["failed"] > 0
    assert res["check"][number]["value"] > res["check"][number]["limit"], res["check"]


def test_kind_refuses_a_program_without_the_api(root):
    prelude = "import spmv_acc_tpu_torch as p\ndel p.replace_values\n"
    rc, out, err = run_cell(root, CELL, prelude=prelude)
    assert rc != 0 and result(out) is None
    assert "cg_refactor needs the program's replace_values and ILU0.refactor" in err


def test_traced_run_reads_the_new_metrics(root):
    rc, out, err = run_cell(root, CELL, trace=1, prelude=FAKE_TRACE)
    assert rc == 0, err[-3000:]
    metrics = result(out)["metrics"]
    new = {"refactor_share.solve", "refactor_ms.solve", "ilu0_s.setup", "captures.solve"}
    assert new <= set(metrics), err[-3000:]
    assert metrics["refactor_share.solve"]["value"] == pytest.approx(10.0)
    assert 0 < metrics["refactor_ms.solve"]["value"] < 1e3
    # no card: no peak, so no roofline
    assert "refactor_roofline" not in metrics


def test_assembly_is_the_generators_build():
    """The kind's assembly on the device's index arrays gives the generator's
    ``build`` of the same field bit for bit, on a grid whose rows hold every
    neighbour count (edges, faces, corners)."""
    import torch

    from perfbench.matrices import hpcg27vc
    from perfbench.tests.helpers import kind_module

    kind = kind_module("cg_refactor")
    cfg = {"nx": 7, "ny": 5, "nz": 4}
    arrays = hpcg27vc.build(cfg)
    assemble = kind.Assembly(arrays, "cpu")
    for seed in (1, 2):
        c = 1.0 + 0.5 * (torch.rand(140, dtype=torch.float64,
                                    generator=torch.Generator().manual_seed(seed)) * 2 - 1)
        assert torch.equal(assemble(c), torch.from_numpy(hpcg27vc.build(cfg, c)[2]))


def _reader(name):
    return run.load(os.path.join(PB, "metrics", f"{name}.py"), f"reader_{name}")


def _table(monkeypatch, **entries):
    """The program's span table as the readers find it, holding ``entries``
    (name -> (count, seconds, self seconds, total))."""
    import sys
    import types

    from perfbench import spans

    fake = types.ModuleType(spans.MODULE)
    fake.spans = lambda: {k: types.SimpleNamespace(count=c, seconds=s, self_seconds=ss, total=t)
                          for k, (c, s, ss, t) in entries.items()}
    monkeypatch.setitem(sys.modules, spans.MODULE, fake)


def test_refactor_roofline_from_the_counters(monkeypatch):
    """One refactor's bytes (A read, the factor written, the pattern's indices
    once) over F-4's traced seconds a refactor, the refactors counted from
    the trace's iterations and the window's."""
    reader = _reader("refactor_roofline")
    assert reader.refactor_bytes(10, 100) == 8 * 100 * 2 + 4 * (100 + 10 + 1)
    _table(monkeypatch, **{"ilu.refactors": (4, 0, 0, 4), "cg.solve": (4, 1.0, 0.5, 0),
                           "ilu.refactor.rows": (4, 0, 0, 40),
                           "ilu.refactor.nnz": (4, 0, 0, 400)})
    readings = {"unit": "cg_iter", "units": 100, "requests": 10, "peak_gbs": 1.0,
                "trace": {"units": 20, "busy_s": 1.0, "kernels": 5,
                          "device_ops": [["ilu0_factor_kernel", 2e-6]]}}
    # two refactors in the trace, 1e-6 s each: 2044 B a refactor
    assert reader.read(readings) == pytest.approx(100.0 * 2044 / 1e-6 / 1e9)


@pytest.mark.parametrize("name", ["refactor_share.solve", "refactor_roofline",
                                  "refactor_ms.solve"])
def test_new_readers_are_silent_off_their_cell(name, monkeypatch):
    """In another ILU(0) cell's traced run (no F-4 kernel, no refactor span or
    counter) the new readers read nothing."""
    _table(monkeypatch, **{"cg.solve": (10, 0.6, 0.01, 0), "ilu0": (1, 7.0, 6.0, 0)})
    readings = {"unit": "cg_iter", "units": 800, "requests": 10, "peak_gbs": 3352.32,
                "latencies": [0.06] * 10, "window_s": 0.6,
                "trace": {"units": 240, "busy_s": 0.16, "window_s": 0.18, "kernels": 2700,
                          "device_ops": [["sweep_kernel_double__1_", 0.12],
                                         ["swell_kernel_double__1__1__false_", 0.04]]}}
    assert _reader(name).read(readings) is None
