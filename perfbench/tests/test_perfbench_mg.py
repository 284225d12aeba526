"""The mix ``cg_mg`` (HPCG's sets under its multigrid preconditioner) on the
CPU at a small size, added as files alone: the program correct, its
float32 control not, a changed V-cycle or a short set not, a traced run's
new readers, and the byte count."""

import json
import os

import pytest

from perfbench import peaks
from perfbench.matrices import hpcg27mg
from perfbench.tests.helpers import kind_module, result, run_cell, tiny_root

MG_TINY = {"name": "hpcg_mg_tiny", "generator": "hpcg27mg", "nx": 16, "ny": 8, "nz": 24,
           "mg_levels": 4, "rows": 16 * 8 * 24,
           "nnz": 46 * 22 * 70, "reduced": []}
NEW = {"hpcg_mg_tiny.cg_mg": ("hpcg_mg_tiny", "cg_mg")}
# sets of 8 iterations: at this size 50 reach the rounding floor whatever the
# preconditioner, 8 leave x where the V-cycle took it (the residual not held)
SHORT = {"hpcg_mg_tiny.cg_mg_short": ("hpcg_mg_tiny", "cg_mg_short")}
# a trace as the card's profiler would leave it: F-3's grid kernel 60 % of busy
FAKE_TRACE = ("import perfbench.trace as t\n"
              "t.traced = lambda run, path: dict(kernels=5, units=run(False), busy_s=0.01, "
              "window_s=0.02, device_ops=[['levels_grid_kernel<double>', 0.004], "
              "['levels_block_kernel<double>', 0.002], ['sweep_kernel', 0.003]], "
              "idle_gaps=[['h', 0.01]])\n")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    new = tiny_root(str(tmp_path_factory.mktemp("bench")), extra_cells=dict(NEW, **SHORT))
    path = "perfbench/configs/hpcg_mg_tiny.json"
    with open(os.path.join(new, path), "w") as f:
        json.dump(MG_TINY, f)
    traffic = json.load(open(os.path.join(new, "perfbench", "traffic", "cg_mg.json")))
    with open(os.path.join(new, "perfbench", "traffic", "cg_mg_short.json"), "w") as f:
        json.dump(dict(traffic, max_iters=8, limits=dict(traffic["limits"], relative_residual=1.0)),
                  f)
    bench = json.load(open(os.path.join(new, "BENCHMARK.json")))
    bench["configs"].append({"name": "hpcg_mg_tiny", "source": "test", "file": path,
                             "reduced": [], "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "solve_ms":
            m["workloads"] += list(SHORT)
    json.dump(bench, open(os.path.join(new, "BENCHMARK.json"), "w"))
    return new


def test_new_cell_runs_and_is_correct(root):
    rc, out, err = run_cell(root, "hpcg_mg_tiny.cg_mg")
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"solve_ms", "setup_s"}
    assert res["check"]["answers_checked"]["value"] >= 1


def test_new_cell_control_is_not_correct(root):
    rc, out, err = run_cell(root, "hpcg_mg_tiny.cg_mg",
                            factory="lambda kind, cell: kind.Control(cell)")
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["correct"] is False and res["failed"] > 0


MG_FAULTS = {
    # no SymGS after the coarse correction (the only SymGS step handed an x):
    # another preconditioner, still SPD-ish
    "no_postsmooth": "import spmv_acc_tpu_torch.models.mg as mg\n"
                     "_symgs = mg.MGPreconditioner._symgs\n"
                     "mg.MGPreconditioner._symgs = staticmethod("
                     "lambda lv, r, x: x if x is not None else _symgs(lv, r, x))\n",
    # the coarse levels dropped: SymGS on the fine level alone
    "one_level": "import spmv_acc_tpu_torch as p\n_real = p.mg_preconditioner\n"
                 "p.mg_preconditioner = lambda levels, f2c: _real(levels[:1], [])\n",
}


def test_short_sets_are_correct(root):
    rc, out, err = run_cell(root, "hpcg_mg_tiny.cg_mg_short")
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["correct"] is True and res["check"]["relative_residual"]["value"] > 1e-8


@pytest.mark.parametrize("fault", sorted(MG_FAULTS))
def test_changed_vcycle_is_not_correct(root, fault):
    rc, out, err = run_cell(root, "hpcg_mg_tiny.cg_mg_short", prelude=MG_FAULTS[fault])
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["correct"] is False and res["check"]["x_gap"]["value"] > res["check"]["x_gap"][
        "limit"]


def test_fewer_iterations_are_not_correct(root):
    prelude = ("import spmv_acc_tpu_torch.models.cg as cg\n_real = cg.cg_solve\n"
               "cg.cg_solve = lambda *a, **k: _real(*a, **dict(k, max_iters=49))\n")
    rc, out, err = run_cell(root, "hpcg_mg_tiny.cg_mg", prelude=prelude)
    assert rc == 0, err[-3000:]
    assert result(out)["correct"] is False


def test_traced_run_reads_the_new_metrics(root):
    rc, out, err = run_cell(root, "hpcg_mg_tiny.cg_mg", trace=1, prelude=FAKE_TRACE)
    assert rc == 0, err[-3000:]
    metrics = result(out)["metrics"]
    assert {"symgs_share.solve", "mg_s.setup"} <= set(metrics), err[-3000:]
    assert metrics["symgs_share.solve"]["value"] == pytest.approx(60.0)
    assert metrics["mg_s.setup"]["value"] > 0
    assert metrics["cg_iters.solve"]["value"] == 50
    assert metrics["captures.solve"]["value"] == 0  # 50 < CG_EAGER_ITERS


def test_cg_mg_iteration_bytes():
    cg_mg = kind_module("cg_mg")

    class Cell:
        cfg = MG_TINY
        matrix = hpcg27mg

    def rows(c):
        return c["nx"] * c["ny"] * c["nz"]

    cfgs = hpcg27mg.coarse_cfgs(MG_TINY)
    assert [(c["nx"], c["ny"], c["nz"]) for c in cfgs] == [(16, 8, 24), (8, 4, 12), (4, 2, 6),
                                                            (2, 1, 3)]
    m = rows(cfgs[0])
    want = peaks.spmv_bytes(m, MG_TINY["nnz"]) + 80 * m
    for k, c in enumerate(cfgs):
        mk = rows(c)
        s = (hpcg27mg.nnz(c) - mk) // 2
        solve = 8 * s + 4 * (s + mk + 1) + 24 * mk
        product = 8 * (2 * mk + s) + 4 * (mk + 1 + s) + 8 * mk
        if k == 3:
            want += 2 * solve + product
        else:
            want += (4 * solve + 3 * product + peaks.spmv_bytes(mk, hpcg27mg.nnz(c)) + 8 * mk
                     + 56 * rows(cfgs[k + 1]))
    assert cg_mg.unit_bytes(Cell) == want

