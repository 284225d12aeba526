"""The ``dist_cg`` kind on the CPU: rank 0 in the harness's process and three
followers in gloo, on a small copy of ``hpcg104x4`` (an 8x8x32 grid, one
8x8x8 slab a rank); the configuration's stated size; the new readers."""

import json
import os
import re

import pytest

from perfbench import inputs, peaks, readers
from perfbench.matrices import hpcg27
from perfbench.tests.helpers import PB, ROOT, kind_module, result, run_cell, tiny_root

CELL = "hpcg_x4_tiny.dist_cg"
SEED = 2 ** 33 + 17
TINY_X4 = {"name": "hpcg_x4_tiny", "generator": "hpcg27", "nx": 8, "ny": 8, "nz": 32,
           "ranks": 4, "rows": 2048, "nnz": 22 * 22 * 94, "reduced": []}


def wrong_slab(draw, seed, i, n):
    """A follower's fault: it draws the right b and shifts it by a slab, so
    that the slab it takes is its neighbour's."""
    return draw.vector(seed, i, n).roll(n // TINY_X4["ranks"])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(str(tmp_path_factory.mktemp("dist")), extra_cells={
        CELL: ("hpcg_x4_tiny", "dist_cg")})
    with open(os.path.join(root, "perfbench", "configs", "hpcg_x4_tiny.json"), "w") as f:
        json.dump(TINY_X4, f)
    path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["configs"].append({"name": "hpcg_x4_tiny", "source": "test",
                             "file": "perfbench/configs/hpcg_x4_tiny.json", "reduced": [],
                             "why": "test"})
    json.dump(bench, open(path, "w"))
    return root


def _followers_gone(err):
    found = re.search(r"dist_cg: followers \[([\d, ]+)\]", err)
    pids = [int(p) for p in found.group(1).split(",")]
    assert len(pids) == TINY_X4["ranks"] - 1
    assert "dist_cg: followers joined, exit codes [0, 0, 0]" in err
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_dist_cell_is_correct_and_leaves_no_follower(root):
    rc, out, err = run_cell(root, CELL, seed=SEED, seconds=4)
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["correct"] is True and res["failed"] == 0, err[-3000:]
    assert set(res["metrics"]) == {"solve_ms", "setup_s"}
    # the window keeps the requests inputs.kept draws from the run's seed (7,
    # 21, 24, ...) and its last, each gathered from the four ranks
    checked, n = res["check"]["answers_checked"]["value"], res["attempted"]
    every = json.load(open(os.path.join(PB, "traffic", "dist_cg.json")))["check_every"]
    assert checked == len({i for i in range(n) if inputs.kept(SEED, i, every)} | {n - 1})
    # each rank keeps the blocks of the answers the window keeps and the
    # warm-up's, each seed's latest, not one a request
    held = int(re.search(r"closing with (\d+) blocks held", err).group(1))
    assert held == checked + 1
    _followers_gone(err)


def test_traced_dist_cell_reports_the_new_metrics(root):
    """The readers on a stand-in trace (the profiler needs the card) and the
    program's own span table."""
    prelude = ("import perfbench.trace as t\n"
               "t.traced = lambda run, path: dict(kernels=8, units=run(False), busy_s=0.02, "
               "window_s=0.025, device_ops=[['swell_kernel', 0.012], "
               "['ncclDevKernel_AllReduce_Sum_f64_RING_LL', 0.004], "
               "['ncclDevKernel_SendRecv', 0.001]], idle_gaps=[['h', 0.005]])\n")
    rc, out, err = run_cell(root, CELL, seconds=1, trace=1, prelude=prelude)
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["correct"] is True, err[-3000:]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["comm_share.dist"] == pytest.approx(25.0)
    # rank 0 has one neighbour: 512 rows of 8 bytes a matvec, about one matvec an iteration
    per_iter = 512 * 8 * 1e-6
    assert per_iter * m["cg_iters.solve"] < m["halo_mb.solve"] < per_iter * (
        m["cg_iters.solve"] + 20)
    assert m["shard_s.setup"] > 0 and m["plan_s.setup"] > 0
    _followers_gone(err)


def test_a_follower_on_the_wrong_slab_is_not_correct(root):
    factory = ("lambda kind, cell: kind.Program(cell, follower_draw=__import__("
               "'perfbench.tests.test_perfbench_dist', fromlist=['wrong_slab']).wrong_slab)")
    rc, out, err = run_cell(root, CELL, seconds=1, factory=factory)
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["correct"] is False and res["failed"] > 0
    _followers_gone(err)


def test_dist_control_is_not_correct(root):
    rc, out, err = run_cell(root, CELL, seconds=1,
                            factory="lambda kind, cell: kind.Control(cell)")
    assert rc == 0, err[-3000:]
    assert result(out)["correct"] is False


def test_hpcg104x4_config_states_its_size():
    cfg = json.load(open(os.path.join(PB, "configs", "hpcg104x4.json")))
    assert (cfg["nx"], cfg["ny"], cfg["nz"], cfg["ranks"]) == (104, 104, 416, 4)
    assert cfg["rows"] == 104 * 104 * 416 == 4 * 1_124_864 == 4_499_456
    assert cfg["nnz"] == (3 * 104 - 2) ** 2 * (3 * 416 - 2) == 119_740_600
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = {w["name"]: w for w in bench["workloads"]}["hpcg104x4.dist_cg"]
    assert cell["chips"] == cfg["ranks"] and cell["traffic"] == "dist_cg"


def test_dist_iteration_bytes_are_rank_0s():
    kind = kind_module("dist_cg")

    class Cell:
        cfg = TINY_X4
        arrays = hpcg27.build(TINY_X4)

    rows = 512
    nnz0 = int(Cell.arrays[0][rows])
    assert nnz0 == 22 * 22 * 23  # the end slab's rows reach one neighbouring plane
    plane = 8 * 8 * 8  # that plane of the neighbour's x, 8 x 8 float64s
    assert kind.unit_bytes(Cell) == peaks.spmv_bytes(rows, nnz0) + plane + 64 * rows


def test_new_readers():
    from perfbench import run

    def reader(name):
        return run.load(os.path.join(PB, "metrics", f"{name}.py"), f"metric_{name}")

    comm = reader("comm_share.dist")
    t = {"kernels": 9, "units": 3, "busy_s": 0.1, "window_s": 0.2,
         "device_ops": [["ncclDevKernel_SendRecv", 0.01], ["k", 0.05],
                        ["ncclDevKernel_AllReduce_Sum_f64_RING_LL", 0.02]]}
    assert comm.read({"unit": "cg_iter", "trace": t}) == pytest.approx(30.0)
    assert comm.read({"unit": "cg_iter", "trace": dict(t, device_ops=[["k", 0.05]])}) is None
    assert readers.idle_share({"unit": "cg_iter", "trace": t}, "cg_iter") == pytest.approx(50.0)
    for name in ("comm_share.dist", "halo_mb.solve", "shard_s.setup"):
        assert reader(name).read({"unit": "none"}) is None
