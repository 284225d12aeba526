"""Shared by the benchmark's tests: a tiny benchmark made of files alone in a
temporary directory, and the harness run there on the CPU in a fresh
process (so that no module the test process holds reaches the run)."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PB = os.path.join(ROOT, "perfbench")

# a tiny configuration of each generator, and the cells on them
TINY = {
    "fem_tiny": {"name": "fem_tiny", "generator": "fem_like", "rows": 3000, "cols": 3000,
                 "nnz": 60000, "block": 3, "spread_frac": 0.02, "data_seed": 7,
                 "reduced": []},
    "hpcg_tiny": {"name": "hpcg_tiny", "generator": "hpcg27", "nx": 12, "ny": 10, "nz": 8,
                  "rows": 960, "nnz": 34 * 28 * 22, "reduced": []},
}
CELLS = {"fem_tiny.power": ("fem_tiny", "power64"),
         "hpcg_tiny.cg_jacobi": ("hpcg_tiny", "cg_jacobi"),
         "hpcg_tiny.cg_ilu0": ("hpcg_tiny", "cg_ilu0")}


def kind_module(name):
    from perfbench import run

    return run.load(os.path.join(PB, "kinds", f"{name}.py"), f"kind_under_test_{name}")


def tiny_root(tmp, extra_cells=None):
    """A checkout-like directory: the benchmark's files copied, tiny
    configurations and cells added as files and entries alone."""
    shutil.copytree(PB, os.path.join(tmp, "perfbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"], bench["workloads"] = [], []
    for name, cfg in TINY.items():
        path = f"perfbench/configs/{name}.json"
        with open(os.path.join(tmp, path), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": "test", "file": path, "reduced": [],
                                 "why": "test"})
    cells = dict(CELLS, **(extra_cells or {}))
    for name, (cfg, traffic) in cells.items():
        bench["workloads"].append({"name": name, "config": cfg, "traffic": traffic, "chips": 1,
                                   "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c in cells
                              if any(w.split(".", 1)[1] == c.split(".", 1)[1]
                                     for w in m["workloads"])]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp


def run_cell(root, workload, seed=2 ** 33 + 17, seconds=0.5, trace=0, prelude="",
             factory="None", device="'cpu'", require_cuda=False):
    """``python -c`` that runs ``prelude`` (patches) and then the harness on
    the CPU; (exit code, stdout, stderr)."""
    code = (
        "import sys\n" + prelude + "\n"
        "from perfbench import run\n"
        f"sys.exit(run.main(['--workload', {workload!r}, '--seed', '{seed}', "
        f"'--seconds', '{seconds}', '--trace', '{trace}'], root={root!r}, "
        f"require_cuda={require_cuda}, device={device}, program_factory={factory}))\n")
    # one thread a run: tests run side by side, and torch's thread pools
    # oversubscribe the cores
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    return p.returncode, p.stdout, p.stderr


def result(stdout):
    lines = stdout.strip().splitlines()
    return json.loads(lines[-1]) if lines else None
