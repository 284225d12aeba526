"""Run one cell of the benchmark of ``spmv_acc_tpu_torch``.

    python3 -m perfbench.run --workload boneS10.power --seed 12345 --seconds 30 --trace 0

From the root of a checkout.  The cell, its configuration and its traffic mix
are found by name: ``BENCHMARK.json`` names the configuration's file, the
traffic mix is ``perfbench/traffic/<traffic>.json``, its ``kind`` names the
module ``perfbench/kinds/<kind>.py``, the configuration's ``generator`` names
``perfbench/matrices/<generator>.py`` (the matrix and its plain reference),
and each per-layer metric is read by ``perfbench/metrics/<metric>.py``.

A run: set-up (imports, the matrix, the program's plans and factors, one
warm-up request), then a closed loop of requests for ``--seconds`` (each
sent when the last returned), then with ``--trace 1`` a profiled segment of
the mix's ``trace_requests`` requests, then the check of the kept answers
against the reference, once the program's state is freed.  The last line of
standard output is the result; the compared numbers, each with its limit,
are the last lines of standard error and the result's last key.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import zlib  # noqa: E402

import numpy as np  # noqa: E402

# top-level modules the run may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "spmv_acc_tpu")


def load(path: str, name: str):
    """The module in the file ``path``, imported under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """What a kind module is handed: the cell's data, its matrix, the device."""

    name: str
    cfg: dict
    traffic: dict
    matrix: object  # perfbench/matrices/<generator>.py
    arrays: tuple  # (row_ptr, col_idx, values, shape), host arrays
    device: object
    draw: object  # inputs.Draw
    seconds: float = 0.0  # making or loading the matrix


@dataclasses.dataclass
class Window:
    """A closed loop's record: each request's seconds and units of work, and
    the answers kept for the check (index -> answer)."""

    latencies: list = dataclasses.field(default_factory=list)
    units: list = dataclasses.field(default_factory=list)
    kept: dict = dataclasses.field(default_factory=dict)
    wall: float = 0.0
    gc_pauses: list = dataclasses.field(default_factory=list)  # (request, seconds)


def _gc_watch(win: Window, index):
    """A ``gc.callbacks`` hook that records each collection's pause and the
    request it fell in, so that a slow request can be told from the
    collector."""
    t = [0.0]

    def hook(phase, info):
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            win.gc_pauses.append((index[0], time.perf_counter() - t[0]))
    return hook


def find(bench: dict, workload: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r} (one of {sorted(cells)})")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, cfg_entry


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def matrix_arrays(root: str, cfg: dict, matrix):
    """The configuration's matrix, from ``perfbench/.cache`` when it was made
    before (keyed by the configuration's contents), else made and saved."""
    key = zlib.crc32(json.dumps(cfg, sort_keys=True).encode())
    path = os.path.join(root, "perfbench", ".cache", f"{cfg['name']}_{key:08x}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["row_ptr"], z["col_idx"], z["values"], tuple(int(s) for s in z["shape"])
    rp, ci, v, shape = matrix.build(cfg)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.partial.npz"
    np.savez(tmp, row_ptr=rp, col_idx=ci, values=v, shape=np.asarray(shape))
    os.replace(tmp, path)
    return rp, ci, v, shape


def run_window(program, seed: int, seconds: float, every: int) -> Window:
    """Requests back to back from index 0 until ``seconds`` have passed since
    the first was sent; the window ends when the last one returns.  Keeps one
    answer in ``every``, drawn from the seed, and the last one."""
    from perfbench import inputs

    win = Window()
    index = [0]
    hook = _gc_watch(win, index)
    gc.callbacks.append(hook)
    try:
        t_start = time.perf_counter()
        t = t_start
        i = 0
        while t - t_start < seconds:
            index[0] = i
            units, answer = program.request(seed, i)
            program.sync()
            t1 = time.perf_counter()
            win.latencies.append(t1 - t)
            win.units.append(units)
            if inputs.kept(seed, i, every):
                win.kept[i] = answer
            t = t1
            i += 1
    finally:
        gc.callbacks.remove(hook)
    win.kept[i - 1] = answer
    win.wall = t - t_start
    return win


def describe_window(win: Window, device) -> str:
    """The slowest request, the collector's pauses and the caching
    allocator's counters over the window: what a stall can be told by."""
    lat = np.asarray(win.latencies)
    slow = int(lat.argmax())
    gc_in_slow = sum(s for j, s in win.gc_pauses if j == slow)
    pauses = [s for _, s in win.gc_pauses]
    text = (f"slowest request {slow} of {len(lat)}: {lat[slow] * 1e3:.3f} ms "
            f"({gc_in_slow * 1e3:.3f} ms of it in the collector); collector: "
            f"{len(pauses)} pauses, {sum(pauses) * 1e3:.3f} ms, longest "
            f"{max(pauses, default=0.0) * 1e3:.3f} ms")
    if device.type == "cuda":
        import torch

        st = torch.cuda.memory_stats(device)
        text += (f"; allocator: {st.get('num_alloc_retries', 0)} retries, "
                 f"{st.get('num_device_alloc', 0)} cudaMalloc, "
                 f"{st.get('num_device_free', 0)} cudaFree, "
                 f"{torch.cuda.memory_reserved(device) / 2**30:.2f} GiB reserved")
    return text


def open_cell(root: str, cell: dict, cfg_entry: dict, dev):
    """The cell's data and matrix, and its kind module.  Points every
    cache of the program into the checkout, at fixed paths, first."""
    cache = os.path.join(root, "perfbench", ".cache")
    os.environ["SPMV_TPU_PLAN_CACHE_DIR"] = os.path.join(root, ".cache", "plans")
    os.environ["SPMV_TPU_CORPUS_CACHE"] = os.path.join(root, ".cache", "corpus")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, root)  # the program, from the checkout
    from perfbench import inputs

    with open(os.path.join(root, cfg_entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "perfbench", "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    kind = load(os.path.join(root, "perfbench", "kinds", f"{traffic['kind']}.py"),
                f"perfbench_kind_{traffic['kind']}")
    matrix = load(os.path.join(root, "perfbench", "matrices", f"{cfg['generator']}.py"),
                  f"perfbench_matrix_{cfg['generator']}")
    t = time.perf_counter()
    arrays = matrix_arrays(root, cfg, matrix)
    rows, nnz = arrays[3][0], int(arrays[0][-1])
    if (cfg.get("rows", rows), cfg.get("nnz", nnz)) != (rows, nnz):
        raise RuntimeError(f"{cfg['name']}: made {rows} rows and {nnz} nnz, the configuration "
                           f"states {cfg.get('rows')} and {cfg.get('nnz')}")
    c = Cell(cell["name"], cfg, traffic, matrix, arrays, dev, inputs.Draw(dev),
             time.perf_counter() - t)
    return c, kind


def leaked_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, root=None, require_cuda=True, device=None, program_factory=None) -> int:
    """Run a cell; returns the exit code.  ``require_cuda``, ``device`` and
    ``program_factory`` (``(kind module, Cell) -> program``) are for the
    tests: a run from the command line needs the card and runs the program."""
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(root or os.getcwd())
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, cfg_entry = find(bench, args.workload)

    import torch

    t_import = time.perf_counter() - _T0
    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device(device or "cuda")
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the CUDA context
    t_card = time.perf_counter() - t
    c, kind = open_cell(root, cell, cfg_entry, dev)
    cache = os.path.join(root, "perfbench", ".cache")
    traffic = c.traffic
    t = time.perf_counter()
    program = program_factory(kind, c) if program_factory else kind.Program(c)
    t_program = time.perf_counter() - t
    t = time.perf_counter()
    for w in range(traffic.get("warmup_requests", 1)):
        program.request(args.seed ^ 0x5EED, -1 - w)  # indices the window never uses
    program.sync()
    t_warm = time.perf_counter() - t
    setup_s = time.perf_counter() - _T0
    print(f"setup: {setup_s:.3f} s (import {t_import:.3f}, card {t_card:.3f}, matrix "
          f"{c.seconds:.3f}, program {t_program:.3f}, warm-up {t_warm:.3f})", file=sys.stderr)

    win = run_window(program, args.seed, args.seconds, traffic["check_every"])
    q = np.percentile(np.asarray(win.latencies) * 1e3, [0, 50, 90, 95, 99, 100])
    print("latency ms: min {:.3f} p50 {:.3f} p90 {:.3f} p95 {:.3f} p99 {:.3f} max {:.3f}".format(
        *q), file=sys.stderr)
    print(f"window: {len(win.latencies)} requests, {sum(win.units)} {kind.UNIT}s "
          f"in {win.wall:.4f} s", file=sys.stderr)
    print(f"window: {describe_window(win, dev)}", file=sys.stderr)

    summary = None
    if args.trace:
        from perfbench import trace

        def segment(warm: bool):
            n = 1 if warm else traffic["trace_requests"]
            units = 0
            for j in range(n):
                u, _ = program.request(args.seed ^ 0x7ACE, (-100 if warm else -200) - j)
                units += u
            program.sync()
            return units

        summary = trace.traced(segment, os.path.join(cache, f"trace_{args.workload}.json"))
        print(f"trace: {summary['kernels']} kernels, {summary['units']} {kind.UNIT}s, "
              f"busy {summary['busy_s']:.6f} s of {summary['window_s']:.6f} s", file=sys.stderr)

    leaked = leaked_modules()
    on_card = dev.type == "cuda"
    peak = max(torch.cuda.max_memory_allocated(d) for d in range(cell["chips"])) if on_card else 0
    program.close()
    del program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if leaked:
        print(f"the run holds {', '.join(leaked)} once the window has closed", file=sys.stderr)
        return 3

    t = time.perf_counter()
    numbers, failed, checked = kind.check(c, args.seed, win)
    print(f"check: {checked} answers against the reference in {time.perf_counter() - t:.3f} s",
          file=sys.stderr)
    correct = checked > 0 and failed == 0 and all(v <= lim for _, v, lim in numbers)

    e2e = dict(kind.end_to_end(win), setup_s=setup_s)
    metrics = {}
    if args.trace:
        from perfbench import peaks

        readings = {
            "unit": kind.UNIT, "window_s": win.wall, "units": sum(win.units),
            "requests": len(win.latencies), "latencies": win.latencies,
            "unit_bytes": kind.unit_bytes(c),
            "peak_gbs": peaks.peak_gbs(dev) if on_card else None, "trace": summary,
        }
        for m in bench["per_layer"]:
            if not applies(m, args.workload):
                continue
            reader = load(os.path.join(root, "perfbench", "metrics", f"{m['name']}.py"),
                          f"perfbench_metric_{m['name'].replace('.', '_')}")
            value = reader.read(readings)
            if value is None:
                print(f"metric {m['name']}: nothing to read", file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if not applies(m, args.workload):
                continue
            if e2e.get(m["name"]) is None:
                print(f"metric {m['name']} was not measured", file=sys.stderr)
                return 4
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    info = {"platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(0) if on_card else dev.type,
            "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(win.latencies), "failed": failed,
              "metrics": metrics, "device": info}
    if summary is not None:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in numbers}
    result["check"]["answers_checked"] = {"value": checked, "limit": 1}
    leaked = leaked_modules()
    if leaked:
        print(f"the run holds {', '.join(leaked)} after its check", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for name, v, lim in numbers:
        print(f"{name} {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"answers_checked {checked} (limit 1: at least)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
