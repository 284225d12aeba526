"""The span table of ``utils.profiling`` and the spans the port opens, on the
CPU: nesting and self seconds, counters, copies and ``reset``;
``record_function`` entered only while a profiler records (a ``torch.profiler``
schedule's active step, not its warm-up); the spans a CG solve, a plan and an
ILU(0) factor leave; and ``Trace.kernels`` with its warning."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from spmv_acc_tpu_torch.formats import CSR
from spmv_acc_tpu_torch.formats.generate import aniso_laplacian_csr
from spmv_acc_tpu_torch.models.cg import CG_EAGER_ITERS, cg_solve, jacobi_preconditioner
from spmv_acc_tpu_torch.ops import swell, trisolve
from spmv_acc_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _empty_table():
    profiling.reset()
    yield
    profiling.reset()


def _clock(monkeypatch, *ns):
    """The spans' clock reads ``ns`` in turn."""
    ticks = iter(ns)
    monkeypatch.setattr(profiling, "_now", lambda: next(ticks))


def _system(n=24):
    """An SPD system whose Jacobi CG takes 117 iterations at n = 24, tol 1e-10."""
    csr = CSR.from_numpy(*aniso_laplacian_csr(n, n, 1e-2).to_numpy())
    return csr, torch.ones(n * n, dtype=torch.float64)


def test_nesting_gives_self_seconds(monkeypatch):
    # outer 0..100 holds a 10..40 and b 50..60; b holds c 52..55
    _clock(monkeypatch, 0, 10, 40, 50, 52, 55, 60, 100)
    with profiling.span("outer"):
        with profiling.span("a"):
            pass
        with profiling.span("b"):
            with profiling.span("c"):
                pass
    t = profiling.spans()
    assert t["outer"] == profiling.Stat(1, 100e-9, 60e-9, 0)
    assert t["a"] == profiling.Stat(1, 30e-9, 30e-9, 0)
    assert t["b"] == profiling.Stat(1, 10e-9, 7e-9, 0)
    assert t["c"] == profiling.Stat(1, 3e-9, 3e-9, 0)


def test_a_span_adds_up_and_records_a_raise(monkeypatch):
    _clock(monkeypatch, 0, 5, 10, 30, 40, 41)
    with profiling.span("s"):
        pass
    with pytest.raises(ValueError):
        with profiling.span("s"):
            raise ValueError("the block raised")
    assert profiling.spans()["s"] == profiling.Stat(2, 25e-9, 25e-9, 0)
    with profiling.span("after"):  # the raise left no span open
        pass
    assert profiling.spans()["after"].self_seconds == profiling.spans()["after"].seconds


def test_counters_copies_since_and_reset():
    profiling.count("bytes", 100)
    profiling.count("bytes", 28)
    profiling.count("events")
    before = profiling.spans()
    assert before["bytes"] == profiling.Stat(2, 0.0, 0.0, 128)
    assert before["events"].total == 1
    profiling.count("bytes", 72)
    grown = profiling.since(before)
    assert set(grown) == {"bytes"} and grown["bytes"] == profiling.Stat(1, 0.0, 0.0, 72)
    assert before["bytes"].total == 128  # a copy: later adds leave it alone
    profiling.reset()
    assert profiling.spans() == {}


def test_threads_merge_into_one_table_and_lose_no_update():
    """Threads that open spans and add to counters while the table is read:
    every exit and every add is in the merged table."""
    workers, rounds = 16, 2000

    def work():
        for _ in range(rounds):
            with profiling.span("t"):
                profiling.count("n", 2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for th in threads:
            th.start()
        while any(th.is_alive() for th in threads):
            profiling.spans()  # merged while the threads write
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    with profiling.span("t"):
        pass
    t = profiling.spans()
    assert t["t"].count == workers * rounds + 1
    assert t["n"] == profiling.Stat(workers * rounds, 0.0, 0.0, 2 * workers * rounds)


def test_no_profiler_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    csr, b = _system()
    res = cg_solve(csr, b, tol=1e-10, max_iters=2000, strategy="swell",
                   precond=jacobi_preconditioner(csr))
    assert res.iters > CG_EAGER_ITERS and profiling.spans()["cg.solve"].count == 1


def test_profiler_active_step_records_the_spans(tmp_path, monkeypatch):
    """A CPU ``torch.profiler`` schedule of warm-up 1, active 1 around one
    solve a step: the spans enter ``record_function`` in the active step
    alone, and the exported trace holds them as ``user_annotation`` events
    inside that step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    real = torch.profiler.record_function
    entered = []

    def counted(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    csr, b = _system()

    def solve():  # a new preconditioner object: a new solver, its plain start included
        cg_solve(csr, b, tol=1e-10, max_iters=2000, strategy="swell",
                 precond=jacobi_preconditioner(csr))

    solve()  # the plan
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        solve()
        warm = list(entered)
        prof.step()
        solve()
        prof.step()
    assert warm == []
    assert entered == ["cg.solve", "cg.eager", "cg.blocks"]
    events = json.load(open(path))["traceEvents"]
    steps = [e for e in events if str(e.get("name", "")).startswith("ProfilerStep#")]
    (active,) = [e for e in steps if e["name"] == "ProfilerStep#1"]
    notes = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] in ("cg.solve", "cg.eager", "cg.blocks")]
    # one of each, the active step's: the warm-up step's solve left none
    assert sorted(e["name"] for e in notes) == ["cg.blocks", "cg.eager", "cg.solve"]
    for e in notes:
        assert active["ts"] <= e["ts"] and e["ts"] + e["dur"] <= active["ts"] + active["dur"]


def test_a_cpu_solve_leaves_one_span_of_each_phase():
    csr, b = _system()
    M = jacobi_preconditioner(csr)
    swell.get_swell_plan(csr)
    profiling.reset()
    res = cg_solve(csr, b, tol=1e-10, max_iters=2000, strategy="swell", precond=M)
    assert res.iters > CG_EAGER_ITERS + 8  # several blocks: still one span of each
    t = profiling.spans()
    assert {k: s.count for k, s in t.items()} == {"cg.solve": 1, "cg.eager": 1, "cg.blocks": 1,
                                                  "cg.solvers.built": 1}
    assert "graphs.capture" not in t and "graphs.pool_bytes" not in t  # no capture on the CPU
    solve = t["cg.solve"]
    assert solve.self_seconds == pytest.approx(
        solve.seconds - t["cg.eager"].seconds - t["cg.blocks"].seconds, abs=1e-9)


def test_a_short_solve_runs_no_block():
    csr, b = _system(6)
    res = cg_solve(csr, b, tol=1e-10, max_iters=2000, strategy="swell")
    assert res.iters < CG_EAGER_ITERS
    t = profiling.spans()
    assert t["cg.solve"].count == t["cg.eager"].count == 1 and "cg.blocks" not in t


def test_each_plan_built_is_a_span_and_a_hit_is_not():
    a, _ = _system(12)
    b = CSR.from_numpy(*aniso_laplacian_csr(14, 9, 1e-2).to_numpy())
    swell.get_swell_plan(a)
    swell.get_swell_plan(b)
    swell.get_swell_plan(a)  # a cache hit
    t = profiling.spans()
    assert t["swell.plan"].count == 2
    for step in ("host_copy", "slabs", "layout", "schedule", "h2d"):
        assert t[f"swell.plan.{step}"].count == 2
    steps = sum(s.seconds for k, s in t.items() if k.startswith("swell.plan."))
    assert t["swell.plan"].self_seconds == pytest.approx(t["swell.plan"].seconds - steps,
                                                         abs=1e-9)
    before = profiling.spans()
    swell.get_swell_plan(b)
    assert profiling.since(before) == {} and swell.plan_steps(before) == {}


def test_ilu0_span_holds_its_factors_plans(monkeypatch):
    monkeypatch.setattr(trisolve, "ILU_SWELL_MIN", 0)  # the factors' sweeps on swell
    csr, _ = _system(10)
    fact = trisolve.ilu0(csr, sweeps=3)
    assert fact.swell is not None
    t = profiling.spans()
    assert t["ilu0"].count == 1 and t["swell.plan"].count == 2
    assert t["ilu0"].self_seconds == pytest.approx(
        t["ilu0"].seconds - t["swell.plan"].seconds, abs=1e-9)


def test_trace_counts_kernels_and_warns_when_none(tmp_path, capsys):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "swell_kernel", "ts": 1, "dur": 2},
        {"ph": "X", "cat": "Kernel", "name": "cg_step", "ts": 4, "dur": 2},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 7, "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 9},
        {"ph": "X", "cat": "user_annotation", "name": "cg.solve", "ts": 0, "dur": 9},
    ]}))
    out = profiling.Trace(str(path))
    out.kernels = profiling.kernels_in(str(path))
    assert out.kernels == 2
    profiling.warn_if_empty(out)
    assert capsys.readouterr().err == ""
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 9}]}))
    out.kernels = profiling.kernels_in(str(path))
    assert out.kernels == 0
    profiling.warn_if_empty(out)
    assert "recorded no kernel" in capsys.readouterr().err


def test_trace_on_the_cpu_counts_no_kernel_and_stays_quiet(tmp_path, capsys):
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64)))
    with profiling.trace(str(tmp_path)) as out:
        (a @ a).sum()
    assert out.kernels == 0 and "recorded no kernel" not in capsys.readouterr().err
