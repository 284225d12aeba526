"""The port's timing and profiling utilities against the JAX package's:
``time_fn`` on the CPU, ``PhaseTimer.report`` and ``bandwidth_report`` with the
reference's text (given the same phases and peak), ``trace`` writing a
``torch.profiler`` trace on the CPU, and the ``utils`` package's re-exports."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import spmv_acc_tpu.utils as ref_utils
from spmv_acc_tpu.utils.profiling import PhaseTimer as RefPhaseTimer
from spmv_acc_tpu.utils.profiling import bandwidth_report as ref_bandwidth_report
from spmv_acc_tpu_torch import utils
from spmv_acc_tpu_torch.utils.profiling import PhaseTimer, bandwidth_report, trace


def test_time_fn_returns_the_result_and_a_time():
    calls = []

    def fn(a, b):
        calls.append(1)
        return a @ b

    a = torch.ones(64, 64, dtype=torch.float64)
    out, us = utils.time_fn(fn, a, a, iters=3)
    assert len(calls) == 4 and us > 0.0
    assert torch.equal(out, torch.full((64, 64), 64.0, dtype=torch.float64))


@pytest.mark.parametrize("block", [True, False])
def test_time_fn_takes_any_result(block):
    out, us = utils.time_fn(lambda: (torch.zeros(3), {"k": [torch.ones(2)]}, 7), block=block)
    assert out[2] == 7 and us >= 0.0
    assert utils.time_fn(lambda: None)[0] is None


@pytest.mark.parametrize("phases", [
    {"analyze": 1234.5678, "kernel": 89.01},
    {"pre": 0.0, "calc": 1e6 / 3, "fixup": 2.25, "destroy": 12.3456},
    {},
])
def test_phase_timer_report_matches_reference(phases):
    ours, theirs = PhaseTimer(), RefPhaseTimer()
    ours.phases, theirs.phases = dict(phases), dict(phases)
    assert ours.report() == theirs.report()


def test_phase_timer_accumulates():
    t = PhaseTimer()
    for _ in range(3):
        with t.phase("a"):
            pass
    with t.phase("b"):
        pass
    assert list(t.phases) == ["a", "b"] and all(v >= 0.0 for v in t.phases.values())
    assert t.report().endswith("us") and "total=" in t.report()


@pytest.mark.parametrize("rows,nnz,time_us,value_bytes,peak", [
    (914_898, 28_191_660, 167.29, 8, 3352.32),
    (23_560, 484_256, 30.0, 4, 3352.32),
    (10, 100, 0.0, 8, 819.0),
    (1, 1, 1e-3, 8, 100.0),
])
def test_bandwidth_report_matches_reference(rows, nnz, time_us, value_bytes, peak):
    assert (bandwidth_report(rows, nnz, time_us, value_bytes, peak_gbs=peak)
            == ref_bandwidth_report(rows, nnz, time_us, value_bytes, peak_gbs=peak))


def test_bandwidth_report_needs_a_peak_without_a_card():
    if torch.cuda.is_available():
        assert "peak=" in bandwidth_report(10, 100, 5.0)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            bandwidth_report(10, 100, 5.0)


def test_trace_writes_a_trace_file_on_the_cpu(tmp_path):
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((128, 128)))
    with trace(str(tmp_path)) as prof:
        (a @ a).sum()
    files = glob.glob(os.path.join(str(tmp_path), "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_utils_reexports_the_reference_names():
    left_behind = {"time_chained"}  # a tunnel workaround, not ported (ROADMAP)
    assert set(ref_utils.__all__) - left_behind <= set(utils.__all__)
    for name in ("CSV_HEADER", "BenchTimes", "bytes_moved", "chip_peak_gbs", "flops",
                 "print_statistics", "roofline_fraction", "time_fn"):
        assert hasattr(utils, name) and name in utils.__all__
    assert utils.CSV_HEADER == ref_utils.CSV_HEADER
    assert utils.bytes_moved(100, 1000) == ref_utils.bytes_moved(100, 1000)
    assert utils.flops(1000) == ref_utils.flops(1000)
