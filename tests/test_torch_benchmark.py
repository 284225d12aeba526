"""The port's ``spmv-benchmark`` and ``utils/stats.py`` against the JAX
package's: the same CSV rows byte for byte for the same times and report, the
same bytes and flops models, every engine on the CPU with ``--device cpu``, and
the refusal to run without a CUDA card otherwise.  Tolerance: none (printed
text and integer models must be identical)."""

import io

import pytest
import torch

from spmv_acc_tpu.formats import random_csr
from spmv_acc_tpu.formats.generate import random_x_y
from spmv_acc_tpu.utils import stats as ref_stats
from spmv_acc_tpu.utils.verify import VerifyReport as RefReport
from spmv_acc_tpu_torch.cli import benchmark
from spmv_acc_tpu_torch.cli.main import main as cli_main
from spmv_acc_tpu_torch.io import write_csr_text
from spmv_acc_tpu_torch.utils import stats
from spmv_acc_tpu_torch.utils.verify import VerifyReport

CASES = [
    ((12.5, 340.25, 0.0, 0.0), (3.2e-13, -1, 0), (300, 300, 2400, 8)),
    ((0.0, 1e-3, 2.0, 0.5), (1.5e-3, 7, 12), (23560, 23560, 484256, 4)),
    ((1e6, 0.0, 0.0, 0.0), (0.0, -1, 0), (1, 64, 30, 8)),
]


@pytest.mark.parametrize("times,report,shape", CASES)
def test_print_statistics_rows_match_reference(times, report, shape):
    rows, cols, nnz, vb = shape
    ref_out, out = io.StringIO(), io.StringIO()
    want = ref_stats.print_statistics("m.bin2", "spmv-acc-swell", rows, cols, nnz,
                                      ref_stats.BenchTimes(*times), RefReport(*report),
                                      value_bytes=vb, file=ref_out)
    got = stats.print_statistics("m.bin2", "spmv-acc-swell", rows, cols, nnz,
                                 stats.BenchTimes(*times), VerifyReport(*report),
                                 value_bytes=vb, file=out)
    assert got == want and out.getvalue() == ref_out.getvalue()
    assert stats.CSV_HEADER == ref_stats.CSV_HEADER
    assert stats.bytes_moved(rows, nnz, vb) == ref_stats.bytes_moved(rows, nnz, vb)
    assert stats.flops(nnz) == ref_stats.flops(nnz)
    assert stats.roofline_fraction(rows, nnz, 100.0, vb, peak_gbs=3352.32) == \
        ref_stats.roofline_fraction(rows, nnz, 100.0, vb, peak_gbs=3352.32)


def test_median_times_matches_reference():
    calc = [5.0, 1.0, 3.0, 4.0, 2.0]
    got = stats.median_times([stats.BenchTimes(pre=i, calc=c) for i, c in enumerate(calc)])
    want = ref_stats.median_times([ref_stats.BenchTimes(pre=i, calc=c) for i, c in enumerate(calc)])
    assert (got.pre, got.calc) == (want.pre, want.calc)


def test_chip_peak_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        stats.chip_peak_gbs()
    with pytest.raises(RuntimeError):
        stats.roofline_fraction(100, 1000, 10.0)


@pytest.fixture
def csr_file(tmp_path):
    ref = random_csr(300, 300, 2400, seed=37)
    rp, ci, v, shape = ref.to_numpy()
    x, _ = random_x_y(shape[1], shape[0], seed=38)
    path = tmp_path / "m.csr"
    write_csr_text(path, rp, ci, v, x)
    return str(path)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_benchmark_all_engines_on_cpu(csr_file, dtype, capsys):
    rc = benchmark.main([csr_file, "-f", "csr", "--device", "cpu", "--dtype", dtype,
                         "--iters", "2", "--warmups", "1"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    lines = out.out.splitlines()
    assert lines[0] == stats.CSV_HEADER
    rows = [ln.split(",") for ln in lines[1:] if ln.startswith("PERFORMANCE,")]
    assert [r[2] for r in rows] == [name for name, _ in benchmark.ENGINES]
    assert len(benchmark.ENGINES) == 17
    for r in rows:
        assert len(r) == 19 and r[1] == "m.csr" and r[3:6] == ["300", "300", "2400"]
        assert r[-3:-1] == ["-1", "0"], r  # first_failed_at, failed_count
        assert float(r[12]) > 0  # calc(us)


def test_benchmark_engine_filter_and_failures(csr_file, capsys, monkeypatch):
    rc = benchmark.main([csr_file, "--device", "cpu", "--iters", "1", "--warmups", "0",
                         "--engines", "spmv-acc-vector-row,torch-sparse-csr"])
    assert rc == 0
    assert len([ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("PERFORMANCE,m.csr")]) == 2

    def boom(*a, **k):
        raise RuntimeError("engine crashed")

    monkeypatch.setattr(benchmark, "make_spmv_fn", boom)
    rc = benchmark.main([csr_file, "--device", "cpu", "--iters", "1", "--warmups", "0",
                         "--engines", "spmv-acc-flat,numpy-cpu"])
    out = capsys.readouterr()
    assert rc == 1
    assert "ERROR,m.csr,spmv-acc-flat,RuntimeError: engine crashed" in out.err
    assert len([ln for ln in out.out.splitlines() if ln.startswith("PERFORMANCE,m.csr")]) == 1


def test_clis_refuse_to_run_without_cuda(csr_file, capsys, monkeypatch):
    """Without --device both CLIs run on CUDA; with no card they stop with a
    non-zero exit code instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert benchmark.main([csr_file, "-f", "csr"]) == 2
    assert cli_main([csr_file, "-f", "csr"]) == 2
    err = capsys.readouterr().err
    assert err.count("--device cpu") == 2
