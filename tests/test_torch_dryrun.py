"""The port's multi-device dry run (``dryrun.py``, gates 1-6 of the JAX
package's ``dryrun_multichip``) and its weak-scaling bench
(``parallel/scaling_bench.py``) on gloo ranks.

At one device the dry run skips gate 4b and says so (its fixture puts
outliers between two shards; the JAX package's dry run raises there); at two
it runs every gate.  The weak-scaling rows carry the reference's fields, and
the serial cross-check (``dist_swell_serial_fn`` against the distributed
output, rtol 1e-6) runs inside."""

import contextlib
import io
import os
import tempfile

import pytest
import torch.distributed as dist

from spmv_acc_tpu_torch import dryrun
from spmv_acc_tpu_torch.parallel import scaling_bench
from spmv_acc_tpu_torch.parallel.launch import spawn
from spmv_acc_tpu_torch.parallel.multihost import init_distributed
from spmv_acc_tpu_torch.parallel.scaling_bench import run_weak_scaling


@contextlib.contextmanager
def _one_rank_group():
    with tempfile.TemporaryDirectory() as td:
        init_distributed(coordinator_address="file://" + os.path.join(td, "rendezvous"),
                         num_processes=1, process_id=0, device="cpu")
        try:
            yield
        finally:
            dist.destroy_process_group()


def test_dryrun_one_device_skips_gate_4b():
    out = io.StringIO()
    with _one_rank_group(), contextlib.redirect_stdout(out):
        dryrun.dryrun_multichip(1, device="cpu")
    text = out.getvalue()
    assert "gate 4b skipped: it needs at least 2 devices" in text
    assert "dryrun_multichip(1) on gloo" in text and "hybrid 1x1 mesh golden OK" in text


def test_dryrun_two_devices():
    assert spawn(dryrun.dryrun_multichip, 2, "cpu", 2, "cpu") == [None, None]


def test_dryrun_refuses_a_group_of_another_size():
    with _one_rank_group(), pytest.raises(RuntimeError, match="group of 2 ranks"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="group of 1 ranks"):
        dryrun.dryrun_multichip(1)


def test_weak_scaling_two_devices():
    """run_weak_scaling([1, 2]) on two ranks: both ranks get the same rows,
    with the reference's fields and the structural record."""
    runs = spawn(run_weak_scaling, 2, "cpu", [1, 2, 4], 32768, 16, 2)
    assert runs[0] == runs[1]
    rows = runs[0]
    assert [r["devices"] for r in rows] == [1, 2]  # 4 is skipped: only 2 ranks
    for r in rows:
        assert {"devices", "rows", "nnz", "us_per_spmv", "nnz_per_s", "efficiency",
                "single_device_us", "structural_efficiency"} <= set(r)
        assert r["rows"] == 32768 * r["devices"] and r["us_per_spmv"] > 0
    assert rows[0]["efficiency"] == 1.0


def test_scaling_gate_is_the_reference_rule():
    rows = [dict(devices=1, efficiency=1.0, structural_efficiency=0.9),
            dict(devices=2, efficiency=0.5, structural_efficiency=0.8)]
    assert scaling_bench._gate({"weak_scaling": rows, "structural_only": True}) == 0
    assert scaling_bench._gate({"weak_scaling": rows, "structural_only": False}) == 1
    rows[1]["structural_efficiency"] = 0.7
    assert scaling_bench._gate({"weak_scaling": rows, "structural_only": True}) == 1
    assert scaling_bench._gate({"weak_scaling": rows[:1], "structural_only": True}) == 0


def test_clis_need_a_card_unless_asked_for_the_cpu(capsys):
    assert dryrun.main(["--devices", "1"]) == 2
    assert scaling_bench.main(["--devices", "1"]) == 2
    assert "--device cpu" in capsys.readouterr().err
