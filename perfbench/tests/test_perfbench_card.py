"""The harness on the card at tiny sizes: every cell traced, correct, its
per-layer metrics read from the profiler; the control not correct.

    python3 -m pytest perfbench/tests/test_perfbench_card.py -m cuda -q
"""

import pytest
import torch

from perfbench.tests.helpers import CELLS, result, run_cell, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU build)")
    return tiny_root(str(tmp_path_factory.mktemp("card")))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_traced_cell_on_the_card(root, workload):
    rc, out, err = run_cell(root, workload, seconds=1, trace=1, device="'cuda'",
                            require_cuda=True)
    assert rc == 0, err[-3000:]
    res = result(out)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["metrics"] and res["breakdown"]["device_ops"]
    for name, m in res["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 105, (name, m)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_on_the_card(root, workload):
    rc, out, err = run_cell(root, workload, seconds=1, device="'cuda'", require_cuda=True,
                            factory="lambda kind, cell: kind.Control(cell)")
    assert rc == 0, err[-3000:]
    assert result(out)["correct"] is False
