"""``load_csr``: it builds the matrix on the card by default, as the JAX
package's ``load_csr`` places it on its default device, and raises where there
is no card rather than moving to the CPU."""

import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats.generate import example_like
from spmv_acc_tpu.io import load_csr as ref_load_csr
from spmv_acc_tpu.io import write_bin2
from spmv_acc_tpu_torch.io import load_csr


@pytest.fixture
def bin2_path(tmp_path):
    path = str(tmp_path / "rajat03.bin2")
    write_bin2(path, *example_like("rajat03").to_numpy())
    return path


def test_load_csr_defaults_to_the_card(bin2_path):
    if torch.cuda.is_available():
        assert load_csr(bin2_path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_csr(bin2_path)


def test_load_csr_on_the_cpu_matches_the_reference(bin2_path):
    csr = load_csr(bin2_path, device="cpu")
    assert csr.device.type == "cpu"
    got, want = csr.to_numpy(), ref_load_csr(bin2_path).to_numpy()
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert tuple(got[3]) == tuple(want[3])
