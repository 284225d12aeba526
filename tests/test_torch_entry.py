"""The port's single-device entry point (``spmv_acc_tpu_torch/entry.py``) against the
JAX package's ``__graft_entry__.entry()``.

Both build the swell step ``1.0 * A @ x + 1.0 * y`` on the same float32
example (``random_csr(512, 512, 4096, seed=7)``, x and y from
``random_x_y(512, 512, seed=8)``).  The JAX side runs ``jax.jit(fn)`` on the
CPU, its Pallas kernel in interpret mode; the port runs its plain version on
the CPU.  They agree within the float32 gate of ``spmv_acc_tpu/config.py``
(rel 1e-3, abs 1e-5 near 1e-4), and so does each against the float64 golden."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
import spmv_acc_tpu_torch as port
from spmv_acc_tpu.formats.generate import random_csr as ref_random_csr
from spmv_acc_tpu.formats.generate import random_x_y as ref_random_x_y
from spmv_acc_tpu.ops.golden import host_spmv
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.entry import entry
from spmv_acc_tpu_torch.ops import swell
from spmv_acc_tpu_torch.utils.verify import verify_y


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


def test_entry_matches_jax_entry():
    fn, args = entry(device="cpu")
    ours = fn(*args).numpy()
    rfn, rargs = ref_entry.entry()
    theirs = np.asarray(jax.jit(rfn)(*rargs))
    csr = ref_random_csr(512, 512, 4096, seed=7, dtype=np.float32)
    x, y = ref_random_x_y(512, 512, seed=8, dtype=np.float32)
    golden = host_spmv(1.0, 1.0, *csr.to_numpy()[:3], x, y)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape == (512,)
    assert np.isfinite(ours).all()
    for a, b in ((ours, theirs), (ours, golden), (theirs, golden)):
        assert verify_y(a, b, dtype=np.float32).ok


def test_example_args_lie_on_the_requested_device():
    fn, (layout, x, y) = entry(device="cpu")
    assert layout.device.type == x.device.type == y.device.type == "cpu"
    assert x.shape == y.shape == (512,) and x.dtype == y.dtype == layout.dtype == torch.float32
    assert (layout.out_rows, layout.x_rows, layout.r) == (512, 512, 1)
    before = dict(swell.LAUNCHES)
    plain = swell.swell_ax_plain(layout, x) + y
    assert torch.equal(fn(layout, x, y), plain)
    assert dict(swell.LAUNCHES) == before  # the CPU runs the plain version, no launch


def test_entry_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(device="cuda")


def test_entry_points_are_exported():
    from spmv_acc_tpu_torch.dryrun import dryrun_multichip

    assert port.entry is entry and "entry" in port.__all__
    assert port.dryrun_multichip is dryrun_multichip and "dryrun_multichip" in port.__all__
    with pytest.raises(AttributeError):
        port.no_such_name  # noqa: B018
