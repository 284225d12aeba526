"""The chained-loop helper (``utils/graphs.py``) and ``time_device_loop`` on
the CPU, where the step runs eagerly: the carry after n steps is an explicit
loop's, bit for bit, for n below, at and above the graph length and with a
remainder, for a tensor carry, a tuple carry and a step that updates in
place; and the swell chains over it (``make_swell_run``,
``make_swell_amx_run``) against the loops they replace, bit for bit.  The
graphs themselves need a card (``tests/test_torch_package.py``, ``cuda``)."""

import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats import banded_csr, random_csr
from spmv_acc_tpu.formats.generate import fem_like_csr
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.ops import swell
from spmv_acc_tpu_torch.ops.xla import axpby_finish
from spmv_acc_tpu_torch.utils import time_device_loop
from spmv_acc_tpu_torch.utils.graphs import UNROLL, Loop, launch_counters


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


def _step(v):
    return torch.sin(v) * 1.5 + v.roll(1)


def _explicit(step, init, n):
    c = init
    for _ in range(n):
        c = step(c)
    return c


def _init():
    return torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, 37))


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 11, 16, 19])
def test_loop_equals_an_explicit_loop(n):
    loop = Loop(_step, _init(), unroll=4)
    assert torch.equal(loop.run(_init(), n), _explicit(_step, _init(), n))


@pytest.mark.parametrize("n", [UNROLL - 1, UNROLL, UNROLL + 1, 2 * UNROLL + 7])
def test_loop_at_the_default_graph_length(n):
    assert torch.equal(Loop(_step, _init()).run(_init(), n), _explicit(_step, _init(), n))


def test_loop_with_a_tuple_carry():
    def step(c):
        a, b, k = c
        return b, a + 0.5 * b, k + 1

    init = (_init(), _init() * 2, torch.zeros((), dtype=torch.int64))
    loop = Loop(step, init, unroll=8)
    got, want = loop.run(init, 21), _explicit(step, init, 21)
    assert isinstance(got, tuple) and int(got[2]) == 21
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_loop_with_an_in_place_step_leaves_init_alone():
    def step(v):
        return v.mul_(1.25).add_(1.0)

    init = _init()
    kept = init.clone()
    loop = Loop(step, init, unroll=4)
    got = loop.run(init, 9)
    assert torch.equal(init, kept)
    assert torch.equal(got, _explicit(lambda v: v * 1.25 + 1.0, kept, 9))
    assert torch.equal(loop.run(init, 9), got)  # run again from the same init


def test_loop_advances_from_its_carry():
    loop = Loop(_step, _init(), unroll=4)
    loop.load(_init())
    loop.advance(6)
    loop.advance(7)
    assert torch.equal(loop.carry, _explicit(_step, _init(), 13))


@pytest.mark.parametrize("unroll", [0, -4])
def test_loop_needs_a_positive_graph_length(unroll):
    with pytest.raises(ValueError, match="at least 1"):
        Loop(_step, _init(), unroll=unroll)


@pytest.mark.parametrize("n", [2, 5, 13])
def test_loop_with_a_graph_length_not_a_power_of_two(n):
    assert torch.equal(Loop(_step, _init(), unroll=3).run(_init(), n), _explicit(_step, _init(), n))


def test_loop_on_the_cpu_counts_no_launch():
    before = [dict(c) for c in launch_counters()]
    csr = CSR.from_numpy(*banded_csr(300, bandwidth=5, seed=70).to_numpy())
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, 300))
    swell.make_swell_run(csr)(x, torch.zeros(300, dtype=torch.float64), 5)
    assert [dict(c) for c in launch_counters()] == before


def test_time_device_loop_on_the_cpu():
    per_us, carry = time_device_loop(_step, _init(), iters=8, reps=2)
    assert per_us >= 0 and torch.equal(carry, _explicit(_step, _init(), 9))


def _old_swell_run(layout, x, y, n, alpha, beta):
    """make_swell_run's loop before the feedback kernel and graphs."""
    for _ in range(n):
        s = axpby_finish(alpha, beta, swell.swell_ax(layout, x), y).float()
        x = x * (1.0 + (s * s).mean().to(x.dtype) * 1e-30)
    return x


@pytest.mark.parametrize("ref,scale", [
    (lambda: banded_csr(300, bandwidth=5, seed=70), 1.0),
    (lambda: banded_csr(300, bandwidth=5, seed=70), 1e8),
    (lambda: random_csr(150, 260, 1700, seed=71), 1e8),
])
def test_make_swell_run_equals_the_old_loop(ref, scale):
    rp, ci, v, (m, n) = ref().to_numpy()
    csr = CSR.from_numpy(rp, ci, v, (m, n))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, n))
    y = torch.from_numpy(rng.uniform(-1, 1, m) * scale)
    run = swell.make_swell_run(csr, 1.25, -0.5)
    want = _old_swell_run(swell.get_swell_plan(csr), x, y, 7, 1.25, -0.5)
    assert torch.equal(run(x, y, 7), want)
    assert torch.equal(run(x, y, 7), want)  # the loop is kept and reloaded
    with pytest.raises(ValueError, match="y of shape"):
        run(x, y[:-1], 1)


def test_make_swell_amx_run_equals_the_old_loop():
    rp, ci, v, (m, n) = fem_like_csr(600, 600, 9000, block=3, seed=5).to_numpy()
    csr = CSR.from_numpy(rp, ci, v, (m, n))
    X = torch.from_numpy(np.random.default_rng(6).uniform(-1, 1, (n, 8)) * 1e8)
    layout = swell.get_swell_plan(csr)
    want = X
    for _ in range(5):
        s = swell.swell_amx(layout, want).float()
        want = want * (1.0 + (s * s).mean().to(want.dtype) * 1e-30)
    assert not torch.equal(want, X)
    assert torch.equal(swell.make_swell_amx_run(csr, 8)(X, 5), want)
