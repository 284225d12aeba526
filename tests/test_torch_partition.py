"""The port's row partition (``parallel/partition.py``) against the JAX
package's, array for array, and its halo test against JAX's on the fixtures
of ``tests/test_parallel.py``.  No processes: the partition is host work."""

import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats import banded_csr as ref_banded
from spmv_acc_tpu.formats import powerlaw_csr as ref_powerlaw
from spmv_acc_tpu.formats import random_csr as ref_random
from spmv_acc_tpu.parallel import balance_row_cuts as ref_balance_row_cuts
from spmv_acc_tpu.parallel import partition_rows as ref_partition_rows
from spmv_acc_tpu.parallel import pad_vector as ref_pad_vector
from spmv_acc_tpu.parallel.dist_spmv import halo_feasible as ref_halo_feasible
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.parallel import (PartitionedCSR, balance_row_cuts, pad_vector,
                                         partition_rows, unpad_vector)
from spmv_acc_tpu_torch.parallel.dist_spmv import halo_feasible

GENS = {
    "random": lambda dt: ref_random(96, 96, 900, seed=42, dtype=dt),
    "powerlaw": lambda dt: ref_powerlaw(96, 96, avg_nnz=7, seed=43, dtype=dt),
    "banded": lambda dt: ref_banded(4000, bandwidth=9, seed=13, dtype=dt),
}


def _port(ref_csr):
    return CSR.from_numpy(*ref_csr.to_numpy())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("balance", [True, False])
@pytest.mark.parametrize("gen", sorted(GENS))
@pytest.mark.parametrize("num_shards", [2, 4, 8])
def test_partition_rows_matches_reference(num_shards, gen, balance, dtype):
    ref_csr = GENS[gen](dtype)
    ref = ref_partition_rows(ref_csr, num_shards, balance=balance)
    ours = partition_rows(_port(ref_csr), num_shards, balance=balance)
    assert isinstance(ours, PartitionedCSR) and ours.shard is None
    for name in ("values", "col_idx", "row_ids", "row_offset", "col_idx_padded"):
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (ours.num_shards, ours.local_rows, ours.global_shape, ours.nnz) == (
        ref.num_shards, ref.local_rows, ref.global_shape, ref.nnz)
    assert ours.padded_rows == ref.padded_rows


@pytest.mark.parametrize("num_shards", [1, 3, 4, 7])
def test_balance_row_cuts_matches_reference(num_shards):
    rp = np.asarray(ref_powerlaw(100, 100, avg_nnz=5, seed=41).row_ptr)
    cuts = balance_row_cuts(rp, num_shards)
    assert np.array_equal(cuts, ref_balance_row_cuts(rp, num_shards))
    assert cuts[0] == 0 and cuts[-1] == 100 and np.all(np.diff(cuts) >= 0)


@pytest.mark.parametrize("balance", [True, False])
@pytest.mark.parametrize("num_shards", [2, 4, 8])
def test_pad_unpad_round_trip(num_shards, balance):
    ref_csr = ref_powerlaw(96, 96, avg_nnz=7, seed=43)
    part = partition_rows(_port(ref_csr), num_shards, balance=balance)
    v = np.random.default_rng(num_shards).standard_normal(96)
    padded = pad_vector(part, v)
    ref = ref_pad_vector(ref_partition_rows(ref_csr, num_shards, balance=balance), v)
    assert padded.shape == (part.padded_rows,) and np.array_equal(padded.numpy(), np.asarray(ref))
    assert np.array_equal(unpad_vector(part, padded).numpy(), v)
    assert np.array_equal(unpad_vector(part, padded.numpy()).numpy(), v)
    assert torch.equal(unpad_vector(part, pad_vector(part, torch.from_numpy(v))),
                       torch.from_numpy(v))


@pytest.mark.parametrize("case", ["banded-2", "banded-4", "banded-8", "random-8", "random-2"])
def test_halo_feasible_matches_reference(case):
    """tests/test_parallel.py:103-136: a banded partition admits the 1-hop
    exchange, a globally scattered one at 8 shards does not."""
    gen, d = case.split("-")
    d = int(d)
    ref_csr = (ref_banded(4000, bandwidth=9, seed=13) if gen == "banded"
               else ref_random(600, 600, 6000, seed=3))
    ref = ref_halo_feasible(ref_partition_rows(ref_csr, d, balance=False))
    assert halo_feasible(partition_rows(_port(ref_csr), d, balance=False)) == ref
    assert ref == (gen == "banded" or d == 2)


def test_sharded_partition_needs_its_mesh():
    part = partition_rows(_port(ref_banded(64, bandwidth=3, seed=1)), 2)
    one = PartitionedCSR(**{**part.__dict__, "values": part.values[:1], "shard": 0})
    with pytest.raises(ValueError, match="mesh"):
        halo_feasible(one)
