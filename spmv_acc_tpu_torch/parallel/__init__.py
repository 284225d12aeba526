"""The multi-device layer on ``torch.distributed``: one process per device.

Counterpart of ``spmv_acc_tpu/parallel``: row partitions (``partition``),
the all-gather and 1-hop halo SpMV (``dist_spmv``), the swell kernel as each
shard's product (``dist_swell``), the bootstrap and hybrid mesh
(``multihost``), the weak-scaling bench (``scaling_bench``), and the ranks'
launcher (``launch``: ``spawn``, ``gather_padded``).  Where the JAX package
returns an array sharded over a mesh, the port returns the calling rank's
block of it.
"""

from .dist_spmv import dist_spmv, dist_spmv_fn, make_mesh, shard_partitioned, unpad_y
from .launch import gather_padded, spawn
from .partition import (
    PartitionedCSR,
    balance_row_cuts,
    pad_vector,
    partition_rows,
    unpad_vector,
)

__all__ = [
    "dist_spmv",
    "dist_spmv_fn",
    "make_mesh",
    "shard_partitioned",
    "unpad_y",
    "PartitionedCSR",
    "balance_row_cuts",
    "pad_vector",
    "partition_rows",
    "unpad_vector",
    "gather_padded",
    "spawn",
]
