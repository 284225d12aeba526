"""Distributed SpMV over the ranks of a process group (``torch.distributed``).

Counterpart of ``spmv_acc_tpu/parallel/dist_spmv.py``.  One process per
device: rank d holds row block d of A (``PartitionedCSR``) and block d of x
on its own device, and a call returns block d of y.  Each step either
all-gathers x over the mesh (``dist.all_gather_into_tensor``) or, when
every shard's column span fits its own x block and its two neighbours',
exchanges only the two neighbour blocks (``dist.batch_isend_irecv``; a rank
without a neighbour reads zeros there, as ``ppermute`` gives).  The per-shard
product is the reference's gather and segment sum, plain PyTorch: a gather of
x, then ``index_add_`` into ``local_rows + 1`` rows, the sentinel row dropped.
On a CUDA tensor ``index_add_`` adds in a varying order, so results agree
with the JAX package's under the f64 gate, not bit for bit.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over ranks of the
joined group: its device type follows the group's backend (``nccl`` on the
card, ``gloo`` on the CPU), and a rank's shard is its coordinate in the mesh,
row-major.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .partition import PartitionedCSR, unpad_vector

__all__ = ["dist_spmv", "make_mesh", "shard_partitioned", "dist_spmv_fn",
           "dist_spmv_halo_fn", "halo_feasible", "unpad_y", "mesh_rank", "mesh_device",
           "gather_mesh", "halo_exchanger", "all_reduced_sum"]


def make_mesh(n_devices: int | None = None, axis: str = "x") -> DeviceMesh:
    """A 1-D mesh named ``axis`` over ranks ``0 .. n-1`` of the joined group
    (``n`` defaults to the world size).  Every rank of the group calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a joined process group (init_distributed, "
                           "launch.spawn or torchrun)")
    n = n_devices or dist.get_world_size()
    return DeviceMesh(_device_type(), torch.arange(n), mesh_dim_names=(axis,))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_rank(mesh: DeviceMesh) -> int:
    """This rank's shard: its coordinate in ``mesh``, row-major."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    idx = 0
    for c, s in zip(coord, mesh.mesh.shape):
        idx = idx * int(s) + int(c)
    return idx


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The blocks of every rank of ``group`` in rank order, concatenated."""
    t = t.contiguous()
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def gather_mesh(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every shard's block of ``t`` in shard order: one all-gather over a 1-D
    mesh; over a 2-D mesh the inner axis first, then the outer one."""
    if mesh.ndim == 1:
        return _all_gather(t, mesh.get_group())
    return _all_gather(_all_gather(t, mesh.get_group(1)), mesh.get_group(0))


def halo_exchanger(mesh: DeviceMesh):
    """``exchange(x_local) -> window`` over a 1-D mesh: the left neighbour's
    block, this rank's and the right neighbour's, laid end to end (3 blocks);
    zeros where shard d has no neighbour (d = 0, d = D - 1).  The neighbours'
    blocks are received in place.  The peers are found once: a mesh
    coordinate costs tens of µs of host time."""
    group = mesh.get_group()
    ranks = dist.get_process_group_ranks(group)
    d = mesh_rank(mesh)
    left = ranks[d - 1] if d > 0 else None
    right = ranks[d + 1] if d < len(ranks) - 1 else None

    def exchange(x_local: torch.Tensor) -> torch.Tensor:
        x_local = x_local.contiguous()
        n = x_local.shape[0]
        window = x_local.new_zeros(3 * n)
        window[n: 2 * n] = x_local
        ops = []
        for peer, buf in ((left, window[:n]), (right, window[2 * n:])):
            if peer is not None:
                ops += [dist.P2POp(dist.isend, x_local, peer, group),
                        dist.P2POp(dist.irecv, buf, peer, group)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return window

    return exchange


def all_agree(flag: bool, mesh: DeviceMesh) -> bool:
    """``flag`` and-ed over every rank of the 1-D ``mesh`` (the same answer on all)."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=mesh_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.get_group())
    return bool(t.item())


def shard_partitioned(part: PartitionedCSR, mesh: DeviceMesh) -> PartitionedCSR:
    """This rank's row of the stacked slabs, on its device (``row_offset``
    stays whole, on the host)."""
    d = mesh_rank(mesh)
    if part.shard is not None:
        if part.shard != d:
            raise ValueError(f"partition holds shard {part.shard}, this rank is shard {d}")
        return part
    if mesh.size() != part.num_shards:
        raise ValueError(f"partition has {part.num_shards} shards but the mesh {mesh.size()} ranks")
    dev = mesh_device(mesh)

    def put(a):
        return a[d: d + 1].to(dev)

    return dataclasses.replace(part, values=put(part.values), col_idx=put(part.col_idx),
                               row_ids=put(part.row_ids), col_idx_padded=put(part.col_idx_padded),
                               shard=d)


def _local_spmv(values, col_idx, row_ids, x_full, local_rows):
    """One shard's row-block product.  Padding lanes carry row_id == local_rows."""
    prod = values * x_full[col_idx.long()]
    out = torch.zeros(local_rows + 1, dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, row_ids.long(), prod)[:local_rows]


def _span_ok(cols: np.ndarray, rows: np.ndarray, local_rows: int, s: int, block: int) -> bool:
    """Shard s's live columns lie in blocks s-1 .. s+1 of ``block`` entries."""
    live = rows < local_rows
    if not live.any():
        return True
    lo, hi = int(cols[live].min()), int(cols[live].max())
    return (s - 1) * block <= lo and hi < (s + 2) * block


def _coords(part: PartitionedCSR, padded: bool):
    """(columns, x block length, x length): ``col_idx`` over the global n
    columns in blocks of ``ceil(n / D)``, or with ``padded`` ``col_idx_padded``
    over the square system's padded coordinates in blocks of ``local_rows``."""
    if padded:
        return part.col_idx_padded, part.local_rows, part.num_shards * part.local_rows
    n = part.global_shape[1]
    return part.col_idx, -(-n // part.num_shards), n


def halo_feasible(part: PartitionedCSR, mesh: DeviceMesh | None = None,
                  padded: bool = False) -> bool:
    """True iff every shard's column span fits its own x block plus the two
    neighbour blocks: the condition for the 1-hop halo exchange (``padded``:
    in the padded coordinates of a square system, as CG runs).  On the host
    partition it is decided from every shard; on a rank's shard each rank
    decides its own and the answer is and-ed over ``mesh``, so every rank
    takes the same path."""
    cols, block, _ = _coords(part, padded)
    rows = part.row_ids.cpu().numpy()
    cols = cols.cpu().numpy()
    if part.shard is None:
        return all(_span_ok(cols[s], rows[s], part.local_rows, s, block)
                   for s in range(part.num_shards))
    if mesh is None:
        raise ValueError("a rank's shard needs the mesh to decide the halo path")
    return all_agree(_span_ok(cols[0], rows[0], part.local_rows, part.shard, block), mesh)


def dist_spmv_fn(mesh: DeviceMesh, part: PartitionedCSR, padded: bool = False):
    """``(run, x_pad)``: ``run(values, col_idx, row_ids, x_local)`` takes this
    rank's ``(1, nnz_pad)`` slabs and its ``(x_pad,)`` block of x, all-gathers
    x over the mesh and returns its ``(local_rows,)`` block of y.  With
    ``padded`` x and ``col_idx`` (then ``col_idx_padded``) are in the square
    system's padded coordinates, blocks of ``local_rows``."""
    local_rows = part.local_rows
    _, x_pad, n = _coords(part, padded)

    def run(values, col_idx, row_ids, x_local):
        x_full = gather_mesh(x_local, mesh)
        return _local_spmv(values[0], col_idx[0], row_ids[0], x_full[:n], local_rows)

    return run, x_pad


def dist_spmv_halo_fn(mesh: DeviceMesh, part: PartitionedCSR, padded: bool = False):
    """The 1-hop halo variant of :func:`dist_spmv_fn`: each rank receives only
    its two neighbour x blocks and gathers from the 3-block window, O(3 n / D)
    exchanged per rank instead of O(n).  Requires :func:`halo_feasible`."""
    local_rows = part.local_rows
    _, x_pad, _ = _coords(part, padded)
    exchange = halo_exchanger(mesh)
    base = (mesh_rank(mesh) - 1) * x_pad

    def run(values, col_idx, row_ids, x_local):
        x_halo = exchange(x_local)
        # padding lanes (column 0) may fall outside the window: clamp them in,
        # their value is 0 and their row the dropped sentinel
        cols = (col_idx[0].long() - base).clamp_(0, 3 * x_pad - 1)
        return _local_spmv(values[0], cols, row_ids[0], x_halo, local_rows)

    return run, x_pad


def all_reduced_sum(mesh: DeviceMesh):
    """``reduce(t)``: ``t`` (this rank's sums: a dot product, or a slice of
    F-2's sums) summed over the 1-D ``mesh`` in place (one ``all_reduce``)
    and returned, the same values on every rank."""
    group = mesh.get_group()

    def reduce(t):
        dist.all_reduce(t, group=group)
        return t

    return reduce


def _x_block(x, d: int, block: int, D: int, n: int, device) -> torch.Tensor:
    """Block d of the global (n,) vector x zero-padded to D * block entries."""
    x = torch.as_tensor(x)
    xp = torch.zeros(D * block, dtype=x.dtype, device=x.device)
    xp[:n] = x
    return xp[d * block: (d + 1) * block].to(device).contiguous()


def dist_spmv(part: PartitionedCSR, x, mesh: DeviceMesh | None = None,
              halo: bool | None = None) -> torch.Tensor:
    """y = A @ x with A row-partitioned over the mesh.  ``x`` is the global
    (n,) vector (any device); returns this rank's ``(local_rows,)`` block of
    the padded y, on its device (all blocks: ``launch.gather_padded``; global
    rows: :func:`unpad_y`).  Every rank of the mesh calls it.

    ``halo=None`` takes the 1-hop halo exchange exactly when
    :func:`halo_feasible` holds (banded/FEM row partitions), else all-gather."""
    mesh = mesh or make_mesh(part.num_shards)
    part = shard_partitioned(part, mesh)
    if halo is None:
        halo = halo_feasible(part, mesh)
    run, x_pad = (dist_spmv_halo_fn if halo else dist_spmv_fn)(mesh, part)
    x_local = _x_block(x, part.shard, x_pad, part.num_shards, part.global_shape[1],
                       mesh_device(mesh))
    return run(part.values, part.col_idx, part.row_ids, x_local)


def unpad_y(part: PartitionedCSR, y_padded) -> torch.Tensor:
    """The valid rows of the padded per-shard y, in global order."""
    return unpad_vector(part, y_padded)
