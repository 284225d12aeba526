"""Distributed SpMV over the ranks of a process group (``torch.distributed``).

Counterpart of ``spmv_acc_tpu/parallel/dist_spmv.py``.  One process per
device: rank d holds row block d of A (``PartitionedCSR``) and block d of x
on its own device, and a call returns block d of y.  Each step either
all-gathers x over the mesh (``dist.all_gather_into_tensor``) or, when
every shard's column span fits its own x block and its two neighbours',
receives from each neighbour only the span of its block that the shard
reads (``halo_exchanger``, ``dist.batch_isend_irecv``; a rank without a
neighbour reads zeros there, as ``ppermute`` gives).  ``col_extents`` and
``halo_spans`` decide that window and its spans, here and in
``dist_swell``.  The per-shard
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

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .partition import PartitionedCSR, unpad_vector

__all__ = ["dist_spmv", "make_mesh", "shard_partitioned", "dist_spmv_fn",
           "dist_spmv_halo_fn", "halo_feasible", "unpad_y", "mesh_rank", "mesh_device",
           "gather_mesh", "col_extents", "halo_spans", "halo_exchanger", "all_reduced_sum"]


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


def col_extents(cols, mesh: DeviceMesh | None = None) -> list:
    """Each shard's least and greatest column, ``(lo, hi)``, or None for a
    shard that reads none.  ``cols`` yields every shard's live columns (numpy
    arrays), or with ``mesh`` this rank's alone: the ranks then all-gather
    their two numbers (one small collective, outside any graph)."""
    ext = [(int(c.min()), int(c.max())) if len(c) else None for c in cols]
    if mesh is None:
        return ext
    mine = torch.tensor(ext[0] or (1, 0), dtype=torch.int64, device=mesh_device(mesh))
    return [(lo, hi) if lo <= hi else None
            for lo, hi in gather_mesh(mine, mesh).view(-1, 2).tolist()]


def halo_spans(extents: list, block: int, unit: int = 1):
    """Shard d's ``(left, right)`` for every shard: the trailing entries of
    x block d-1 and the leading entries of block d+1 that its columns
    (``col_extents``) reach, widened to whole units of ``unit`` entries (a
    swell cell reads all r of a node column; block edges are multiples of
    it).  None when a shard reads past its neighbours' blocks, where the
    1-hop halo cannot run."""
    spans = []
    for d, e in enumerate(extents):
        if e is None:
            spans.append((0, 0))
            continue
        lo, hi = e
        if lo < (d - 1) * block or hi >= (d + 2) * block:
            return None
        left = d * block - lo // unit * unit if lo < d * block else 0
        right = -(-(hi + 1) // unit) * unit - (d + 1) * block if hi >= (d + 1) * block else 0
        spans.append((left, right))
    return tuple(spans)


def halo_exchanger(mesh: DeviceMesh, spans, n: int, dtype: torch.dtype):
    """``exchange(x_local) -> window`` over a 1-D mesh: the left neighbour's
    block, this rank's and the right neighbour's (``n`` entries of ``dtype``
    each) laid end to end, in a window made here, zeroed, and kept.  A call
    copies ``x_local`` into its middle, sends each neighbour the span of it
    that the neighbour reads, receives this rank's two spans in place and
    returns the same window every time: ``spans`` holds shard d's ``(left,
    right)`` for every shard (``halo_spans``), and entries outside them, and
    a missing neighbour's (d = 0, d = D - 1), stay zero.  A span of length 0
    makes no point-to-point op, on either side.  The peers are found once (a
    mesh coordinate costs tens of µs of host time), and a call inside a CUDA
    graph capture allocates nothing; its receive is ordered after the kernels
    issued before it, which read the window, as every collective is ordered
    after the current stream's work."""
    group = mesh.get_group()
    ranks = dist.get_process_group_ranks(group)
    d = mesh_rank(mesh)
    left = ranks[d - 1] if d > 0 else None
    right = ranks[d + 1] if d < len(ranks) - 1 else None
    if len(spans) != len(ranks):
        raise ValueError(f"{len(spans)} spans for a mesh of {len(ranks)} ranks")
    window = torch.zeros(3 * n, dtype=dtype, device=mesh_device(mesh))
    mid = window[n: 2 * n]
    ops = []  # to each peer the span of this block it reads; from it, this rank's span
    if left is not None:
        ops += [(dist.isend, mid[: spans[d - 1][1]], left),
                (dist.irecv, window[n - spans[d][0]: n], left)]
    if right is not None:
        ops += [(dist.isend, mid[n - spans[d + 1][0]:], right),
                (dist.irecv, window[2 * n: 2 * n + spans[d][1]], right)]
    p2p = [dist.P2POp(op, buf, peer, group) for op, buf, peer in ops if buf.numel()]

    def exchange(x_local: torch.Tensor) -> torch.Tensor:
        if x_local.shape != mid.shape or x_local.dtype != dtype:
            raise ValueError(f"the halo exchange takes a ({n},) {dtype} block, got "
                             f"{tuple(x_local.shape)} {x_local.dtype}")
        mid.copy_(x_local)
        if p2p:
            for work in dist.batch_isend_irecv(p2p):
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


def _coords(part: PartitionedCSR, padded: bool):
    """(columns, x block length, x length): ``col_idx`` over the global n
    columns in blocks of ``ceil(n / D)``, or with ``padded`` ``col_idx_padded``
    over the square system's padded coordinates in blocks of ``local_rows``."""
    if padded:
        return part.col_idx_padded, part.local_rows, part.num_shards * part.local_rows
    n = part.global_shape[1]
    return part.col_idx, -(-n // part.num_shards), n


def _part_spans(part: PartitionedCSR, mesh: DeviceMesh | None, padded: bool):
    """``halo_spans`` of ``part``'s shards in ``_coords``' blocks (None: the
    halo cannot run), from every shard of the host partition, or from a
    rank's shard and its peers' over ``mesh``."""
    cols, block, _ = _coords(part, padded)
    if part.shard is not None and mesh is None:
        raise ValueError("a rank's shard needs the mesh to decide the halo path")
    rows = part.row_ids.cpu().numpy()
    live = (c[r < part.local_rows] for c, r in zip(cols.cpu().numpy(), rows))
    return halo_spans(col_extents(live, None if part.shard is None else mesh), block)


def halo_feasible(part: PartitionedCSR, mesh: DeviceMesh | None = None,
                  padded: bool = False) -> bool:
    """True iff every shard's column span fits its own x block plus the two
    neighbour blocks: the condition for the 1-hop halo exchange (``padded``:
    in the padded coordinates of a square system, as CG runs).  On the host
    partition it is decided from every shard; on a rank's shard the ranks
    share their extents over ``mesh``, so every rank takes the same path."""
    return _part_spans(part, mesh, padded) is not None


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
    """The 1-hop halo variant of :func:`dist_spmv_fn`: each rank receives from
    its two neighbours only the spans of their x blocks that its rows read
    (``halo_spans``) into a 3-block window it keeps, and gathers from it.
    The window and x are in ``part``'s dtype.  Requires
    :func:`halo_feasible`."""
    local_rows, dtype = part.local_rows, part.values.dtype
    _, x_pad, _ = _coords(part, padded)
    spans = _part_spans(part, mesh, padded)
    if spans is None:
        raise ValueError("a shard's columns reach past its neighbours' x blocks")
    exchange = halo_exchanger(mesh, spans, x_pad, dtype)
    base = (mesh_rank(mesh) - 1) * x_pad

    def run(values, col_idx, row_ids, x_local):
        x_halo = exchange(x_local.to(dtype))
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
