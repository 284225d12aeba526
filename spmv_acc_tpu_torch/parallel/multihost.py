"""Multi-process bootstrap and the hybrid (hosts x devices-per-host) mesh.

Counterpart of ``spmv_acc_tpu/parallel/multihost.py`` on ``torch.distributed``:

* **Bootstrap**: :func:`init_distributed` calls ``dist.init_process_group``
  with explicit arguments (a manual launch), or from torchrun's
  (``MASTER_ADDR``/``RANK``/``WORLD_SIZE``) or SLURM's (``SLURM_JOB_ID``/
  ``SLURM_PROCID``/``SLURM_NTASKS``) environment; without either it returns
  the single-process context, so code written against it runs unchanged in
  one process.  The backend follows the device asked for: ``nccl`` and
  ``cuda:{LOCAL_RANK}`` for the card (the default), ``gloo`` for the CPU;
  it never switches quietly, and a rank that finds no card raises.
* **Teardown**: :func:`shutdown_distributed` drops the distributed solvers
  kept across calls and frees what is unreachable (captured CUDA graphs
  among it) before it leaves the group.
* **Hybrid mesh**: :func:`hybrid_mesh` is a 2-D ``DeviceMesh`` named
  ``("dcn", "ici")`` whose outer axis spans hosts and inner axis each host's
  devices, ranks in process-major order, so the inner axis never crosses a
  host.
* **Staged gather**: :func:`dist_spmv_hier_fn` row-partitions A over the
  flattened (dcn, ici) grid and gathers x in two stages, over ``ici`` first
  (within a host), then over ``dcn``: one block per host crosses the slower
  network.
"""

from __future__ import annotations

import dataclasses
import gc
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .dist_spmv import (_device_type, _x_block, dist_spmv_fn, mesh_device, mesh_rank,
                        shard_partitioned)
from .partition import PartitionedCSR

__all__ = ["DistContext", "init_distributed", "shutdown_distributed", "hybrid_mesh",
           "shard_partitioned_hier", "dist_spmv_hier_fn", "dist_spmv_hier"]


@dataclasses.dataclass(frozen=True)
class DistContext:
    """What a rank knows after bootstrap (one device per process)."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int
    initialized: bool  # whether init_distributed joined a group


def _launcher_env():
    """(rank, world size) from torchrun's or SLURM's environment, or None."""
    env = os.environ
    if env.get("MASTER_ADDR") and "RANK" in env and "WORLD_SIZE" in env:
        return int(env["RANK"]), int(env["WORLD_SIZE"])
    if env.get("SLURM_JOB_ID") and "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        return int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
    return None


def _local_rank() -> int:
    for key in ("LOCAL_RANK", "SLURM_LOCALID"):
        if key in os.environ:
            return int(os.environ[key])
    return 0


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device: str = "cuda",
) -> DistContext:
    """Join this process to a group of ``num_processes``.

    With explicit arguments (``coordinator_address`` as ``host:port`` or an
    ``init_method`` URL such as ``file://...``), a failure raises.  Under
    torchrun or SLURM the group is joined from the environment
    (``env://``: SLURM needs ``MASTER_ADDR``/``MASTER_PORT`` exported), and a
    failure leaves the single-process context.  Otherwise nothing is joined.
    ``device`` is ``"cuda"`` (NCCL, the card ``local_device_ids[0]``, else
    ``LOCAL_RANK``/``SLURM_LOCALID``, else 0) or ``"cpu"`` (gloo)."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    explicit = coordinator_address is not None or process_id is not None
    managed = _launcher_env()
    did_init = False
    if explicit or managed:
        if device == "cuda":
            card = local_device_ids[0] if local_device_ids else _local_rank()
            if card >= torch.cuda.device_count():
                raise RuntimeError(f"no CUDA card {card} for this rank "
                                   f"({torch.cuda.device_count()} visible)")
            torch.cuda.set_device(card)
        backend = "nccl" if device == "cuda" else "gloo"
        if explicit:
            method = coordinator_address or "env://"
            if "://" not in method:
                method = f"tcp://{method}"
            dist.init_process_group(backend, init_method=method, rank=int(process_id or 0),
                                    world_size=int(num_processes or 1))
            did_init = True
        else:
            try:
                dist.init_process_group(backend, init_method="env://", rank=managed[0],
                                        world_size=managed[1])
                did_init = True
            except (ValueError, RuntimeError):
                # a launcher-looking environment without a reachable rendezvous
                # (e.g. SLURM without MASTER_ADDR): auto-detection degrades to
                # one process; explicit launches raise above
                pass
    up = dist.is_initialized()
    return DistContext(
        process_index=dist.get_rank() if up else 0,
        process_count=dist.get_world_size() if up else 1,
        local_device_count=1,
        global_device_count=dist.get_world_size() if up else 1,
        initialized=did_init,
    )


def shutdown_distributed() -> None:
    """Leave the joined process group, if any: first drop every distributed
    solver kept across calls (``models.cg.clear_dist_solver_cache``: a kept
    solver is no garbage, and its graphs hold NCCL collectives), free what
    only reference cycles keep (a captured CUDA graph among it,
    ``utils/graphs.py``) and wait for the card, then destroy the group."""
    from ..models.cg import clear_dist_solver_cache

    clear_dist_solver_cache()
    if not dist.is_initialized():
        return
    gc.collect()
    if dist.get_backend() == "nccl":
        torch.cuda.synchronize()
    dist.destroy_process_group()


def hybrid_mesh(dcn: Optional[int] = None, ici: Optional[int] = None,
                axis_names: tuple = ("dcn", "ici")) -> DeviceMesh:
    """2-D (hosts x devices-per-host) mesh over ranks ``0 .. dcn*ici - 1``,
    process-major, so the inner axis stays within a host.  ``dcn`` defaults to
    the number of hosts (world size over torchrun's ``LOCAL_WORLD_SIZE``),
    ``ici`` to the rest.  Any (dcn, ici) factoring is accepted, which the
    tests and the dry run use on one host.  Every rank of the group calls it,
    so that all create the two axes' subgroups in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("hybrid_mesh needs a joined process group")
    world = dist.get_world_size()
    if dcn is None:
        dcn = max(1, world // int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if ici is None:
        ici = world // dcn
    if dcn * ici > world:
        raise ValueError(f"mesh {dcn}x{ici} needs {dcn * ici} ranks, have {world}")
    ranks = torch.arange(dcn * ici).reshape(dcn, ici)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axis_names))


def shard_partitioned_hier(part: PartitionedCSR, mesh: DeviceMesh) -> PartitionedCSR:
    """This rank's row of the stacked slabs on its device: shard s lives on
    host s // ici, device s % ici (row-partition order matches the mesh's
    process-major layout, so neighbouring shards share a host)."""
    return shard_partitioned(part, mesh)


def dist_spmv_hier_fn(mesh: DeviceMesh, part: PartitionedCSR):
    """``(run, x_pad)`` over the hybrid mesh with the two-stage x gather:
    ``all_gather`` over ici (the host's contiguous x block), then over dcn
    (host blocks in global order).  Same result as the flat all-gather:
    :func:`~.dist_spmv.dist_spmv_fn` on a 2-D mesh, whose gather is staged."""
    return dist_spmv_fn(mesh, part)


def dist_spmv_hier(part: PartitionedCSR, x, mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """y = A @ x over the hybrid mesh: this rank's ``(local_rows,)`` block of
    the padded y (see ``dist_spmv.unpad_y``)."""
    mesh = mesh or hybrid_mesh()
    if mesh.size() != part.num_shards:
        raise ValueError(
            f"partition has {part.num_shards} shards but mesh is {tuple(mesh.mesh.shape)}")
    part = shard_partitioned_hier(part, mesh)
    run, x_pad = dist_spmv_hier_fn(mesh, part)
    x_local = _x_block(x, mesh_rank(mesh), x_pad, part.num_shards, part.global_shape[1],
                       mesh_device(mesh))
    return run(part.values, part.col_idx, part.row_ids, x_local)
