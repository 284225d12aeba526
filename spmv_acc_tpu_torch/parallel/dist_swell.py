"""Distributed SpMV with the swell kernel as each shard's local product.

Counterpart of ``spmv_acc_tpu/parallel/dist_swell.py``.  The JAX package cuts
the global swell plan by its TPU out-windows and stacks the per-shard bucket
steps; the port cuts its own global layout (``ops.swell_plan.SwellLayout``)
by row blocks:

* The host layout is built once (or loaded from the disk plan cache: with a
  mesh and the cache on, rank 0 builds and saves it, and the other ranks load
  it after a barrier).  Shard d owns the row blocks ``[d*K, (d+1)*K)``,
  ``K = ceil(mrb / D)``, so every shard's y block has the same length
  ``rows_local = K*128*r`` and the blocks laid end to end are the padded
  global y; for a square system x is sharded the same way.
* A shard is a slice of the layout's arrays, rebased to its first slab and
  slot: ``rb_slab_ptr``, ``slab_off``, ``slab_log2d``, ``slab_col_base``,
  ``vals`` and ``lidx``.  A short last shard gets row blocks without slabs;
  the chunk schedule gives each of those one empty chunk, which writes zeros.
  The COO tail is split at the shard rows, its rows made local (still
  row-sorted).
* **All-gather**: x is gathered over the mesh and cut to its n columns.
  **Halo**: when every shard's cells and tail entries lie in its own x block
  or its two neighbours', the shard's columns are rebased to that 3-block
  window (``x_rows = 3*rows_local``) and a call exchanges only the neighbour
  blocks.  The kernel skips node columns outside ``[0, x_rows)``, so padding
  slots that fall outside the window read nothing; real cells never do, as
  the window test is made on the matrix's columns.
* Each shard's product is ``swell_ax``: the swell kernel (K-a in float64,
  K-f in float32) on a CUDA tensor, its plain version on a CPU tensor.

The shard unit (a 128*r-row block, not the TPU out-window of ``tile_rb*128*r``
rows) means ``rows_local``, ``padded_len`` and even ``halo_ok`` can differ
from the JAX package's on the same matrix; ``y[:m]`` and CG solutions agree.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import LANES
from ..ops.swell import PLAN_TIMES, DeviceSwellLayout, _host_layout, _plan_cache_on, _torch_dtype, swell_ax
from ..ops.swell_plan import ChunkSchedule, SwellLayout, build_swell_schedule
from .dist_spmv import gather_mesh, halo_exchanger, mesh_device, mesh_rank

__all__ = ["DistSwellPlan", "build_dist_swell", "dist_swell_spmv_fn",
           "dist_swell_halo_spmv_fn", "dist_swell_serial_fn", "dist_swell_cg_solve",
           "pad_global"]

_CHUNK = LANES * LANES  # node columns per x chunk


@dataclasses.dataclass
class DistSwellPlan:
    """The D shards of one swell layout (host arrays), with their schedules."""

    shards: Tuple[SwellLayout, ...]       # shard d: row blocks [d*K, (d+1)*K), rebased
    schedules: Tuple[ChunkSchedule, ...]  # build_swell_schedule of each shard
    num_shards: int
    blocks_per_shard: int                 # K row blocks of 128 node rows
    rows_local: int                       # K * 128 * r (uniform per shard)
    shape: Tuple[int, int]                # global (m, n)
    r: int
    dtype: torch.dtype
    halo_ok: bool                         # columns rebased to the 3-block window

    @property
    def padded_len(self) -> int:
        return self.num_shards * self.rows_local

    @property
    def x_rows(self) -> int:
        """The length of x each shard's product reads."""
        return 3 * self.rows_local if self.halo_ok else self.shape[1]

    @property
    def tail_nnz(self) -> int:
        return sum(len(s.tail_v) for s in self.shards)

    def device_layout(self, d: int, device) -> DeviceSwellLayout:
        """Shard d on ``device``: a ``rows_local`` x ``x_rows`` layout."""
        return DeviceSwellLayout.from_host(self.shards[d], device, self.rows_local, self.x_rows,
                                           self.schedules[d])


def _shared_host_layout(csr, tdtype: torch.dtype, mesh) -> SwellLayout:
    """The global host layout.  With a mesh of several ranks and the disk plan
    cache on, rank 0 builds and saves it first and the others load it after a
    barrier, instead of each rank paying the build."""
    device = csr.device if mesh is None else mesh_device(mesh)
    PLAN_TIMES.clear()
    if mesh is None or mesh.size() == 1 or not _plan_cache_on(device):
        lay, cells = _host_layout(csr, tdtype, None, device)
    elif mesh_rank(mesh) == 0:
        try:
            lay, cells = _host_layout(csr, tdtype, None, device)
        finally:
            dist.barrier(group=mesh.get_group())
    else:
        dist.barrier(group=mesh.get_group())
        lay, cells = _host_layout(csr, tdtype, None, device)
    if lay is None:
        raise ValueError(f"the swell layout of this {csr.shape[0]}x{csr.shape[1]} matrix would "
                         f"hold {cells} value slots, more than SWELL_MAX_SLOTS")
    return lay


def _windows_fit(rp: np.ndarray, ci: np.ndarray, m: int, D: int, L: int) -> bool:
    """Every column of shard d's rows lies in [(d-1)*L, (d+2)*L)."""
    for d in range(D):
        a, b = int(rp[min(d * L, m)]), int(rp[min((d + 1) * L, m)])
        if b > a:
            c = ci[a:b]
            if int(c.min()) < (d - 1) * L or int(c.max()) >= (d + 2) * L:
                return False
    return True


def _kernel_cells(vals: np.ndarray, r: int) -> int:
    """Slots holding a nonzero cell (each 128-slot row stores r*r lane planes)."""
    if r == 1:
        return int(np.count_nonzero(vals))
    return int(vals.reshape(-1, r * r, LANES).any(axis=1).sum())


def _shard(lay: SwellLayout, d: int, K: int, L: int, halo: bool) -> SwellLayout:
    """Row blocks [d*K, (d+1)*K) of ``lay``, rebased to their first slab and
    slot; with ``halo`` the columns rebased to the window that starts at
    shard d-1's first row."""
    r = lay.r
    rb0, rb1 = min(d * K, lay.mrb), min((d + 1) * K, lay.mrb)
    ptr = lay.rb_slab_ptr[rb0: rb1 + 1].astype(np.int64)
    s0, s1 = int(ptr[0]), int(ptr[-1])
    rb_slab_ptr = np.full(K + 1, s1 - s0, dtype=np.int64)
    rb_slab_ptr[: len(ptr)] = ptr - s0
    off = np.append(lay.slab_off, len(lay.lidx))
    o0, o1 = int(off[s0]), int(off[s1])
    shift = (d - 1) * L if halo else 0  # elements; node columns: shift // r
    t0, t1 = np.searchsorted(lay.tail_rows, [d * L, (d + 1) * L])
    tail_ci = lay.tail_ci[t0:t1].astype(np.int64) - shift
    if halo and len(tail_ci) and (tail_ci.min() < 0 or tail_ci.max() >= 3 * L):
        raise RuntimeError("a tail column escaped its shard's halo window")
    vals = lay.vals[o0 * r * r: o1 * r * r]
    cols = 3 * L // r if halo else lay.cols
    kernel = _kernel_cells(vals, r)
    return SwellLayout(
        rows=K * LANES, cols=cols, r=r, nnz=kernel + int(t1 - t0), delta=lay.delta,
        nchunks=max(1, -(-(cols + lay.delta) // _CHUNK)), vals=vals, lidx=lay.lidx[o0:o1],
        slab_off=lay.slab_off[s0:s1] - o0, slab_log2d=lay.slab_log2d[s0:s1],
        slab_col_base=(lay.slab_col_base[s0:s1].astype(np.int64) - shift // r).astype(np.int32),
        rb_slab_ptr=rb_slab_ptr, tail_rows=(lay.tail_rows[t0:t1] - d * L).astype(np.int32),
        tail_ci=tail_ci.astype(np.int32), tail_v=lay.tail_v[t0:t1], kernel_nnz=kernel,
        fill=kernel / len(vals) * r * r if len(vals) else 1.0)


def build_dist_swell(csr, num_shards: int, dtype=None, halo: bool | None = None,
                     mesh=None) -> DistSwellPlan:
    """Cut the swell layout of ``csr`` (host or device) into ``num_shards``
    row-block shards.

    ``halo=None`` rebases the columns to each shard's 3-block window when the
    matrix allows it (``halo_ok``), as the JAX package decides; ``False``
    keeps global columns (the all-gather layout), ``True`` raises when the
    window does not hold.  With ``mesh`` (every rank of it calls this) and the
    disk plan cache on for the mesh's device, the ranks share one build."""
    tdtype = csr.values.dtype if dtype is None else _torch_dtype(dtype)
    if tdtype not in (torch.float64, torch.float32):
        raise ValueError(f"swell runs float64 and float32, not {dtype}")
    if tdtype == torch.float64 and csr.values.dtype != torch.float64:
        raise ValueError(f"build_dist_swell(dtype=float64) requires float64 CSR values, "
                         f"got {csr.values.dtype}")
    lay = _shared_host_layout(csr, tdtype, mesh)
    D, r = num_shards, lay.r
    K = max(1, -(-lay.mrb // D))
    L = K * LANES * r
    m, n = csr.shape
    fits = n <= D * L
    if fits and halo is not False:
        rp, ci, _, _ = csr.to_numpy()
        fits = _windows_fit(rp.astype(np.int64), ci, m, D, L)
    if halo and not fits:
        raise ValueError("halo=True, but a shard's columns reach past its neighbours' x blocks")
    halo_ok = fits if halo is None else bool(halo)
    shards = tuple(_shard(lay, d, K, L, halo_ok) for d in range(D))
    return DistSwellPlan(
        shards=shards, schedules=tuple(build_swell_schedule(s) for s in shards),
        num_shards=D, blocks_per_shard=K, rows_local=L, shape=(m, n), r=r, dtype=tdtype,
        halo_ok=halo_ok)


def pad_global(dsp: DistSwellPlan, v) -> torch.Tensor:
    """A global (m,) vector zero-padded to the sharded length D * rows_local
    (on ``v``'s device); rank d's block is ``[d*rows_local, (d+1)*rows_local)``."""
    v = torch.as_tensor(v)
    if v.shape[0] > dsp.padded_len:
        raise ValueError(f"a vector of {v.shape[0]} entries does not fit {dsp.padded_len}")
    out = torch.zeros(dsp.padded_len, dtype=v.dtype, device=v.device)
    out[: v.shape[0]] = v
    return out


def _rank_layout(dsp: DistSwellPlan, mesh) -> DeviceSwellLayout:
    if mesh.size() != dsp.num_shards:
        raise ValueError(f"plan has {dsp.num_shards} shards but the mesh {mesh.size()} ranks")
    return dsp.device_layout(mesh_rank(mesh), mesh_device(mesh))


def dist_swell_halo_spmv_fn(dsp: DistSwellPlan, mesh):
    """The 1-hop halo variant: each rank receives its two neighbours' x blocks
    (zeros past the ends) and runs its shard over the 3-block window, O(3n/D)
    exchanged per rank.  Requires ``dsp.halo_ok``."""
    if not dsp.halo_ok:
        raise ValueError("plan was not built halo-feasible")
    layout = _rank_layout(dsp, mesh)
    exchange = halo_exchanger(mesh)

    def run(x_local):
        return swell_ax(layout, exchange(x_local))

    return run


def dist_swell_spmv_fn(dsp: DistSwellPlan, mesh, halo: bool | None = None):
    """``run(x_local) -> y_local``, called on every rank of the 1-D ``mesh``:
    x enters as this rank's ``(rows_local,)`` block of the padded global
    vector (``pad_global``), y leaves as its block of the padded y.
    ``halo=None`` takes the 1-hop halo exchange when the plan was built for
    it, else the all-gather."""
    if halo is None:
        halo = dsp.halo_ok
    if halo:
        return dist_swell_halo_spmv_fn(dsp, mesh)
    if dsp.halo_ok:
        # the columns were rebased into per-shard windows at build time; the
        # global-column gather path cannot run on this plan
        raise ValueError("plan built halo-feasible; use halo=True (or rebuild with halo=False)")
    layout = _rank_layout(dsp, mesh)
    n = dsp.shape[1]

    def run(x_local):
        return swell_ax(layout, gather_mesh(x_local, mesh)[:n])

    return run


def dist_swell_serial_fn(dsp: DistSwellPlan, device="cuda"):
    """The structural single-device baseline: the same D shard layouts run
    one after another on ``device`` (D launches of the swell kernel on a
    card), each reading its x window out of the whole padded vector instead
    of an exchange.  ``T_serial / T_dist`` then isolates what distribution
    adds.  Returns ``run(x_padded) -> y_padded``."""
    device = torch.device(device)
    layouts = [dsp.device_layout(d, device) for d in range(dsp.num_shards)]
    L, n = dsp.rows_local, dsp.shape[1]
    if dsp.halo_ok:
        def run(x_pad):
            xg = torch.cat([x_pad.new_zeros(L), x_pad, x_pad.new_zeros(L)])
            return torch.cat([swell_ax(lay, xg[d * L: (d + 3) * L])
                              for d, lay in enumerate(layouts)])
    else:
        def run(x_pad):
            x_full = x_pad[:n]
            return torch.cat([swell_ax(lay, x_full) for lay in layouts])
    return run


def dist_swell_cg_solve(csr, b, mesh, tol: float = 1e-8, max_iters: int = 200):
    """Mesh-distributed CG with the swell kernel as each shard's product
    (square SPD A), called by every rank of the 1-D ``mesh``.

    ``b`` is the global (m,) right-hand side.  Returns ``(CGResult, dsp)``:
    the result's ``x`` is this rank's ``(rows_local,)`` block of the padded
    solution (``launch.gather_padded(res.x, mesh)[:m]`` for the global one).
    Dots are a local ``torch.dot`` and an ``all_reduce``, so every rank reads
    the same stop test and takes the same number of iterations.  Runs
    ``models.cg.dist_cg_blocks``: on the card captured blocks that hold the
    halo exchange or all-gather and the all-reduces."""
    from ..models.cg import dist_cg_blocks

    dsp = build_dist_swell(csr, mesh.size(), mesh=mesh)
    run = dist_swell_spmv_fn(dsp, mesh)
    d, L = mesh_rank(mesh), dsp.rows_local
    b_local = pad_global(dsp, b)[d * L: (d + 1) * L].to(mesh_device(mesh)).contiguous()

    def matvec(v):
        return run(v.to(dsp.dtype)).to(b_local.dtype)

    res = dist_cg_blocks(matvec, b_local, mesh).solve(b_local, torch.zeros_like(b_local), tol,
                                                      max_iters)
    return res, dsp
