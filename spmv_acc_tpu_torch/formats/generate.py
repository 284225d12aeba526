"""Deterministic synthetic matrix generators, the same as the JAX package's
``spmv_acc_tpu/formats/generate.py``: identical numpy code on identical seeds,
so every matrix (and the shared ``<name>_s<seed>.bin2`` corpus cache) matches
the reference's bit for bit.  Results are CPU :class:`CSR`; move them with
``csr.to(device)``.

The reference ships 10 SuiteSparse example matrices as git-lfs stubs (``examples/data/``,
``.gitattributes:1-10``) — the actual data is absent, so we regenerate matrices matching
each example's published shape/nnz (``examples/batch.sh:24-50``) plus distribution-shaped
generators for property tests (banded, uniform-random, power-law row lengths, dense-row
outliers — the shapes the adaptive picker discriminates, hip-adaptive/adaptive.cpp:16-67).
"""

from __future__ import annotations

import numpy as np

from .containers import CSR
from .convert import coo_to_csr_arrays

__all__ = [
    "random_csr",
    "banded_csr",
    "powerlaw_csr",
    "dense_row_outlier_csr",
    "fem_like_csr",
    "example_like",
    "EXAMPLE_SHAPES",
    "random_x_y",
]

# Shapes of the reference's example corpus (rows, cols, nnz): small set from
# examples/batch.sh:24-50, large set from examples/large-data-set-batch.sh:24-51.
EXAMPLE_SHAPES = {
    "af23560": (23560, 23560, 484256),
    "bayer10": (13436, 13436, 94926),
    "bcsstk18": (11948, 11948, 149090),
    "coater2": (9540, 9540, 207308),
    "dw4096": (8192, 8192, 41746),
    "epb1": (14734, 14734, 95053),
    "exdata_1": (6001, 6001, 2269500),
    "nemeth03": (9506, 9506, 202157),
    "poli_large": (15575, 15575, 33074),
    "rajat03": (7602, 7602, 32653),
    # large set (examples/large-data-set-batch.sh)
    "boneS10": (914898, 914898, 28191660),
    "Bump_2911": (2911419, 2911419, 65320659),
    "Cube_Coup_dt6": (2164760, 2164760, 64685452),
    "dielFilterV3real": (1102824, 1102824, 45204422),
    "Ga41As41H72": (268096, 268096, 9378286),
    "Hardesty3": (8217820, 7591564, 40451632),
    "largebasis": (440020, 440020, 5560100),
    "RM07R": (381689, 381689, 37464962),
    "TSOPF_RS_b2383": (38120, 38120, 16171169),
    "vas_stokes_2M": (2146677, 2146677, 65129037),
}

# Structure class per example matrix.  The real SuiteSparse files are git-lfs stubs
# in the reference, so stand-ins are generated; each mimics its matrix's published
# structure class (FEM/structural = dense node blocks with diagonal locality,
# circuit = diagonal + scatter, stencil = narrow band).  Parameters: see
# _example_recipe below.
_STRUCTURE = {
    "af23560": "fem",          # CFD (transonic airfoil), 20.6/row
    "bayer10": "circuit",
    "bcsstk18": "fem",         # structural
    "coater2": "fem",
    "dw4096": "fem",           # electromagnetics
    "epb1": "fem",             # heat exchanger
    "exdata_1": "densefem",    # 378/row
    "nemeth03": "fem",         # quantum chemistry, banded
    "poli_large": "circuit",
    "rajat03": "circuit",
    "boneS10": "fem",          # model reduction, 3D trabecular bone, 30.8/row
    "Bump_2911": "fem",        # reservoir simulation
    "Cube_Coup_dt6": "fem",    # coupled structural
    "dielFilterV3real": "fem", # electromagnetics, 41/row
    "Ga41As41H72": "chem",     # DFT, clustered + scattered
    "Hardesty3": "stencil",    # graphics mesh, 4.92/row, rectangular
    "largebasis": "fem",       # optimization basis
    "RM07R": "fem",            # CFD turbulence, 98/row
    "TSOPF_RS_b2383": "densefem",  # power flow, 424/row dense blocks
    "vas_stokes_2M": "fem",    # Stokes flow
}


def fem_like_csr(m: int, n: int, nnz: int, block: int = 3, spread_frac: float = 0.02,
                 seed: int = 0, dtype=np.float64) -> CSR:
    """FEM/structural-style stand-in: rows grouped in `block`-row node blocks, nodes
    coupled via a 3D-grid stencil (clusters of consecutive nodes at the x/y/z grid
    strides), every coupling a dense block×block sub-block — i.e. rows are a few
    contiguous column runs near the diagonal, the dominant pattern of SuiteSparse
    FEM/structural matrices (mesh locality).  Exact target nnz via top-up/trim."""
    rng = np.random.default_rng(seed)
    nodes_m = max(1, m // block)
    nodes_n = max(1, n // block)
    per_row = max(1, int(round(nnz / max(m, 1))))
    # oversize by one neighbor cluster so the base pattern exceeds the target and
    # exact nnz is reached by TRIMMING (a scattered top-up would wreck locality)
    K = max(1, -(-per_row // block) + 1)
    # 3D grid stencil in node space: neighbor clusters of consecutive nodes at
    # offsets {0, ±nx, ±nx*ny}; cluster half-width grows until K offsets exist.
    nx = max(2, int(round(nodes_n ** (1.0 / 3.0))))
    nxny = nx * nx
    centers = [0, -nx, nx, -nxny, nxny, -2 * nx, 2 * nx, -2 * nxny, 2 * nxny]
    offsets = []
    w = 0
    while len(offsets) < K:
        for c in centers:
            if len(offsets) >= K:
                break
            for d in ([0] if w == 0 else [-w, w]):
                o = c + d
                if o not in offsets:
                    offsets.append(o)
                    if len(offsets) >= K:
                        break
        w += 1
    offs = np.array(offsets[:K], dtype=np.int64)[None, :]
    nbr = np.clip(np.arange(nodes_m, dtype=np.int64)[:, None] * nodes_n // nodes_m + offs, 0, nodes_n - 1)
    scale = max(2.0, spread_frac * nodes_n)  # for the exact-nnz top-up scatter only
    # expand: node pair -> block x block dense sub-block
    rn = np.repeat(np.arange(nodes_m, dtype=np.int64), K)
    cn = nbr.reshape(-1)
    # dedup node pairs
    pair = rn * nodes_n + cn
    pair = np.unique(pair)
    rn = pair // nodes_n
    cn = pair % nodes_n
    bi = np.arange(block, dtype=np.int64)
    shape3 = (len(rn), block, block)
    rows = np.broadcast_to(rn[:, None, None] * block + bi[None, :, None], shape3).reshape(-1)
    cols = np.broadcast_to(cn[:, None, None] * block + bi[None, None, :], shape3).reshape(-1)
    keep = (rows < m) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    # exact nnz: trim (base pattern is oversized); top up only in the rare edge
    # case, LOCALLY (±2 blocks of the diagonal) so locality is preserved
    if len(rows) > nnz:
        sel = rng.choice(len(rows), nnz, replace=False)
        rows, cols = rows[sel], cols[sel]
    halo = 2 * block
    while len(rows) < nnz:
        need = nnz - len(rows)
        rr = rng.integers(0, m, 2 * need + 64)
        cc = np.clip(rr * n // max(m, 1) + rng.integers(-halo, halo + 1, 2 * need + 64), 0, n - 1)
        rows = np.concatenate([rows, rr])
        cols = np.concatenate([cols, cc])
        key = rows * n + cols
        _, idx = np.unique(key, return_index=True)
        idx = np.sort(idx)[:nnz]
        rows, cols = rows[idx], cols[idx]
        halo *= 2  # widen if the local band saturates
    vals = (rng.random(len(rows)) * 2.0 - 1.0).astype(dtype)
    return _finish(rows, cols, vals, (m, n))


def _finish(rows, cols, vals, shape) -> CSR:
    rp, ci, v = coo_to_csr_arrays(rows, cols, vals, shape)
    return CSR.from_numpy(rp, ci, v, shape)


def random_x_y(n: int, m: int, seed: int = 42, dtype=np.float64):
    """Uniform(-1, 1) vectors, mirroring cli/utils.hpp:46-56 rand_double."""
    rng = np.random.default_rng(seed)
    x = (rng.random(n) * 2.0 - 1.0).astype(dtype)
    y = (rng.random(m) * 2.0 - 1.0).astype(dtype)
    return x, y


def random_csr(m: int, n: int, nnz: int, seed: int = 0, dtype=np.float64) -> CSR:
    """Uniformly random positions (deduplicated), values in (-1, 1)."""
    rng = np.random.default_rng(seed)
    # oversample to survive dedup
    k = int(nnz * 1.3) + 16
    rows = rng.integers(0, m, k)
    cols = rng.integers(0, n, k)
    key = rows.astype(np.int64) * n + cols
    _, idx = np.unique(key, return_index=True)
    idx = np.sort(idx)[:nnz]
    rows, cols = rows[idx], cols[idx]
    vals = (rng.random(len(rows)) * 2.0 - 1.0).astype(dtype)
    return _finish(rows, cols, vals, (m, n))


def banded_csr(m: int, bandwidth: int = 5, seed: int = 0, dtype=np.float64) -> CSR:
    """Regular banded matrix — the 'nice' case (short uniform rows)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in range(-(bandwidth // 2), bandwidth // 2 + 1):
        r = np.arange(max(0, -off), min(m, m - off))
        rows.append(r)
        cols.append(r + off)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = (rng.random(len(rows)) * 2.0 - 1.0).astype(dtype)
    return _finish(rows, cols, vals, (m, m))


def powerlaw_csr(m: int, n: int, avg_nnz: int = 8, alpha: float = 1.8, seed: int = 0, dtype=np.float64) -> CSR:
    """Power-law row lengths — the irregular case the flat/adaptive strategies target."""
    rng = np.random.default_rng(seed)
    lens = np.minimum((rng.pareto(alpha, m) + 1.0) * avg_nnz * (alpha - 1) / alpha, n).astype(np.int64)
    lens = np.maximum(lens, 0)
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, n, len(rows))
    # dedup within rows
    key = rows * n + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[np.sort(idx)], cols[np.sort(idx)]
    vals = (rng.random(len(rows)) * 2.0 - 1.0).astype(dtype)
    return _finish(rows, cols, vals, (m, n))


def dense_row_outlier_csr(m: int, n: int, avg_nnz: int = 4, n_dense: int = 2, seed: int = 0, dtype=np.float64) -> CSR:
    """Mostly-short rows plus a few near-dense rows — the long-row splitting stress case
    (csr_adaptive_plus_analyze.cpp:41-63)."""
    base = random_csr(m, n, m * avg_nnz, seed=seed, dtype=dtype)
    rp, ci, v, shape = base.to_numpy()
    rng = np.random.default_rng(seed + 1)
    rows = np.repeat(np.arange(m), np.diff(rp)).astype(np.int64)
    cols = ci.astype(np.int64)
    vals = v
    for r in rng.choice(m, size=n_dense, replace=False):
        c = np.arange(0, n, 2, dtype=np.int64)
        rows = np.concatenate([rows, np.full(len(c), r, dtype=np.int64)])
        cols = np.concatenate([cols, c])
        vals = np.concatenate([vals, (rng.random(len(c)) * 2 - 1).astype(dtype)])
    return _finish(rows, cols, vals, shape)


def _stencil_csr(m, n, nnz, seed, dtype):
    """Narrow-band stencil (Hardesty3-style graphics mesh): ~nnz/m points per row,
    contiguous around the scaled diagonal."""
    rng = np.random.default_rng(seed)
    k = max(1, int(round(nnz / m)))
    center = (np.arange(m, dtype=np.int64) * n) // max(m, 1)
    offs = np.arange(k, dtype=np.int64) - k // 2
    rows = np.repeat(np.arange(m, dtype=np.int64), k)
    cols = np.clip((center[:, None] + offs[None, :]).reshape(-1), 0, n - 1)
    key = rows * n + cols
    _, idx = np.unique(key, return_index=True)
    idx = np.sort(idx)
    rows, cols = rows[idx], cols[idx]
    while len(rows) < nnz:
        need = nnz - len(rows)
        rr = rng.integers(0, m, need + 64)
        cc = np.clip(rr * n // max(m, 1) + rng.integers(-2 * k - 2, 2 * k + 2, need + 64), 0, n - 1)
        rows = np.concatenate([rows, rr]); cols = np.concatenate([cols, cc])
        key = rows * n + cols
        _, idx = np.unique(key, return_index=True)
        idx = np.sort(idx)[:nnz]
        rows, cols = rows[idx], cols[idx]
    sel = slice(0, nnz)
    vals = (rng.random(len(rows[sel])) * 2.0 - 1.0).astype(dtype)
    return _finish(rows[sel], cols[sel], vals, (m, n))


def example_like(name: str, seed: int = 7, dtype=np.float64, cache: bool = True) -> CSR:
    """A deterministic stand-in with the same (rows, cols, nnz) as a reference
    example and the same *structure class* (see _STRUCTURE).

    The reference ships its example matrices as git-lfs stubs (data absent), so we
    regenerate by published dimensions (examples/batch.sh:24-50,
    examples/large-data-set-batch.sh:24-51) with class-appropriate sparsity
    patterns: FEM/structural matrices are dense node-block couplings with diagonal
    locality (contiguous column runs), circuit matrices are diagonal + heavy-tailed
    scatter, stencil meshes are narrow bands.

    Generation at 40-80M nnz costs tens of seconds of repeated dedup sorts, so
    results are cached on disk in the byte-compatible bin2 format (f64 values —
    exact roundtrip; an f32 read casts identically to generating at f32).  Cache
    dir: $SPMV_TPU_CORPUS_CACHE (default ``.cache/corpus`` at the repo root); ``cache=False`` or
    SPMV_TPU_NO_CORPUS_CACHE=1 regenerates.
    """
    import os

    cache = cache and not os.environ.get("SPMV_TPU_NO_CORPUS_CACHE")
    path = None
    if cache:
        from ..config import cache_dir

        cdir = cache_dir("corpus")
        path = os.path.join(cdir, f"{name}_s{seed}.bin2")
        if os.path.exists(path):
            try:
                from ..io.binary import read_bin2

                rp, ci, v, shape = read_bin2(path, dtype=dtype)
                exp = EXAMPLE_SHAPES[name]
                if shape == (exp[0], exp[1]) and len(ci) == exp[2]:
                    return CSR.from_numpy(rp, ci, v, shape)
            except Exception:
                pass  # corrupt/stale cache entry: fall through and regenerate
    csr = _example_like_gen(name, seed, dtype)
    # only an f64 generation may populate the cache: values are stored f8, and
    # an f32-rounded stream would silently degrade later f64 reads
    if path is not None and np.dtype(dtype) == np.float64:
        try:
            from ..io.binary import write_bin2

            os.makedirs(os.path.dirname(path), exist_ok=True)
            rp, ci, v, shape = csr.to_numpy()
            tmp = f"{path}.tmp{os.getpid()}"
            write_bin2(tmp, rp, ci, np.asarray(v, dtype=np.float64), shape)
            os.replace(tmp, path)  # atomic: concurrent generators never mix
        except Exception:
            pass  # cache is best-effort; the generated matrix is still returned
    return csr


def _example_like_gen(name: str, seed: int, dtype) -> CSR:
    m, n, nnz = EXAMPLE_SHAPES[name]
    kind = _STRUCTURE.get(name, "circuit")
    per_row = nnz / max(m, 1)
    if kind == "fem":
        block = 6 if per_row >= 36 else 3
        return fem_like_csr(m, n, nnz, block=block, spread_frac=0.02, seed=seed, dtype=dtype)
    if kind == "densefem":
        return fem_like_csr(m, n, nnz, block=16, spread_frac=0.01, seed=seed, dtype=dtype)
    if kind == "chem":
        return fem_like_csr(m, n, nnz, block=2, spread_frac=0.08, seed=seed, dtype=dtype)
    if kind == "stencil":
        return _stencil_csr(m, n, nnz, seed, dtype)
    rng = np.random.default_rng(seed)
    # diagonal band guarantees a full diagonal neighborhood
    band_nnz = min(nnz, 3 * m)
    rows_b = np.repeat(np.arange(m), 3)[:band_nnz]
    offs = np.tile(np.array([-1, 0, 1]), m)[:band_nnz]
    cols_b = np.clip(rows_b + offs, 0, n - 1)
    rest = nnz - band_nnz
    k = int(rest * 2.5) + 64
    rows_r = rng.integers(0, m, k)
    # ~95% near-diagonal (Laplace, scale 1% of n), 5% global scatter
    scale = max(n // 100, 4)
    lap = rng.laplace(0.0, scale, k).astype(np.int64)
    cols_near = np.clip(rows_r * n // max(m, 1) + lap, 0, n - 1)
    cols_far = rng.integers(0, n, k)
    far = rng.random(k) < 0.05
    cols_r = np.where(far, cols_far, cols_near)
    rows = np.concatenate([rows_b, rows_r]).astype(np.int64)
    cols = np.concatenate([cols_b, cols_r]).astype(np.int64)
    key = rows * n + cols
    _, idx = np.unique(key, return_index=True)
    idx = np.sort(idx)
    while len(idx) < nnz:  # clustering raises collision rate; top up uniformly
        extra_r = rng.integers(0, m, nnz)
        extra_c = rng.integers(0, n, nnz)
        rows = np.concatenate([rows[idx], extra_r])
        cols = np.concatenate([cols[idx], extra_c])
        key = rows * n + cols
        _, idx = np.unique(key, return_index=True)
        idx = np.sort(idx)
    idx = idx[:nnz]
    rows, cols = rows[idx], cols[idx]
    vals = (rng.random(len(rows)) * 2.0 - 1.0).astype(dtype)
    return _finish(rows, cols, vals, (m, n))
