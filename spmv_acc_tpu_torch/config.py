"""Global configuration constants for spmv_acc_tpu_torch.

The same numbers as the JAX package's ``spmv_acc_tpu/config.py``: the reference's
verification contract, its benchmark protocol, the bin2 format and the picker
thresholds.  ``cache_dir`` resolves to the same repo-local ``.cache/`` so both
packages share the generated corpus; their plan caches share the directory
but never an entry.
"""

from __future__ import annotations

import dataclasses
import os

# --- Numeric verification contract (reference cli/verification.cpp:15-54) ---
# A result element fails when relative error >= REL_TOL, except near zero
# (|golden| <= NEAR_ZERO) where the gate is absolute error >= ABS_TOL.
REL_TOL = 1e-7
ABS_TOL = 1e-14
NEAR_ZERO = 1e-12

# Looser gates for a float32 compute dtype.
REL_TOL_F32 = 1e-3
ABS_TOL_F32 = 1e-5
NEAR_ZERO_F32 = 1e-4

# Rows per swell row-block: one CUDA thread block of 128 threads, one row each.
LANES = 128

# --- Benchmark protocol (reference benchmark/csr_spmv.hpp:48-74, benchmark_time.h:10) ---
WARMUP_ITERS = 10
BENCHMARK_ARRAY_SIZE = 3  # median-of-3 timed repetitions

# --- bin2 on-disk format (reference cli/csr_binary_reader.hpp:37-56) ---
BIN2_MAGIC = 0x20211015
BIN2_VERSION = 2

# --- Strategy-picker thresholds (reference hip-adaptive/adaptive.cpp:16-67) ---
IMBALANCE_RATIO = 4.0          # half-matrix nnz imbalance that triggers weighted split
SHORT_ROW_AVG_NNZ = 4.0        # avg nnz/row at or below which rows are "short"
SMALL_NNZ = 0x0C00000          # adaptive.cpp:52 boundary (12.58M)
FLAT_NNZ = 1 << 23             # adaptive.cpp:60 boundary (8.39M)


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """Tunable knobs of the strategy zoo (analog of the per-strategy *_config.h).

    Only ``flat_chunk_nnz`` is read by the port so far (``plan.analyze``); the
    others keep the JAX package's values for the strategies still to port."""

    flat_chunk_nnz: int = 8 * 1024
    line_rows_per_block: int = 256
    ell_width_multiple: int = 8
    rows_per_tile: int = 8
    spmm_tile_n: int = 128


DEFAULT_TUNE = TuneConfig()


def cache_dir(kind: str) -> str:
    """Disk-cache directory for ``kind``: ``corpus`` (generated matrices) or
    ``plans`` (the swell layouts of ``ops.swell``'s disk plan cache).

    Env override first (``SPMV_TPU_CORPUS_CACHE`` / ``SPMV_TPU_PLAN_CACHE_DIR``);
    otherwise the gitignored ``.cache/<kind>`` at the repo root, the directory
    the JAX package uses too (plan entries carry a prefix of their own, so
    neither package reads the other's)."""
    env = {"corpus": "SPMV_TPU_CORPUS_CACHE", "plans": "SPMV_TPU_PLAN_CACHE_DIR"}[kind]
    v = os.environ.get(env)
    if v:
        return v
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = os.path.join(root, ".cache", kind)
    try:
        os.makedirs(d, exist_ok=True)
        return d
    except OSError:  # read-only installs fall back to /tmp
        return {"corpus": "/tmp/spmv_corpus", "plans": "/tmp/spmv_plans"}[kind]
