"""spmv_acc_tpu_torch — the PyTorch/CUDA port of spmv_acc_tpu.

The JAX package (``spmv_acc_tpu``) is the reference; this package keeps its
module paths and public names.  Ported so far: the CSR, BSR and ELL containers,
matrix ingest (csr/mtx/bin2) and generators, golden verification, the analyze
pass, every SpMV strategy of ``STRATEGIES`` behind ``spmv`` and the adaptive
picker, the plain-PyTorch ``spmm`` strategies and BSR products, and the
``spmv-cli`` and ``spmv-benchmark`` entry points.  Three strategies run
hand-written CUDA kernels on an NVIDIA Hopper card and their plain PyTorch
versions on the CPU: ``swell`` (float64 and float32, BSR r x r micro-blocks, k
right-hand sides; ``csrc/swell_spmv.cu``), ``adaptive_plus``
(``csrc/tile_spmv.cu``) and ``vector_row`` (``csrc/ell_rowsum.cu``).

Public API::

    from spmv_acc_tpu_torch import CSR, spmv, spmm, example_like
    csr = example_like("af23560").to("cuda")
    y = spmv(csr, x, y, alpha=1.0, beta=1.0, strategy="adaptive")
    Y = spmm(csr, X)            # X of shape (n, k)
"""

from .config import DEFAULT_TUNE, TuneConfig
from .dispatch import (
    STRATEGIES,
    Handle,
    make_spmv_fn,
    pick_strategy,
    sparse_csr_spmv,
    spmv,
)
from .formats import (
    BSR,
    CSR,
    ELL,
    banded_csr,
    csr_to_bsr,
    csr_to_ell,
    example_like,
    powerlaw_csr,
    random_csr,
    random_x_y,
    sparse_operation,
)
from .io import load_csr, load_matrix, read_bin2, read_csr_text, read_mtx, write_bin2
from .ops.bsr import bsr_spmm, bsr_spmv
from .ops.golden import host_spmm, host_spmv
from .ops.spmm import spmm
from .plan import Plan, analyze, get_plan
from .utils import verify, verify_y

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_TUNE",
    "TuneConfig",
    "Handle",
    "STRATEGIES",
    "make_spmv_fn",
    "pick_strategy",
    "sparse_csr_spmv",
    "spmv",
    "CSR",
    "BSR",
    "ELL",
    "banded_csr",
    "csr_to_bsr",
    "csr_to_ell",
    "example_like",
    "powerlaw_csr",
    "random_csr",
    "random_x_y",
    "sparse_operation",
    "load_csr",
    "load_matrix",
    "read_bin2",
    "read_csr_text",
    "read_mtx",
    "write_bin2",
    "host_spmv",
    "host_spmm",
    "bsr_spmv",
    "bsr_spmm",
    "spmm",
    "Plan",
    "analyze",
    "get_plan",
    "verify",
    "verify_y",
    "__version__",
]
