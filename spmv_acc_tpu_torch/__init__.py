"""spmv_acc_tpu_torch — the PyTorch/CUDA port of spmv_acc_tpu.

The JAX package (``spmv_acc_tpu``) is the reference; this package keeps its
module paths and public names, and exports every name of the JAX package's
``__all__``.  Ported so far: the CSR, COO, BSR and ELL containers, matrix ingest
(csr/mtx/bin2) and generators, golden verification, the analyze pass, every
SpMV strategy of ``STRATEGIES`` behind ``spmv`` and the adaptive picker, the
plain-PyTorch ``spmm`` strategies and BSR products, ``spgemm`` (symbolic on the
host, numeric in plain PyTorch on the device), the ``spmv-cli``,
``spmv-benchmark``, ``csr-tool`` and ``suitesparse-dl`` entry points, and the
timing and profiling utilities (``utils.time_fn``, ``utils.profiling``).  The
swell layout is kept in a content-hashed disk plan cache
(``config.cache_dir("plans")``, for CUDA matrices), so a second process loads
it instead of rebuilding it.  Three strategies run
hand-written CUDA kernels on an NVIDIA Hopper card and their plain PyTorch
versions on the CPU: ``swell`` (float64 and float32, BSR r x r micro-blocks, k
right-hand sides; ``csrc/swell_spmv.cu``), ``adaptive_plus``
(``csrc/tile_spmv.cu``) and ``vector_row`` (``csrc/ell_rowsum.cu``).  The
solver path: ILU(0) and triangular solves (``ilu0``, ``trisolve``; new values
on one pattern through ``replace_values`` and ``ILU0.refactor``, the factor
redone on the card), HPCG's
multigrid preconditioner (``mg_preconditioner``: the symmetric Gauss-Seidel
V-cycle), CG (``models.cg_solve``) and ``spmv-solve``.  The JAX package's bf16 x planes
(``ops.swell.prep_x``, ``csrc/plane_split.cu``) and the swell kernel's plane
form are there too, off the default path.  The multi-device layer
(``parallel``: row partitions, the all-gather and 1-hop halo SpMV, the swell
kernel as each shard's product, ``models.cg.dist_cg_solve``, the hybrid mesh,
weak scaling; ``dryrun``) runs on ``torch.distributed`` with one process per
device: NCCL on the cards, gloo on the CPU.  The hot loops (the bench's
chains, ``utils.time_device_loop``, ``cg_solve``) run on a card as captured
CUDA graphs (``utils.graphs``), the chain's feedback in one kernel
(``csrc/feedback.cu``) and each CG iteration's vector work in three
(``csrc/cg_update.cu``), as the JAX package runs each as one device program.
The entry points are
``entry`` (the flagship swell step with example arguments) and
``dryrun_multichip``; ``python -m spmv_acc_tpu_torch.bench`` is the benchmark.

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
from .entry import entry
from .formats import (
    BSR,
    COO,
    CSR,
    ELL,
    banded_csr,
    coo_to_csr,
    csr_to_bsr,
    csr_to_ell,
    example_like,
    powerlaw_csr,
    random_csr,
    random_x_y,
    replace_values,
    sparse_operation,
)
from .io import load_csr, load_matrix, read_bin2, read_csr_text, read_mtx, write_bin2
from .models.mg import mg_preconditioner
from .ops.bsr import bsr_spmm, bsr_spmv
from .ops.golden import host_spmm, host_spmv
from .ops.spgemm import spgemm
from .ops.spmm import spmm
from .ops.trisolve import ilu0, trisolve
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
    "COO",
    "BSR",
    "ELL",
    "banded_csr",
    "coo_to_csr",
    "csr_to_bsr",
    "csr_to_ell",
    "example_like",
    "powerlaw_csr",
    "random_csr",
    "random_x_y",
    "replace_values",
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
    "spgemm",
    "spmm",
    "ilu0",
    "trisolve",
    "mg_preconditioner",
    "Plan",
    "analyze",
    "get_plan",
    "verify",
    "verify_y",
    "entry",
    "dryrun_multichip",
    "__version__",
]


def __getattr__(name):
    # loaded on first use: importing the dry run with the package would load
    # torch.distributed for every caller, and `python -m spmv_acc_tpu_torch.dryrun`
    # would warn that its module was imported before it ran
    if name == "dryrun_multichip":
        from .dryrun import dryrun_multichip

        return dryrun_multichip
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
