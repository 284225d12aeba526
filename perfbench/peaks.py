"""The card's peak memory bandwidth and the reference's byte model of one SpMV.

The peak is the arithmetic of the port's ``utils.stats.chip_peak_gbs``,
copied: two transfers a memory clock times the bus width, read from the card
(3352.32 GB/s on an NVIDIA H100 80GB HBM3, the data sheet's 3.35 TB/s).
"""

from __future__ import annotations

import torch


def peak_gbs(device) -> float:
    """Peak device-memory bandwidth of ``device`` in GB/s; raises where the
    card reports no memory clock or bus width."""
    props = torch.cuda.get_device_properties(device)
    clock_khz = getattr(props, "memory_clock_rate", 0)
    bus_bits = getattr(props, "memory_bus_width", 0)
    if not clock_khz or not bus_bits:
        raise RuntimeError(f"{props.name} reports no memory clock or bus width")
    return 2 * clock_khz * 1e3 * bus_bits / 8 / 1e9


def spmv_bytes(m: int, nnz: int, value_bytes: int = 8, index_bytes: int = 4) -> int:
    """The reference's model of y = alpha A x + beta y
    (benchmark/utils/statistics_logger.cpp:43): T (2 m + nnz) + I (m + 1 + nnz)."""
    return value_bytes * (2 * m + nnz) + index_bytes * (m + 1 + nnz)


def csr_bytes(m: int, nnz: int, value_bytes: int = 8, index_bytes: int = 4) -> int:
    """A CSR matrix read once: values, column indices and row pointers."""
    return value_bytes * nnz + index_bytes * (nnz + m + 1)
