"""Share (%) of peak bandwidth of one power step's SpMV bytes over its device time (all kernels)."""

from perfbench import readers


def read(readings):
    return readers.roofline(readings, "spmv_step")
