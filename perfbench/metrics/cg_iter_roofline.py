"""Share (%) of peak bandwidth: a CG iteration's needed bytes over its device time
(all kernels)."""

from perfbench import readers


def read(readings):
    return readers.roofline(readings, "cg_iter")
