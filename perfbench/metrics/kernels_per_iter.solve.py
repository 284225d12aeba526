"""Device kernels per CG iteration in the traced segment, start-up and capture included."""

from perfbench import readers


def read(readings):
    return readers.kernels_per_unit(readings, "cg_iter")
