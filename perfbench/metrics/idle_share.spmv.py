"""Share (%) of the traced power-iteration segment in which the device ran nothing."""

from perfbench import readers


def read(readings):
    return readers.idle_share(readings, "spmv_step")
