"""Share (%) of the traced CG segment in which the device ran nothing."""

from perfbench import readers


def read(readings):
    return readers.idle_share(readings, "cg_iter")
