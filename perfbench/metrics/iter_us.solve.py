"""The window's wall time over all CG iterations of all its solves, in microseconds."""

from perfbench import readers


def read(readings):
    return readers.us_per_unit(readings, "cg_iter")
