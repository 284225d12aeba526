"""CG iterations a solve took in the window, on average (the program's count)."""

from perfbench import readers


def read(readings):
    return readers.units_per_request(readings, "cg_iter")
