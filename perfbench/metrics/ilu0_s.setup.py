"""Seconds of the ILU(0) factor's own work in set-up (the self seconds of the
span ``ilu0``: the host factor, the two level analyses and the handle, less
the factors' swell plans)."""

from perfbench import spans


def read(readings):
    return spans.whole(readings, "ilu0", "self_seconds")
