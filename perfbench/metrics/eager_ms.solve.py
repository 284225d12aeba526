"""Milliseconds a solve spent in CG's eager start (the span ``cg.eager``: the
plain iterations and the host read before each), per solve."""

from perfbench import spans


def read(readings):
    return spans.per_solve(readings, [("cg.eager", "seconds", 1)], 1e3)
