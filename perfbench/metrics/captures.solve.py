"""CUDA graphs captured per solve (the count of the span ``graphs.capture``)."""

from perfbench import spans


def read(readings):
    return spans.per_solve(readings, [("graphs.capture", "count", 1)])
