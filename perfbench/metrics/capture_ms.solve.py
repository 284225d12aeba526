"""Milliseconds a solve spent recording CUDA graphs (the span
``graphs.capture``, ``capture_begin`` to ``capture_end``), per solve."""

from perfbench import spans


def read(readings):
    return spans.per_solve(readings, [("graphs.capture", "seconds", 1)], 1e3)
