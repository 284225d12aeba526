"""MB the caching allocator reserved across graph captures, per solve (the
counter ``graphs.pool_bytes``: the graph pools' growth)."""

from perfbench import spans


def read(readings):
    return spans.per_solve(readings, [("graphs.pool_bytes", "total", 1)], 1e-6)
