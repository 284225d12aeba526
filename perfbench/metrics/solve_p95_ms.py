"""The 95th percentile of every solve's wall time in the window, call to return (ms)."""

from perfbench import readers


def read(readings):
    return readers.latency_quantile_ms(readings, "cg_iter", 95)
