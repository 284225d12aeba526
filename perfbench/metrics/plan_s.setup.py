"""Seconds the process spent building or loading swell plans (the span
``swell.plan``, every plan, cache hits excluded)."""

from perfbench import spans


def read(readings):
    return spans.whole(readings, "swell.plan", "seconds")
