"""Seconds the process spent cutting the distributed plan's shards, their
schedules and this rank's device copy (the self seconds of the span
``dist.shard``; the global layout is ``swell.plan``'s)."""

from perfbench import spans


def read(readings):
    return spans.whole(readings, "dist.shard", "self_seconds")
