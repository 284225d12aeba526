"""Seconds of the multigrid preconditioner's own set-up (the self seconds of
the span ``mg.setup``: every level's host copy, two level analyses of
D + L and D + U, strict parts and injection map, less the swell plans
inside it)."""

from perfbench import spans


def read(readings):
    return spans.whole(readings, "mg.setup", "self_seconds")
