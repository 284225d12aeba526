"""Milliseconds a solve spent in ``ILU0.refactor`` on the host (the self
seconds of the span ``ilu0.refactor``: F-4's launch and the value rewrites'
launches, or without the card the host factor; its first call's set-up,
the span ``ilu0.refactor.setup`` inside it, is left out), per solve.  A
refactor that fell back to the host factor shows here as seconds."""

from perfbench import spans


def read(readings):
    if spans.whole(readings, "ilu0.refactor", "count") is None:
        return None
    return spans.per_solve(readings, [("ilu0.refactor", "self_seconds", 1)], 1e3)
