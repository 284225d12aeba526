"""Milliseconds a solve spent in its masked blocks less their captures (the
span ``cg.blocks`` less ``graphs.capture``: the replays, each block's flag read
and the captures' warm-ups), per solve."""

from perfbench import spans


def read(readings):
    return spans.per_solve(readings, [("cg.blocks", "seconds", 1),
                                      ("graphs.capture", "seconds", -1)], 1e3)
