"""MB this rank (rank 0) received from its neighbours in the halo exchange,
per solve (the counter ``dist.halo_bytes``: matvecs run times one exchange's
bytes, masked iterations included)."""

from perfbench import spans


def read(readings):
    if spans.whole(readings, "dist.halo_bytes", "total") is None:
        return None
    return spans.per_solve(readings, [("dist.halo_bytes", "total", 1)], 1e-6)
