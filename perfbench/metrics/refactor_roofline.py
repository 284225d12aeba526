"""Share (%) of peak bandwidth of one ILU(0) refactor on the card: its
needed bytes (``refactor_bytes``) over F-4's traced time a refactor.

F-4's time is that of the device operations whose names start with
``ilu0_factor`` among the trace's ten longest (``trace.summarize``).  The
refactors in the traced segment are its CG iterations over the window's
iterations a request, times the process's refactors a solve (the counter
``ilu.refactors`` over the span ``cg.solve``): the traced requests'
iteration counts may differ from the window's mean by a few per cent, and
the reading with them.  The pattern's rows and nnz a refactor are the
program's counters ``ilu.refactor.rows`` and ``ilu.refactor.nnz`` over
``ilu.refactors``.  None where no such kernel is among the ten, or the
program keeps no such counters."""

from perfbench import spans


def refactor_bytes(rows: float, nnz: float) -> float:
    """What one numeric ILU(0) factor must move: A's values read and the
    factor written (8 B each an entry), and the pattern's column indices and
    row pointers read once (4 B each)."""
    return 8 * nnz + 8 * nnz + 4 * (nnz + rows + 1)


def read(readings):
    t = readings.get("trace")
    if (not t or not t.get("units") or not readings.get("units") or not readings.get("requests")
            or not readings.get("peak_gbs")):
        return None
    secs = sum(s for name, s in t.get("device_ops", []) if name.startswith("ilu0_factor"))
    n = spans.whole(readings, "ilu.refactors", "count")
    solves = spans.whole(readings, "cg.solve", "count")
    rows = spans.whole(readings, "ilu.refactor.rows", "total")
    nnz = spans.whole(readings, "ilu.refactor.nnz", "total")
    if not secs or not n or not solves or rows is None or nnz is None:
        return None
    refactors = t["units"] * readings["requests"] / readings["units"] * n / solves
    gbs = refactor_bytes(rows / n, nnz / n) * refactors / secs / 1e9
    return 100.0 * gbs / readings["peak_gbs"]
