"""The program's own span table, as the readers in ``metrics/`` read it.

The port keeps in ``spmv_acc_tpu_torch.utils.profiling`` a table of its
spans and counters: each span's exits (``count``), ``seconds`` and
``self_seconds`` (less the spans nested in it), each counter's sum
(``total``), since the process started.  A traced run's readers read it in
the run's process once the run has ended, finding the module in
``sys.modules``: this file imports nothing of the program.  A reader returns
None where the program keeps no such table (a version older than it), where
the run made no request, or where the table lacks the span the metric is
taken over.

"Per solve" is over the count of ``cg.solve`` in the process: the warm-up,
window and traced solves (the check's re-solves run the reference).
"""

from __future__ import annotations

import sys

MODULE = "spmv_acc_tpu_torch.utils.profiling"


def table(readings: dict):
    """name -> entry, or None where the run made no request or the program
    keeps no table."""
    read = getattr(sys.modules.get(MODULE), "spans", None)
    if read is None or not readings.get("requests"):
        return None
    return read()


def _get(t: dict, name: str, field: str) -> float:
    e = t.get(name)
    return 0 if e is None else getattr(e, field)


def per_solve(readings: dict, terms, scale: float = 1.0):
    """The sum of ``sign * entry.field`` over ``terms`` ((name, field, sign)
    each), over the process's ``cg.solve`` count, times ``scale``; a name the
    table lacks adds 0.  None where there is no table or no ``cg.solve``."""
    t = table(readings)
    solves = 0 if t is None else _get(t, "cg.solve", "count")
    if not solves:
        return None
    return scale * sum(sign * _get(t, name, field) for name, field, sign in terms) / solves


def whole(readings: dict, name: str, field: str):
    """``name``'s ``field`` over the whole process; None where there is no
    table or it holds no ``name``."""
    t = table(readings)
    if t is None or name not in t:
        return None
    return getattr(t[name], field)
