"""Share (%) of the busy device time in the traced segment spent in F-3's
level-scheduled triangular solves (the device operations whose names start
with ``levels_``: ``tri_levels``' one-block and grid kernels, which carry
the V-cycle's SymGS sweeps), over the union of all device activity.

Only the trace's ten longest names are kept (``trace.summarize``), as
``comm_share.dist`` reads them.  None where no such kernel is among them."""


def read(readings):
    t = readings.get("trace")
    if not t or not t.get("busy_s"):
        return None
    tri = sum(s for name, s in t.get("device_ops", []) if name.startswith("levels_"))
    return 100.0 * tri / t["busy_s"] if tri > 0 else None
