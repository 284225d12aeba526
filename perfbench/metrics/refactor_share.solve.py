"""Share (%) of the busy device time in the traced segment spent in F-4,
the ILU(0) factor on the card (the device operations whose names start with
``ilu0_factor``: ``ilu0_factor_kernel``), over the union of all device
activity.

Only the trace's ten longest names are kept (``trace.summarize``), as
``symgs_share.solve`` reads them.  None where no such kernel is among them."""


def read(readings):
    t = readings.get("trace")
    if not t or not t.get("busy_s"):
        return None
    f4 = sum(s for name, s in t.get("device_ops", []) if name.startswith("ilu0_factor"))
    return 100.0 * f4 / t["busy_s"] if f4 > 0 else None
