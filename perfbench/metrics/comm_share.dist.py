"""Share (%) of rank 0's busy device time in the traced segment spent in
NCCL's kernels: the device operations whose names start with ``nccl``, among
the ten longest the trace keeps, over the union of all device activity.
NCCL's kernels spin while they wait, so the share holds the wait for slower
ranks as well as the all-reduces and the halo exchange themselves.

Only the ten longest names are kept (``trace.summarize``): an NCCL kernel
shorter than the tenth is left out, and a change that splits or shrinks the
exchange can move the share without moving the time in NCCL.  None where no
NCCL kernel is among the ten."""


def read(readings):
    t = readings.get("trace")
    if not t or not t.get("busy_s"):
        return None
    nccl = sum(s for name, s in t.get("device_ops", []) if name.startswith("nccl"))
    return 100.0 * nccl / t["busy_s"] if nccl > 0 else None
