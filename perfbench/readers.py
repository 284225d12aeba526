"""What the per-layer metrics read, shared by the readers in ``metrics/``.

Each reader is ``read(readings) -> float | None``.  ``readings`` holds the
window's host-clock record (``window_s``, ``units``, ``requests``, every
request's seconds in ``latencies``), the kind's
``unit`` and ``unit_bytes``, the card's ``peak_gbs`` and the traced segment's
summary (``trace``: ``busy_s``, ``window_s``, ``kernels``, ``units``).  A
reader returns None where the run has nothing for it to read: another unit
of work, or no trace.
"""

from __future__ import annotations

import numpy as np


def _traced(readings: dict, unit: str):
    t = readings.get("trace")
    if readings.get("unit") != unit or not t or not t.get("kernels") or not t.get("units"):
        return None
    return t


def roofline(readings: dict, unit: str):
    """The unit's needed bytes over the union of device activity in the traced
    segment, as a share (%) of the card's peak bandwidth."""
    t = _traced(readings, unit)
    if t is None or not readings.get("peak_gbs") or t["busy_s"] <= 0:
        return None
    gbs = readings["unit_bytes"] * t["units"] / t["busy_s"] / 1e9
    return 100.0 * gbs / readings["peak_gbs"]


def idle_share(readings: dict, unit: str):
    """1 - device busy / traced window, in %."""
    t = _traced(readings, unit)
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernels_per_unit(readings: dict, unit: str):
    """Device kernels in the traced segment over its units of work."""
    t = _traced(readings, unit)
    return None if t is None else t["kernels"] / t["units"]


def units_per_request(readings: dict, unit: str):
    """Units of work a request took in the window, on average."""
    if readings.get("unit") != unit or not readings.get("requests"):
        return None
    return readings["units"] / readings["requests"]


def us_per_unit(readings: dict, unit: str):
    """The window's wall time over its units of work, in microseconds."""
    if readings.get("unit") != unit or not readings.get("units"):
        return None
    return readings["window_s"] * 1e6 / readings["units"]


def latency_quantile_ms(readings: dict, unit: str, q: float):
    """The ``q``-th percentile of the window's request times, in ms."""
    if readings.get("unit") != unit or not readings.get("latencies"):
        return None
    return float(np.percentile(np.asarray(readings["latencies"]) * 1e3, q))
