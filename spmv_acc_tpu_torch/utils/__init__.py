"""Verification gates, host read-back and timers."""

from .host import host_array
from .timer import WallTimer, cuda_time_us, sync
from .verify import VerifyReport, tolerances_for, verify, verify_y

__all__ = [
    "host_array",
    "WallTimer",
    "cuda_time_us",
    "sync",
    "VerifyReport",
    "tolerances_for",
    "verify",
    "verify_y",
]
