"""Host read-back shared by the golden model and the verification gates."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["host_array"]


def host_array(a) -> np.ndarray:
    """A numpy view of ``a``: tensors are detached and copied to the host (a
    CUDA tensor synchronises its stream here), everything else goes through
    ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
