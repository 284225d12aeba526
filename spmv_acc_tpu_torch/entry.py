"""Single-device entry point of the port: the counterpart of the JAX
package's ``__graft_entry__.entry()``.

``entry()`` returns the flagship SpMV step, ``y = 1.0 * A @ x + 1.0 * y`` on the
swell layout, with example arguments: a 512 x 512 float32 matrix of 4096
nonzeros (``random_csr(512, 512, 4096, seed=7)``) and x, y from
``random_x_y(512, 512, seed=8)``.  PyTorch runs eagerly, so there is nothing to
jit: ``fn(*example_args)`` launches the swell kernel (float32, r = 1, k = 1)
on the card, or runs its plain version on the CPU.  The multi-device dry run
is ``dryrun.dryrun_multichip``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["entry"]


def entry(device=None):
    """(fn, example_args): ``fn(layout, x, y)`` computes ``1.0 * swell_ax(layout,
    x) + 1.0 * y``, and ``example_args`` are the swell layout of the example
    matrix and its x and y, all on ``device`` (default ``"cuda"``; the CPU only
    when asked for).  Raises RuntimeError for ``"cuda"`` without a card."""
    from .formats.generate import random_csr, random_x_y
    from .ops.swell import get_swell_plan, swell_ax

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry() runs on the card and there is none; "
                           "pass device='cpu' for the plain version")
    csr = random_csr(512, 512, 4096, seed=7, dtype=np.float32).to(dev)
    m, n = csr.shape
    x, y = random_x_y(n, m, seed=8, dtype=np.float32)
    layout = get_swell_plan(csr, np.float32)

    def fn(layout, x, y):
        return 1.0 * swell_ax(layout, x) + 1.0 * y

    return fn, (layout, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
