"""Request inputs drawn from ``--seed``: every vector a request needs, made on
the device by a ``torch.Generator`` seeded from (seed, request index), so the
check can draw the same vector again after the window, and every seed gives
the same sizes and the same number of draws."""

from __future__ import annotations

import torch

_MASK = (1 << 63) - 1


def mix(seed: int, i: int, salt: int = 0) -> int:
    """A 63-bit seed from (seed, i, salt) by splitmix64's finaliser; any
    whole ``seed``, however large."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(i) * 0xBF58476D1CE4E5B9 + salt) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK


class Draw:
    """Vectors of length ``n`` in [-1, 1), float64, on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def vector(self, seed: int, i: int, n: int) -> torch.Tensor:
        self.gen.manual_seed(mix(seed, i))
        return torch.rand(n, generator=self.gen, dtype=torch.float64, device=self.device) * 2 - 1


def kept(seed: int, i: int, every: int) -> bool:
    """Whether request ``i``'s answer is kept for the check: one in ``every``,
    drawn from the seed."""
    return mix(seed, i, salt=0x5BD1E995) % every == 0
