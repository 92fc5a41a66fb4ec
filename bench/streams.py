"""Seeded streams that an entry draws its requests from, whatever the pool.

``order`` walks a pool pass after pass, each pass in a new order drawn from
the seed, so a loop that takes the pool's problems a few at a time meets
them in ever new company, and a run's mean over its window does not rest
on a handful of fixed groups. ``poisson`` gives an open loop's arrivals.
"""

from __future__ import annotations

import torch


def order(size: int, seed: int):
    """Pool indices, pass after pass, each pass a fresh permutation."""
    g = torch.Generator().manual_seed((seed * 2654435761 + 1) % 2 ** 63)
    while True:
        yield from torch.randperm(size, generator=g).tolist()


def poisson(rate: float, seed: int):
    """Seconds between arrivals of a Poisson process of ``rate`` a second."""
    g = torch.Generator().manual_seed((seed * 2246822519 + 3) % 2 ** 63)
    while True:
        yield from torch.empty(4096, dtype=torch.float64).exponential_(rate, generator=g).tolist()
