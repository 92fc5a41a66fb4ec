"""Fault injection for the solve pipeline's failure model.

Port of ``repro.ft.faults``. The failure model claims per-slot isolation,
bounded retries, truthful statuses and finite answers; these injectors are
what the chaos tests (``tests/test_torch_faults.py``) and ``chip_smoke.py``
drive against the engine, the robust driver and the service:

* data faults: a NaN row of A or an Inf target (``inject_nan_row``,
  ``inject_inf_entry``), a rank-deficient A (``rank_deficient_matrix``), a
  conditioning of κ ≈ 1e10 (``ill_conditioned_matrix``);
* sketch faults: an adversarial seed (``AdversarialKeyProvider``). The
  service derives slot seeds deterministically, so a seed whose draw is bad
  for a problem stays bad; the wrapper poisons exactly the slots whose seed
  is black-listed, and the retry driver's ``fold_seeds(seed, attempt)``
  redraw is the designed escape;
* infrastructure faults: shard loss, before the solve
  (``dropout_provider``: the lost shards add nothing to the level Grams) or
  in the middle of it (``ShardLossInjector``: one subtraction from a
  ``core.distributed.ShardLadderCache``, then a reprecondition).

Nothing on the production path imports this module.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.level_grams import BlockEmulationProvider, get_provider


# -- data faults -------------------------------------------------------------
def inject_nan_row(A: torch.Tensor, problem: int, row: int = 0) -> torch.Tensor:
    """A copy of A (B, n, d) with one problem's row set to NaN (a corrupted
    feature record)."""
    A = A.clone()
    A[problem, row, :] = float("nan")
    return A


def inject_inf_entry(y: torch.Tensor, problem: int, idx: int = 0,
                     sign: float = 1.0) -> torch.Tensor:
    """A copy of y (B, n) with one problem's target set to ±Inf (an
    overflowed label)."""
    y = y.clone()
    y[problem, idx] = sign * float("inf")
    return y


def rank_deficient_matrix(g: torch.Generator, n: int, d: int, rank: int) -> torch.Tensor:
    """(n, d) matrix of exact rank ``rank`` < d, L·R with L (n, rank) and R
    (rank, d) drawn from ``g`` on its device (collinear features)."""
    if not 0 < rank < d:
        raise ValueError(f"need 0 < rank < d, got rank={rank}, d={d}")
    L = torch.randn((n, rank), generator=g, device=g.device) / n ** 0.5
    R = torch.randn((rank, d), generator=g, device=g.device)
    return L @ R


def ill_conditioned_matrix(g: torch.Generator, n: int, d: int,
                           cond: float = 1e10) -> torch.Tensor:
    """(n, d) matrix U·diag(σ)·Vᵀ with orthonormal U, V drawn from ``g`` and
    singular values log-spaced from 1 down to 1/``cond``."""
    U, _ = torch.linalg.qr(torch.randn((n, d), generator=g, device=g.device))
    V, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=g.device))
    sv = torch.logspace(0.0, -math.log10(cond), d, device=g.device)
    return (U * sv[None, :]) @ V.T


# -- sketch faults -----------------------------------------------------------
class AdversarialKeyProvider:
    """Level-Gram provider wrapper that NaN-poisons the sketch of exactly
    the problems whose seed is on a black-list of uint32 seeds.

    The poison is lanewise over the problem axis of the (L, B, d, d) Grams
    (``torch.where``), so the other problems' Grams are bitwise a clean
    pass's. A redrawn seed (the retry driver's ``fold_seeds(seed,
    attempt)``) is off the list, so a retry recovers."""

    def __init__(self, inner, bad_seeds):
        self.inner = get_provider(inner)
        self._bad = torch.as_tensor(bad_seeds, dtype=torch.int64).reshape(-1) & 0xFFFFFFFF
        self.name = f"adversarial[{self.inner.name}]"

    def sample(self, seeds, m_max, n):
        return {"inner": self.inner.sample(seeds, m_max, n),
                "_poisoned": torch.isin(seeds & 0xFFFFFFFF, self._bad.to(seeds.device))}

    def level_grams(self, data, q, ladder, row_weights=None, compute_dtype=None):
        g = self.inner.level_grams(data["inner"], q, ladder, row_weights=row_weights,
                                   compute_dtype=compute_dtype)
        return torch.where(data["_poisoned"][None, :, None, None],
                           torch.full_like(g, float("nan")), g)


# -- infrastructure faults ---------------------------------------------------
def dropout_provider(inner, n_shards: int,
                     drop_shards: tuple[int, ...]) -> BlockEmulationProvider:
    """Block-sketch provider emulating a pod that lost ``drop_shards`` of its
    ``n_shards`` data shards and sums the level Grams over the survivors."""
    return BlockEmulationProvider(inner, n_shards, drop_shards=drop_shards)


class ShardLossInjector:
    """Hook for the segmented driver's ``on_segment``: at segment
    ``at_segment`` (once), shard ``shard`` dies; the cache recombines the
    surviving level Grams by one subtraction (``cache.drop``) and hands them
    back, and the driver repreconditions mid-solve. ``cache`` is a
    ``core.distributed.ShardLadderCache`` built before the solve, whose
    ``total()`` was the solve's ``grams=``."""

    def __init__(self, cache, *, shard: int, at_segment: int):
        self.cache = cache
        self.shard = shard
        self.at_segment = at_segment
        self.fired = False
        self.fired_at: int | None = None

    def __call__(self, segment: int, state):
        if self.fired or segment < self.at_segment:
            return None
        self.fired = True
        self.fired_at = segment
        return self.cache.drop(self.shard)
