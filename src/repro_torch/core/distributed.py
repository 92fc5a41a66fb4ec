"""Per-shard ladder Grams for elastic shard recovery, on one device.

Port of ``repro.core.distributed.ShardLadderCache`` built by emulation. The
sharded pass itself (``shard_level_grams``, its per-shard form, the mesh
build ``ShardLadderCache.from_mesh``) needs the port's collectives and
waits for ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import torch

from .level_grams import fold_seeds, get_provider, shard_quadratics
from .quadratic import Quadratic


class ShardLadderCache:
    """Cached per-shard ladder-level Gram contributions and their running
    total: the state behind elastic mid-solve shard recovery.

    Built once from the same one-touch pass the engine would run
    (``from_emulation``: ``level_grams.BlockEmulationProvider``'s dataflow,
    the same ``fold_seeds(seed, k)`` per shard). ``total()`` feeds the
    segmented driver's ``grams=``; when shard k dies mid-solve, ``drop(k)``
    updates the total by one (L, B, d, d) subtraction, touching no
    surviving shard's rows, and the new total reaches
    ``reprecondition_padded`` through the driver's ``on_segment`` hook
    (``ft.faults.ShardLossInjector``). The post-drop total is the block
    sketch Gram of the surviving shards: a weaker but valid preconditioner
    of the whole problem, whose Hessian never read the cache."""

    def __init__(self, shard_grams: torch.Tensor):
        if shard_grams.dim() != 5:
            raise ValueError(f"expected (K, L, B, d, d) shard Grams, got shape "
                             f"{tuple(shard_grams.shape)}")
        self.shard_grams = shard_grams
        self.n_shards = int(shard_grams.shape[0])
        self.alive = set(range(self.n_shards))
        # summed in shard order: the provider's order, so the emulated
        # total is bitwise BlockEmulationProvider's Grams
        total = shard_grams[0]
        for k in range(1, self.n_shards):
            total = total + shard_grams[k]
        self._total = total

    @classmethod
    def from_mesh(cls, *args, **kwargs):
        raise NotImplementedError(
            "ShardLadderCache.from_mesh needs the sharded pass over "
            "torch.distributed, not ported yet (ROADMAP queue 1 item 8); "
            "use from_emulation")

    @classmethod
    def from_emulation(cls, inner, seeds: torch.Tensor, q: Quadratic, ladder,
                       n_shards: int, compute_dtype: str | None = None
                       ) -> "ShardLadderCache":
        """Shard k sketches rows [k·n/K, (k+1)·n/K) under
        ``fold_seeds(seeds, k)``; ``seeds`` (B,) int64."""
        inner = get_provider(inner)
        n_loc = q.n // n_shards
        per_shard = [inner.level_grams(inner.sample(fold_seeds(seeds, k), ladder[-1], n_loc),
                                       q_k, ladder, compute_dtype=compute_dtype)
                     for k, q_k in enumerate(shard_quadratics(q, n_shards))]
        return cls(torch.stack(per_shard))

    def total(self) -> torch.Tensor:
        """(L, B, d, d) level Grams summed over the shards still alive."""
        return self._total

    def drop(self, k: int) -> torch.Tensor:
        """Shard k died: subtract its contribution from the total (no
        surviving shard is read again) and return the new (L, B, d, d)
        Grams."""
        if k not in self.alive:
            raise ValueError(f"shard {k} is not alive (alive: {sorted(self.alive)})")
        if len(self.alive) <= 1:
            raise ValueError("cannot drop the last remaining shard")
        self.alive.discard(k)
        self._total = self._total - self.shard_grams[k]
        return self._total
