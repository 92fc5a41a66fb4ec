"""Ladder-level Gram providers for the padded adaptive engine.

Port of ``repro.core.level_grams`` for the families of the serving path.
Each provider turns per-problem randomness into the (L, B, d, d) Grams
(S_m A)ᵀ(S_m A) at every doubling-ladder level m, touching A exactly once.
The Grams are λ-free: the ν²Λ shift enters only at factorization
(``precond.shifted_ladder_inverses``).

Randomness: JAX's threefry keys cannot be reproduced without JAX, so the
port's per-problem "key" is a uint32 seed held in an int64 tensor, and
problem b's sketch depends only on seed b. The Gaussian families use the
seed directly (the reference's ``_uint32_seeds(keys)`` is exactly such a
seed, so tests can hand it over). The SRHT draws its signs and rows from the
same murmur3 counter hash, keyed by ``fold_seeds(seed, 0)`` and
``fold_seeds(seed, 1)``, so its sample is the same on the CPU and on the
card.

* ``gaussian`` — streamed: S is generated inside the fused sketch→SA kernel
  and never stored; level m is the first m rows, rescaled by 1/m on the Gram.
* ``gaussian_dense`` — the same entries, materialized as (B, m_max, n):
  the memory baseline.
* ``srht`` — one sign flip + one FWHT pass over A, then level m = the first
  m rows of a row stream drawn i.i.d. uniform WITH replacement, so every
  prefix is a valid m-row sample (the reference's law).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.gaussian_gram import (
    _M32,
    _mix,
    counter_hash,
    gaussian_s_dense,
)
from repro_torch.kernels.precision import require_fp32

from .quadratic import Quadratic


def fold_seeds(seeds: torch.Tensor, tag) -> torch.Tensor:
    """A new uint32 seed per problem from (seed, tag): mix(mix(seed) + mix(tag)).
    For a fixed tag it is a bijection of the seed. ``tag`` is an int or a
    tensor broadcasting against ``seeds``. The robust driver folds in the
    retry attempt, the service its slot ids, the SRHT its two streams."""
    tag = torch.as_tensor(tag, dtype=torch.int64, device=seeds.device) & _M32
    return _mix((_mix(seeds & _M32) + _mix(tag)) & _M32)


def prefix_level_grams(R: torch.Tensor, ladder: tuple[int, ...], *,
                       inv_m_scale: bool) -> torch.Tensor:
    """(L, B, d, d) Grams from a (B, m_max, d) row stream whose level-m
    sketch is the first m rows: prefix-summed per-segment row Grams, with
    the per-level 1/√m entry rescale folded in as 1/m when asked."""
    B, _, d = R.shape
    grams, prev = [], 0
    acc = torch.zeros((B, d, d), dtype=torch.float32, device=R.device)
    for m in ladder:
        seg = R[:, prev:m, :]
        acc = acc + torch.bmm(seg.transpose(1, 2), seg)
        grams.append(acc / m if inv_m_scale else acc)
        prev = m
    return torch.stack(grams)


class GaussianStreamedProvider:
    """Streaming fused sketch→Gram (the default ``gaussian`` family)."""

    name = "gaussian"

    def sample(self, seeds, m_max, n):
        return {"seeds": seeds}

    def level_grams(self, data, q: Quadratic, ladder, compute_dtype=None):
        SA = ops.gaussian_sa(q.A, data["seeds"], ladder[-1],
                             compute_dtype=compute_dtype)
        return prefix_level_grams(SA, ladder, inv_m_scale=True)


class GaussianDenseProvider:
    """Materialized-S baseline: identical sketch entries, O(B·m_max·n)."""

    name = "gaussian_dense"

    def sample(self, seeds, m_max, n):
        return {"seeds": seeds}

    def level_grams(self, data, q: Quadratic, ladder, compute_dtype=None):
        require_fp32(compute_dtype)
        S = gaussian_s_dense(data["seeds"], ladder[-1], q.n)
        SA = torch.matmul(S, q.A)
        return prefix_level_grams(SA, ladder, inv_m_scale=True)


def _n_pad(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class SRHTProvider:
    """SRHT ladder: one FWHT pass, level m = first m of a fixed row stream."""

    name = "srht"

    def sample(self, seeds, m_max, n):
        n_pad = _n_pad(n)
        dev = seeds.device
        h_sign = counter_hash(fold_seeds(seeds, 0),
                              torch.arange(n, dtype=torch.int64, device=dev))
        h_rows = counter_hash(fold_seeds(seeds, 1),
                              torch.arange(m_max, dtype=torch.int64, device=dev))
        signs = 1.0 - 2.0 * (h_sign >> 31).to(torch.float32)
        # n_pad is a power of two, so the low bits are an unbiased draw
        return {"signs": signs, "rows": h_rows & (n_pad - 1)}

    def level_grams(self, data, q: Quadratic, ladder, compute_dtype=None):
        signs, rows = data["signs"], data["rows"]
        B = signs.shape[0]
        n, d = q.n, q.d
        n_pad = _n_pad(n)
        X, scale = q.A, signs
        if n_pad != n:
            X = torch.nn.functional.pad(X, (0, 0, 0, n_pad - n))
            scale = torch.nn.functional.pad(scale, (0, n_pad - n))
        HX = ops.fwht_cols(X, row_scale=scale, batch=B,       # the ONE touch
                           compute_dtype=compute_dtype)
        picked = torch.gather(HX, 1, rows[:, :, None].expand(B, rows.shape[1], d))
        return prefix_level_grams(picked, ladder, inv_m_scale=True)


_PROVIDERS = {p.name: p for p in (
    GaussianStreamedProvider(), GaussianDenseProvider(), SRHTProvider())}

PADDED_SKETCHES = tuple(_PROVIDERS)


def get_provider(sketch):
    """Resolve a sketch-family name to its (stateless) provider; provider
    instances pass through unchanged."""
    if not isinstance(sketch, str):
        return sketch
    if sketch == "sjlt":
        raise NotImplementedError(
            "the sjlt family is not ported yet (ROADMAP queue 1 item 6, "
            "queue 2 items 4-5)")
    try:
        return _PROVIDERS[sketch]
    except KeyError:
        raise ValueError(
            f"padded engine supports {PADDED_SKETCHES}, got {sketch!r}") from None
