"""Ladder-level Gram providers for the padded adaptive engine.

Port of ``repro.core.level_grams`` for the families of the serving path.
Each provider turns per-problem randomness into the (L, B, d, d) Grams
(S_m W^{1/2}A)ᵀ(S_m W^{1/2}A) at every doubling-ladder level m, touching A
exactly once. Row weights W (``row_weights=`` (B, n), overriding
``q.row_weights``; W = I when both are None) fold into the scale slot each
family already owns (the Gaussian column scale, the SJLT signs, the FWHT's
row scale), so no weighted copy of A is ever made.
The Grams are λ-free: the ν²Λ shift enters only at factorization
(``precond.shifted_ladder_inverses``).

Randomness: JAX's threefry keys cannot be reproduced without JAX, so the
port's per-problem "key" is a uint32 seed held in an int64 tensor, and
problem b's sketch depends only on seed b. The Gaussian families use the
seed directly (the reference's ``_uint32_seeds(keys)`` is exactly such a
seed, so tests can hand it over). The SRHT and the SJLT draw their samples
from the same murmur3 counter hash, keyed by ``fold_seeds(seed, 0)`` and
``fold_seeds(seed, 1)``, so a sample is the same on the CPU and on the
card; the tests hand the reference's ``jax.random`` samples over through
``bridge.sample_from_numpy``.

* ``gaussian`` — streamed: S is generated inside the fused sketch→SA kernel
  and never stored; level m is the first m rows, rescaled by 1/m on the Gram.
* ``gaussian_dense`` — the same entries, materialized as (B, m_max, n):
  the memory baseline.
* ``sjlt`` — each data row i carries a uniform u_i and a sign; its level-m
  target is ⌊u_i·m⌋, and ⌊u·m⌋ = ⌊⌊u·2m⌋/2⌋ makes each pow2 level a
  pairwise row fold of the level above. ONE kernel pass at the top power of
  two M ≥ m_max, then the folds; a non-pow2 cap folds the M − m_max tail
  rows back onto the head.
* ``srht`` — one sign flip + one FWHT pass over A, then level m = the first
  m rows of a row stream drawn i.i.d. uniform WITH replacement, so every
  prefix is a valid m-row sample (the reference's law).

``BlockEmulationProvider`` wraps any family as the sharded block sketch on
one device (shard k seeded ``fold_seeds(seed, k)``), with shard dropout for
the chaos tests (``ft.faults``).

Compute dtype (``kernels.precision``): every provider applies it to the
sketch pass only; the (L, B, d, d) Grams it returns are fp32 in every mode.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.gaussian_gram import (  # noqa: F401 (fold_seeds: re-exported)
    fold_seeds,
    gaussian_s_dense,
    hash_signs,
    hash_stream,
    resolve_stream,
)
# COMPUTE_DTYPES is re-exported for the launchers, as in the reference
from repro_torch.kernels.precision import (  # noqa: F401
    COMPUTE_DTYPES,
    canonical_compute_dtype,
    contract_dtype,
)

from .quadratic import Quadratic

# columns of the dense S rounded per step in the reduced modes: the bf16
# temporary stays a block, not half of S
_ROUND_BLOCK = 256

def prefix_level_grams(R: torch.Tensor, ladder: tuple[int, ...], *,
                       inv_m_scale: bool) -> torch.Tensor:
    """(L, B, d, d) Grams from a (B, m_max, d) row stream whose level-m
    sketch is the first m rows: prefix-summed per-segment row Grams, with
    the per-level 1/√m entry rescale folded in as 1/m when asked. A bf16
    row stream (the reduced modes) accumulates into fp32 Grams: its products
    are exact in fp32 and its sums fp32. Each level is written into the
    (L, B, d, d) result as it is made, so the stack exists once (a list
    stacked at the end would hold it twice at the pass's peak)."""
    B, _, d = R.shape
    out = torch.empty((len(ladder), B, d, d), dtype=torch.float32, device=R.device)
    prev = 0
    acc = torch.zeros((B, d, d), dtype=torch.float32, device=R.device)
    for i, m in enumerate(ladder):
        seg = R[:, prev:m, :].to(torch.float32)
        acc = acc + torch.bmm(seg.transpose(1, 2), seg)
        out[i] = acc / m if inv_m_scale else acc
        prev = m
    return out


def _weights(q: Quadratic, row_weights):
    """The pass's row weights: ``row_weights`` (B, n) overrides
    ``q.row_weights``; None for W = I."""
    return q.row_weights if row_weights is None else row_weights


class GaussianStreamedProvider:
    """Streaming fused sketch→Gram (the default ``gaussian`` family)."""

    name = "gaussian"

    def sample(self, seeds, m_max, n):
        return {"seeds": seeds}

    def level_grams(self, data, q: Quadratic, ladder, row_weights=None,
                    compute_dtype=None):
        # w^{1/2} scales the generated S's columns inside the kernel
        # (Pallas row 2): no weighted copy of A
        SA = ops.gaussian_sa(q.A, data["seeds"], ladder[-1],
                             row_weights=_weights(q, row_weights),
                             compute_dtype=compute_dtype)
        return prefix_level_grams(SA, ladder, inv_m_scale=True)


class GaussianDenseProvider:
    """Materialized-S baseline: identical sketch entries, O(B·m_max·n)."""

    name = "gaussian_dense"

    def sample(self, seeds, m_max, n):
        return {"seeds": seeds}

    def level_grams(self, data, q: Quadratic, ladder, row_weights=None,
                    compute_dtype=None):
        # the streamed provider's scale algebra (w^{1/2} and the int8
        # scales in one column scale), on the materialized S
        seeds = data["seeds"]
        A, scale = resolve_stream(q.A, seeds.shape[0], _weights(q, row_weights),
                                  compute_dtype)
        ct = contract_dtype(compute_dtype)
        return prefix_level_grams(_dense_sa(seeds, ladder[-1], A, scale, ct), ladder,
                                  inv_m_scale=True)


def _dense_sa(seeds, m: int, A: torch.Tensor, scale, ct: torch.dtype) -> torch.Tensor:
    """S·diag(scale)·A with the materialized S, which is scaled and rounded
    in place (elementwise, so bitwise the out-of-place result) and freed
    before the caller builds the Grams: the pass holds one S, and in the
    reduced modes one fp32 copy of A, rounded a block of rows at a time
    (``round_to`` whole would also hold an A-sized ``ct`` copy)."""
    S = gaussian_s_dense(seeds, m, A.shape[-2])
    if scale is not None:
        S.mul_(scale[:, None, :])
    if ct != torch.float32:
        for c0 in range(0, S.shape[-1], _ROUND_BLOCK):
            block = S[..., c0:c0 + _ROUND_BLOCK]
            block.copy_(block.to(ct))             # round_to, a block at a time
    if A.dtype == torch.float32 and ct == torch.float32:
        return torch.matmul(S, A)
    A_r = torch.empty(A.shape, dtype=torch.float32, device=A.device)
    for r0 in range(0, A.shape[-2], _ROUND_BLOCK):
        A_r[..., r0:r0 + _ROUND_BLOCK, :].copy_(A[..., r0:r0 + _ROUND_BLOCK, :].to(ct))
    return torch.matmul(S, A_r)


def _n_pad(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class SJLTProvider:
    """s = 1 SJLT ladder: one kernel pass at the top power of two, folds below."""

    name = "sjlt"

    def sample(self, seeds, m_max, n):
        # u = (h >> 8)·2^-24: uniform on the 2^24 fp32 grid points of [0, 1)
        u = (hash_stream(seeds, 0, n) >> 8).to(torch.float32) * (1.0 / 16777216.0)
        return {"u": u, "signs": hash_signs(hash_stream(seeds, 1, n))}

    def level_grams(self, data, q: Quadratic, ladder, row_weights=None,
                    compute_dtype=None):
        u, signs = data["u"], data["signs"]
        m_max = ladder[-1]
        M = _n_pad(m_max)                              # top pow2 ≥ m_max
        rows = torch.clamp(torch.floor(u * float(M)), 0, M - 1).to(torch.int32)
        SA = ops.sjlt_apply_batched(q.A, rows, signs, M,        # the ONE touch
                                    row_weights=_weights(q, row_weights),
                                    compute_dtype=compute_dtype)
        by_m = {M: SA}
        m = M
        while m > 1:                    # ⌊u·m⌋ = ⌊⌊u·2m⌋/2⌋: pairwise fold
            SA = SA[:, 0::2, :] + SA[:, 1::2, :]
            m //= 2
            by_m[m] = SA
        if m_max != M:                  # non-pow2 cap: fold the tail rows
            top = by_m[M]
            head, tail = top[:, :m_max, :], top[:, m_max:, :]
            by_m[m_max] = head + torch.nn.functional.pad(
                tail, (0, 0, 0, 2 * m_max - M))
        B, d = SA.shape[0], SA.shape[2]
        out = torch.empty((len(ladder), B, d, d), dtype=torch.float32, device=SA.device)
        for i, m in enumerate(ladder):          # written in place: the stack exists once
            out[i] = torch.bmm(by_m[m].transpose(1, 2), by_m[m])
        return out


class SRHTProvider:
    """SRHT ladder: one FWHT pass, level m = first m of a fixed row stream.

    Rows are drawn i.i.d. uniform over the padded index space WITH
    replacement, so every prefix of the stream is a valid m-row sample for
    every ladder level. ``kernels.ops.srht_sketch`` (the fixed-size sketch)
    samples WITHOUT replacement instead, the classical SRHT; both are
    unbiased (E[SᵀS] = I) and agree where m ≪ n_pad."""

    name = "srht"

    def sample(self, seeds, m_max, n):
        # n_pad is a power of two, so the low bits are an unbiased draw
        return {"signs": hash_signs(hash_stream(seeds, 0, n)),
                "rows": hash_stream(seeds, 1, m_max) & (_n_pad(n) - 1)}

    def level_grams(self, data, q: Quadratic, ladder, row_weights=None,
                    compute_dtype=None):
        signs, rows = data["signs"], data["rows"]
        B = signs.shape[0]
        n, d = q.n, q.d
        n_pad = _n_pad(n)
        w = _weights(q, row_weights)
        # signs (and w^{1/2}) fold into the FWHT's one fused row scale
        scale = signs if w is None else signs * torch.sqrt(w).to(signs.dtype)
        X = q.A
        if canonical_compute_dtype(compute_dtype) == "int8":
            # quantize before the pad so the padded copy is 1 B/elem; the
            # dequantization scales join the fused row scale
            from repro_torch.dist.compress import quantize_rows

            X, a_scales = quantize_rows(X)
            scale = scale * a_scales        # shared A: (n,) broadcasts over B
        if n_pad != n:
            X = torch.nn.functional.pad(X, (0, 0, 0, n_pad - n))
            scale = torch.nn.functional.pad(scale, (0, n_pad - n))
        HX = ops.fwht_cols(X, row_scale=scale, batch=B,       # the ONE touch
                           compute_dtype=compute_dtype)
        picked = torch.gather(HX, 1, rows[:, :, None].expand(B, rows.shape[1], d))
        return prefix_level_grams(picked, ladder, inv_m_scale=True)


class BlockEmulationProvider:
    """One-device emulation of the sharded concatenated block sketch: shard
    k applies ``inner`` with seeds ``fold_seeds(seed, k)`` to rows
    [k·n/K, (k+1)·n/K) and the shard Grams are summed in shard order, so
    blockdiag(S_k) has no cross terms and the sum is the sketch Gram of the
    whole A. ``fold_seeds`` stands in for the reference's ``fold_in(key,
    k)``; the sample is ``{"shards": [inner sample, ...]}``, so a test can
    hand the reference's per-shard samples over. Pass the instance itself as
    the engine's ``sketch=``.

    ``drop_shards`` emulates shard loss: the listed shards add nothing to
    the sum, the Gram a pod re-reduces over its surviving shards. That is
    still a sketch of the surviving rows, a weaker preconditioner of the
    whole problem; when the lost rows carried most of the mass, the engine's
    guards, retries and fallback keep the answer honest."""

    def __init__(self, inner, n_shards: int, drop_shards: tuple[int, ...] = ()):
        self.inner = get_provider(inner)
        self.n_shards = n_shards
        self.drop_shards = tuple(sorted(set(drop_shards)))
        if any(k < 0 or k >= n_shards for k in self.drop_shards):
            raise ValueError(f"drop_shards {drop_shards} out of range for {n_shards}")
        if len(self.drop_shards) >= n_shards:
            raise ValueError("cannot drop every shard")
        drop = f"-drop{list(self.drop_shards)}" if self.drop_shards else ""
        self.name = f"block[{self.inner.name}x{n_shards}{drop}]"

    def _check(self, n: int) -> int:
        if n % self.n_shards:
            raise ValueError(f"n={n} not divisible by {self.n_shards} emulated shards")
        return n // self.n_shards

    def sample(self, seeds, m_max, n):
        n_loc = self._check(n)
        return {"shards": [self.inner.sample(fold_seeds(seeds, k), m_max, n_loc)
                           for k in range(self.n_shards)]}

    def level_grams(self, data, q: Quadratic, ladder, row_weights=None,
                    compute_dtype=None):
        out = None
        for k, (q_k, data_k) in enumerate(zip(shard_quadratics(q, self.n_shards,
                                                               row_weights),
                                              data["shards"])):
            if k in self.drop_shards:          # a lost shard adds nothing
                continue
            # each shard's pass in the compute dtype; its fp32 Grams sum
            g_k = self.inner.level_grams(data_k, q_k, ladder, compute_dtype=compute_dtype)
            out = g_k if out is None else out + g_k
        return out


def shard_block(q: Quadratic, n_shards: int, k: int, row_weights=None) -> Quadratic:
    """Block k of q's rows cut into ``n_shards`` equal blocks, with its block
    of the row weights (``row_weights`` overrides ``q.row_weights``). The
    block of A is copied contiguous, as a shard holds its rows: the kernels
    read A only in that layout."""
    if q.n % n_shards:
        raise ValueError(f"n={q.n} not divisible by {n_shards} emulated shards")
    n_loc = q.n // n_shards
    rows = slice(k * n_loc, (k + 1) * n_loc)
    w = _weights(q, row_weights)
    return Quadratic(A=q.A[..., rows, :].contiguous(), b=q.b, nu=q.nu,
                     lam_diag=q.lam_diag, batched=q.batched,
                     row_weights=None if w is None else w[..., rows])


def shard_quadratics(q: Quadratic, n_shards: int, row_weights=None) -> list[Quadratic]:
    """q's rows cut into ``n_shards`` equal blocks (``shard_block`` each)."""
    return [shard_block(q, n_shards, k, row_weights) for k in range(n_shards)]


_PROVIDERS = {p.name: p for p in (
    GaussianStreamedProvider(), GaussianDenseProvider(), SJLTProvider(),
    SRHTProvider())}

PADDED_SKETCHES = tuple(_PROVIDERS)


def get_provider(sketch):
    """Resolve a sketch-family name to its (stateless) provider; provider
    instances pass through unchanged."""
    if not isinstance(sketch, str):
        return sketch
    try:
        return _PROVIDERS[sketch]
    except KeyError:
        raise ValueError(
            f"padded engine supports {PADDED_SKETCHES}, got {sketch!r}") from None
