"""Random embeddings (sketches) for the paper-literal adaptive solver.

Port of ``repro.core.sketches``: the three families of the paper (§2.1),
each a sampled S ∈ R^{m×n} applied matrix-free through the port's kernels
(``kernels.ops``: the hand-written CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor):

* ``gaussian`` — entries N(0, 1/m), generated from the counter hash of
  (seed, row, col) inside ``ops.gaussian_sa`` (one sketch of a shared A,
  B = 1); S is never stored. The counter packing holds at most
  ``gaussian_gram.MAX_M`` rows, so a taller sketch is applied in row blocks
  of ``MAX_M``: block 0 is drawn from the seed itself, block j ≥ 1 from
  ``fold_seeds(seed, j)``, and every block is scaled by 1/√m of the whole
  sketch, so the rows stay i.i.d. N(0, 1/m). ``apply_t`` multiplies by the
  generated dense S (the reference, too, computes it outside any kernel).
* ``srht`` — S = √(n_pad/m)·R·H·E/√n_pad: ``apply`` is one FWHT with the
  signs as its fused row scale, then the m rows of R; ``apply_t``
  zero-fills the chosen rows and runs the unscaled FWHT, then the signs.
  R is m rows of [0, n_pad) without replacement while m ≤ n_pad (the first
  m of a stable argsort of hash words, ``ops.srht_sample``), with
  replacement beyond.
* ``sjlt`` — s nonzeros ±1/√s per column: ``apply`` is ``ops.sjlt_apply``
  once per j < s (the B = 1 segment sum), ``apply_t`` a gather. With s = 1
  column i's row is ⌊h_i·m/2³²⌋ of its hash word h_i; with s > 1 the s rows
  of column i are the s smallest of m hash words (a stable top-s, so
  distinct rows).

Randomness: a sketch is a function of one uint32 seed (held in an int64
tensor), drawn from the port's murmur3 counter hash, so it is the same on
the CPU and on the card. The reference's ``jax.random`` samples are handed
over with ``Sketch.from_numpy`` (a Gaussian handed over as its dense S).

Sketch application is linear, so for a row-sharded A = [A_1; …; A_K] the
summed sketch Σ_k S_k A_k with independent per-shard seeds is a sketch of
A (``core.distributed.block_sketch_gram``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.gaussian_gram import (
    MAX_M,
    fold_seeds,
    gaussian_s_dense,
    hash_signs,
    hash_stream,
)

SketchKind = Literal["gaussian", "srht", "sjlt"]
KINDS = ("gaussian", "srht", "sjlt")


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def fwht(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Unnormalized fast Walsh–Hadamard transform along ``axis`` (a power of
    two long) through ``ops.fwht``: on the card, the FWHT kernel without a
    row scale (the reference's ``_fwht_kernel``)."""
    x = torch.movedim(x, axis, 0)
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"FWHT length must be a power of 2, got {n}")
    rest = x.shape[1:]
    y = ops.fwht(x.reshape(n, -1).contiguous())
    return torch.movedim(y.reshape(n, *rest), 0, axis)


def _block_seeds(seed: torch.Tensor, m: int) -> list[tuple[torch.Tensor, int, int]]:
    """The Gaussian sketch's row blocks: (seed of the block, first row,
    rows), at most ``MAX_M`` rows each (module docstring)."""
    return [(seed if j == 0 else fold_seeds(seed, j), r0, min(MAX_M, m - r0))
            for j, r0 in enumerate(range(0, m, MAX_M))]


@dataclasses.dataclass
class Sketch:
    """A sampled random embedding S ∈ R^{m×n}, applied matrix-free.

    ``data``: gaussian ``{"seed"}`` (a 0-d int64 uint32 seed) or a handed-over
    ``{"S"}`` (m, n); srht ``{"signs"}`` (n,) and ``{"rows"}`` (m,); sjlt
    ``{"rows"}`` (s, n) and ``{"signs"}`` (s, n), the signs ±1/√s."""

    kind: str
    m: int
    n: int
    data: dict

    @classmethod
    def from_numpy(cls, kind: str, m: int, n: int, data: dict, *, device=None) -> "Sketch":
        """A sketch from numpy arrays (the reference's ``Sketch.data``):
        gaussian ``S`` (m, n), srht ``signs``/``rows``, sjlt ``rows``/``signs``."""
        import numpy as np

        dev = resolve_device(device)
        out = {}
        for k, v in data.items():
            v = np.array(v)
            dtype = torch.int64 if k == "rows" else torch.float32
            out[k] = torch.as_tensor(v.astype(np.int64) if k == "rows" else v,
                                     dtype=dtype, device=dev)
        return cls(kind=kind, m=m, n=n, data=out)

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        """S @ A for A (n, d) fp32, or a vector (n,)."""
        squeeze = A.dim() == 1
        if squeeze:
            A = A[:, None]
        out = _APPLY[self.kind](self, A.contiguous())
        return out[:, 0] if squeeze else out

    def apply_t(self, Y: torch.Tensor) -> torch.Tensor:
        """S.T @ Y for Y (m, d) fp32, or a vector (m,)."""
        squeeze = Y.dim() == 1
        if squeeze:
            Y = Y[:, None]
        out = _APPLY_T[self.kind](self, Y.contiguous())
        return out[:, 0] if squeeze else out

    def dense(self) -> torch.Tensor:
        """S materialized (testing only)."""
        dev = next(iter(self.data.values())).device
        return self.apply(torch.eye(self.n, dtype=torch.float32, device=dev))


# -- Gaussian ---------------------------------------------------------------

def _gaussian_dense(sk: Sketch) -> torch.Tensor:
    if "S" in sk.data:
        return sk.data["S"]
    blocks = [gaussian_s_dense(s.reshape(1), rows, sk.n)[0]
              for s, _, rows in _block_seeds(sk.data["seed"], sk.m)]
    return torch.cat(blocks) * (1.0 / math.sqrt(sk.m))


def _gaussian_apply(sk: Sketch, A):
    if "S" in sk.data:
        return sk.data["S"] @ A
    parts = [ops.gaussian_sa(A, s.reshape(1), rows)[0]
             for s, _, rows in _block_seeds(sk.data["seed"], sk.m)]
    return torch.cat(parts) * (1.0 / math.sqrt(sk.m))


def _gaussian_apply_t(sk: Sketch, Y):
    return _gaussian_dense(sk).T @ Y


# -- SRHT -------------------------------------------------------------------

def _srht_apply(sk: Sketch, A):
    # H·diag(signs)·A in one FWHT launch (the signs its fused row scale),
    # the m rows of R, then √(n_pad/m)/√n_pad = 1/√m
    return ops.srht_sketch(A, None, sk.m, sample=sk.data)


def _srht_apply_t(sk: Sketch, Y):
    n_pad = _next_pow2(sk.n)
    Z = torch.zeros((n_pad, Y.shape[1]), dtype=Y.dtype, device=Y.device)
    Z[sk.data["rows"]] = Y
    HZ = ops.fwht(Z) / math.sqrt(n_pad)           # the unscaled FWHT
    return HZ[:sk.n] * sk.data["signs"][:, None] * math.sqrt(n_pad / sk.m)


# -- SJLT -------------------------------------------------------------------

def _sjlt_apply(sk: Sketch, A):
    rows, signs = sk.data["rows"], sk.data["signs"]
    out = ops.sjlt_apply(A, rows[0], signs[0], sk.m)
    for j in range(1, rows.shape[0]):       # s is a small constant
        out = out + ops.sjlt_apply(A, rows[j], signs[j], sk.m)
    return out


def _sjlt_apply_t(sk: Sketch, Y):
    rows, signs = sk.data["rows"], sk.data["signs"]
    out = signs[0][:, None] * Y[rows[0]]
    for j in range(1, rows.shape[0]):
        out = out + signs[j][:, None] * Y[rows[j]]
    return out


# -- samplers ---------------------------------------------------------------

def _gaussian_sample(seed, m, n, s):
    return {"seed": seed}


def _srht_sample(seed, m, n, s):
    return ops.srht_sample(seed, n, m)


def _sjlt_sample(seed, m, n, s):
    seeds = seed.reshape(1)
    if s == 1:
        rows = (hash_stream(seeds, 0, n) * m) >> 32                 # (1, n)
    else:
        if n * m > 1 << 32:
            raise ValueError(f"sjlt with s={s} draws n·m hash words; n·m = {n * m} "
                             f"exceeds the 2^32 counters")
        words = hash_stream(seeds, 0, n * m)[0].reshape(n, m)
        rows = torch.sort(words, dim=1, stable=True).indices[:, :s].T   # (s, n)
    signs = hash_signs(hash_stream(seeds, 1, s * n)[0]).reshape(s, n)
    return {"rows": rows, "signs": signs / math.sqrt(s)}


_SAMPLERS = {"gaussian": _gaussian_sample, "srht": _srht_sample, "sjlt": _sjlt_sample}
_APPLY = {"gaussian": _gaussian_apply, "srht": _srht_apply, "sjlt": _sjlt_apply}
_APPLY_T = {"gaussian": _gaussian_apply_t, "srht": _srht_apply_t, "sjlt": _sjlt_apply_t}


def make_sketch(kind: SketchKind, m: int, n: int, seed, *, dtype=torch.float32,
                s: int = 1, device=None) -> Sketch:
    """Sample an m × n sketch of ``kind`` from a uint32 ``seed`` (an int or
    an int64 tensor) on ``device`` (default cuda). The sketches compute in
    fp32; ``dtype`` is there for the reference's signature and must be fp32."""
    if kind not in _SAMPLERS:
        raise ValueError(f"unknown sketch kind {kind!r}")
    if dtype != torch.float32:
        raise ValueError(f"the port's sketches are fp32, got {dtype}")
    dev = resolve_device(device)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=dev).reshape(()) & 0xFFFFFFFF
    return Sketch(kind=kind, m=m, n=n, data=_SAMPLERS[kind](seed, m, n, s))


def sketch_cost_flops(kind: SketchKind, m: int, n: int, d: int, s: int = 1) -> float:
    """Sketching cost model of the complexity benchmarks (Table 2)."""
    if kind == "gaussian":
        return 2.0 * m * n * d
    if kind == "srht":
        n_pad = _next_pow2(n)
        return 2.0 * n_pad * math.log2(max(2, n_pad)) * d
    if kind == "sjlt":
        return 2.0 * s * n * d
    raise ValueError(kind)
