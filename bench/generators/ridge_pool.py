"""Generator ``ridge_pool``: seeded pools of ridge problems, made on the device.

A traffic mix (``bench/traffic/<mix>.json``) names its generator, this
file's name, and gives its parameters; a configuration may add a
``problem`` of its own (the data a deployment holds), and the mix's keys
are laid over it. ``generate`` reads:

* ``pool``: the number of distinct problems;
* ``n``, ``d``: [lo, hi], whole numbers, with n ≥ d (tall problems);
* ``decay``, ``decay_offset``: the spectrum σ_j = decay^(j + offset),
  j = 0 … d − 1, of A = U·diag(σ)·Vᵀ with U, V orthonormal;
* ``nu``: [lo, hi], ν log-uniform between them.

Sizes and ν are stratified, not drawn: the k-th of ``pool`` values sits at
quantile (k + ½)/pool, and the seed only permutes them. So every seed gives
the same set of sizes and ν, in another order, with other U, V and y, and a
run's work does not hang on its seed. U and V are orthonormalized Gaussian
blocks, a few batched calls for the whole pool: U's block has zero rows
past n_i, so its columns live in the first n_i rows (a tall Gaussian block
is well conditioned, so two passes of Cholesky-QR make it orthonormal to
float32's rounding); V's block is the identity past d_i, so its QR's Q is
blockdiag(V_i, ±I). y ~ N(0, I).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class Pool:
    A: list            # (n_i, d_i) fp32 tensors
    y: list            # (n_i,) fp32 tensors
    nu: list           # floats

    def __len__(self) -> int:
        return len(self.y)


def _log_stratified(lo: float, hi: float, count: int) -> list[float]:
    a, b = math.log10(lo), math.log10(hi)
    return [10.0 ** (a + (b - a) * (k + 0.5) / count) for k in range(count)]


def _ints(rng, count: int) -> list[int]:
    lo, hi = (rng, rng) if isinstance(rng, int) else rng
    return [lo + int((hi - lo + 1) * (k + 0.5) / count) for k in range(count)]


def _perm(values: list, g: torch.Generator) -> list:
    return [values[i] for i in torch.randperm(len(values), generator=g).tolist()]


def _orthonormal(G: torch.Tensor) -> torch.Tensor:
    """G's columns orthonormalized by Cholesky-QR, twice (G tall and well
    conditioned, as a Gaussian block is)."""
    for _ in range(2):
        R = torch.linalg.cholesky(G.mT @ G, upper=True)
        G = torch.linalg.solve_triangular(R, G, upper=True, left=False)
    return G


def generate(spec: dict, seed: int, device) -> Pool:
    """The pool of ridge problems that ``spec`` describes (module
    docstring), drawn from ``seed`` on ``device``."""
    dev = torch.device(device)
    P = int(spec["pool"])
    host = torch.Generator().manual_seed(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    ns, ds = _perm(_ints(spec["n"], P), host), _perm(_ints(spec["d"], P), host)
    nu_rng = spec["nu"] if isinstance(spec["nu"], list) else [spec["nu"]] * 2
    nus = _perm(_log_stratified(*nu_rng, P), host)
    decay, off = float(spec["decay"]), int(spec.get("decay_offset", 0))
    N, D = max(ns), max(ds)
    if min(ns) < D:
        raise ValueError(f"every n must be at least the largest d ({D}), got {min(ns)}")
    n_t = torch.tensor(ns, device=dev)
    d_t = torch.tensor(ds, device=dev)
    rows = torch.arange(N, device=dev)
    cols = torch.arange(D, device=dev)
    G = torch.randn((P, N, D), generator=g, device=dev)
    G *= (rows[None, :, None] < n_t[:, None, None])
    U = _orthonormal(G)
    del G
    inside = (cols[None, :, None] < d_t[:, None, None]) & (cols[None, None, :] < d_t[:, None, None])
    eye = torch.eye(D, device=dev).expand(P, D, D)
    V, _ = torch.linalg.qr(torch.where(inside, torch.randn((P, D, D), generator=g, device=dev),
                                       eye))
    sigma = decay ** (off + cols.to(torch.float32))
    sigma = torch.where(cols[None, :] < d_t[:, None], sigma[None, :], 0.0)
    A_pad = (U * sigma[:, None, :]) @ V.transpose(1, 2)
    del U, V
    Y = torch.randn((P, N), generator=g, device=dev)
    A = [A_pad[i, :n, :d].contiguous() for i, (n, d) in enumerate(zip(ns, ds))]
    y = [Y[i, :n].contiguous() for i, n in enumerate(ns)]
    return Pool(A=A, y=y, nu=nus)

