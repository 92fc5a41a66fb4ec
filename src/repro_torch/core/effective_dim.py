"""Effective dimension and critical sketch sizes (paper §1, §2.2, §5).

Port of ``repro.core.effective_dim``. d_e = tr(Aν)/‖Aν‖₂ with
Aν = AᵀA(AᵀA + ν²Λ)⁻¹. For Λ = I and singular values σ_i of A:
d_e = Σ σ_i²/(σ_i²+ν²) · (σ_1²+ν²)/σ_1².

The critical-sketch-size formulas of Table 1 / Theorem 5.1 predict (they do
not run) the adaptive controller; the benchmarks print them beside the
measured m_final.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device


def effective_dimension(singular_values: torch.Tensor, nu: float) -> torch.Tensor:
    """d_e from the σ_i of A (Λ = I_d)."""
    s2 = singular_values ** 2
    ratios = s2 / (s2 + nu ** 2)
    return torch.sum(ratios) / torch.max(ratios)


def effective_dimension_exact(A: torch.Tensor, nu: float, lam_diag=None) -> float:
    """d_e by direct eigen-decomposition (testing and small problems only)."""
    d = A.shape[1]
    lam = torch.ones((d,), dtype=A.dtype, device=A.device) if lam_diag is None else lam_diag
    G = A.T @ A
    M = G @ torch.linalg.inv(G + (nu ** 2) * torch.diag(lam))
    eig = torch.linalg.eigvalsh(0.5 * (M + M.T))
    return float(torch.sum(eig) / torch.max(eig))


def effective_dimension_weighted_exact(A: torch.Tensor, w: torch.Tensor, nu: float,
                                       lam_diag=None) -> float:
    """d_e(W) = tr(M)/‖M‖₂ for M = AᵀWA (AᵀWA + ν²Λ)⁻¹: the effective
    dimension of a weighted system (a GLM Newton subproblem at weights w).
    Materializes W^{1/2}A: testing and small problems only."""
    return effective_dimension_exact(torch.sqrt(w)[:, None] * A, nu, lam_diag)


# -- critical sketch sizes (Table 1 / Thm 5.1), with explicit constants -------

def m_delta_srht(d_e: float, n: int, delta: float = 0.1) -> float:
    """Theorem 5.1:  m_δ = 16 log(16 d_e/δ) (√d_e + √(8 log(2n/δ)))²."""
    d_e = max(d_e, 1.0)
    return 16.0 * math.log(16.0 * d_e / delta) * (
        math.sqrt(d_e) + math.sqrt(8.0 * math.log(2.0 * n / delta))) ** 2


def m_delta_gaussian(d_e: float, delta: float = 0.1) -> float:
    """Theorem 5.2:  m_δ = (√d_e + √(8 log(16/δ)))²."""
    return (math.sqrt(max(d_e, 1.0)) + math.sqrt(8.0 * math.log(16.0 / delta))) ** 2


def m_delta_sjlt(d_e: float, delta: float = 0.1) -> float:
    """Table 1: O(d_e²/δ). The paper states only the order; the leading
    constant is taken to be exactly 1, as in the reference, so a comparison
    with a measured critical size is a conservative bound, not a sharp
    prediction."""
    return max(d_e, 1.0) ** 2 / delta


M_DELTA = {
    "srht": lambda d_e, n, delta: m_delta_srht(d_e, n, delta),
    "gaussian": lambda d_e, n, delta: m_delta_gaussian(d_e, delta),
    "sjlt": lambda d_e, n, delta: m_delta_sjlt(d_e, delta),
}


def exp_decay_singular_values(d: int, rate: float = 0.995, *, device=None) -> torch.Tensor:
    """σ_j = rate^j, j = 1..d, fp32: the paper's synthetic spectrum (§6), on
    ``device`` (default cuda)."""
    return rate ** torch.arange(1, d + 1, dtype=torch.float32,
                                device=resolve_device(device))
