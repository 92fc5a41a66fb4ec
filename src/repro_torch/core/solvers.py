"""The rate constants of the preconditioned methods (paper §1, §3) that the
padded engine reads: Condition 2.4's (φ(ρ), α) per method and c(α, ρ)."""

from __future__ import annotations

import math


def rho_to_rate(method: str, rho: float) -> tuple[float, float]:
    """(φ(ρ), α) for Condition 2.4 per method."""
    if method == "ihs":
        return rho, 1.0
    if method in ("pcg", "polyak"):
        r = (1.0 - math.sqrt(1.0 - rho)) / (1.0 + math.sqrt(1.0 - rho))
        return r, 4.0
    raise ValueError(method)


def c_alpha_rho(alpha: float, rho: float) -> float:
    """c(α,ρ) = (1+√ρ)/(1−√ρ) · α (paper §1.1 notation)."""
    return (1.0 + math.sqrt(rho)) / (1.0 - math.sqrt(rho)) * alpha
