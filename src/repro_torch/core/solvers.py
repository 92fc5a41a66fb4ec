"""Preconditioned first-order methods (paper §1, §3).

Port of ``repro.core.solvers``. Every method is an instance of
Definition 2.3,  x_{t+1} ∈ x_0 + H_S⁻¹ · span{∇f(x_0), …, ∇f(x_t)}:

* IHS        — x⁺ = x − μ H_S⁻¹ ∇f(x), μ = 1−ρ (Thm 3.2);
* PCG        — optimal (Thm 3.3);
* Polyak-IHS — heavy-ball (Appendix A);
* CG         — the unpreconditioned baseline.

Each is an immutable state plus a ``step``, and ``run_fixed`` runs one for
a fixed number of steps under a fixed preconditioner (a Python loop of
device operations). Every step also gives the approximate Newton
decrement δ̃ = ½ ∇fᵀ H_S⁻¹ ∇f (eq. 2.3). With a batched ``Quadratic`` every
state field carries the problem axis and δ̃ and step sizes are (B,).

The rate constants of Condition 2.4 (``rho_to_rate``, ``c_alpha_rho``) are
what the padded engine reads.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .precond import SketchedPrecond
from .quadratic import Quadratic, pdot, pscale


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


def _safe_div(num, den):
    """num / den where den > 0, else 0 (per problem)."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


class IHSState(NamedTuple):
    x: torch.Tensor
    grad: torch.Tensor
    delta_tilde: torch.Tensor   # δ̃ at x: scalar, or (B,) batched


def ihs_init(q: Quadratic, P: SketchedPrecond, x0: torch.Tensor) -> IHSState:
    g = q.grad(x0)
    return IHSState(x=x0, grad=g, delta_tilde=0.5 * pdot(g, P.solve(g), q.batched))


def ihs_step(q: Quadratic, P: SketchedPrecond, st: IHSState, rho: float) -> IHSState:
    x = st.x - (1.0 - rho) * P.solve(st.grad)
    g = q.grad(x)
    return IHSState(x=x, grad=g, delta_tilde=0.5 * pdot(g, P.solve(g), q.batched))


class PolyakState(NamedTuple):
    x: torch.Tensor
    x_prev: torch.Tensor
    grad: torch.Tensor
    delta_tilde: torch.Tensor


def polyak_init(q: Quadratic, P: SketchedPrecond, x0: torch.Tensor) -> PolyakState:
    g = q.grad(x0)
    return PolyakState(x=x0, x_prev=x0, grad=g,
                       delta_tilde=0.5 * pdot(g, P.solve(g), q.batched))


def polyak_step(q: Quadratic, P: SketchedPrecond, st: PolyakState,
                rho: float) -> PolyakState:
    """μ_ρ = 2(1−ρ)/(1+√(1−ρ)), β_ρ = (1−√(1−ρ))/(1+√(1−ρ))."""
    sq = math.sqrt(1.0 - rho)
    mu = 2.0 * (1.0 - rho) / (1.0 + sq)
    beta = (1.0 - sq) / (1.0 + sq)
    x = st.x - mu * P.solve(st.grad) + beta * (st.x - st.x_prev)
    g = q.grad(x)
    return PolyakState(x=x, x_prev=st.x, grad=g,
                       delta_tilde=0.5 * pdot(g, P.solve(g), q.batched))


class PCGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor             # residual b − Hx (= −∇f)
    r_tilde: torch.Tensor       # H_S⁻¹ r
    p: torch.Tensor             # search direction
    delta_tilde: torch.Tensor   # ½ rᵀ r̃


def pcg_init(q: Quadratic, P: SketchedPrecond, x0: torch.Tensor) -> PCGState:
    r = q.b - q.hvp(x0)
    rt = P.solve(r)
    return PCGState(x=x0, r=r, r_tilde=rt, p=rt, delta_tilde=0.5 * pdot(r, rt, q.batched))


def pcg_step(q: Quadratic, P: SketchedPrecond, st: PCGState, rho: float = 0.0) -> PCGState:
    bt = q.batched
    Hp = q.hvp(st.p)
    # at exact convergence p → 0: keep α finite, per problem
    alpha = _safe_div(2.0 * st.delta_tilde, pdot(st.p, Hp, bt))
    x = st.x + pscale(alpha, bt) * st.p
    r = st.r - pscale(alpha, bt) * Hp
    rt = P.solve(r)
    dt_new = 0.5 * pdot(r, rt, bt)
    beta = _safe_div(dt_new, st.delta_tilde)
    return PCGState(x=x, r=r, r_tilde=rt, p=rt + pscale(beta, bt) * st.p,
                    delta_tilde=dt_new)


def cg_solve(q: Quadratic, x0: torch.Tensor, iters: int, tol: float = 0.0):
    """Plain CG on Hx = b; returns (x, the ‖r‖² trace (iters,) or (iters, B)).

    A problem stops moving once its recursive ‖r‖² falls to eps²·‖r₀‖² (eps
    of its dtype), and its trace repeats that value: the residual is then
    below what the dtype resolves of the first, and the steps after it are
    rounding. In fp32 they are worse than that. The squares of r's entries
    leave the normal range and underflow, so β = ‖r_new‖²/‖r‖² becomes a
    ratio of truncated sums and ‖r‖² climbs again by up to 40 orders of
    magnitude. The reference has no such stop, and its recursive ‖r‖²
    climbs too (from 5e-37 to 2e-8 on the quickstart's small problem)."""
    bt = q.batched
    r = q.b - q.hvp(x0)
    x, p, rs = x0, r, pdot(r, r, bt)
    floor = torch.finfo(rs.dtype).eps ** 2 * rs
    live = rs > floor
    trace = []
    for _ in range(iters):
        Hp = q.hvp(p)
        alpha = torch.where(live, _safe_div(rs, pdot(p, Hp, bt)), 0.0)
        x = x + pscale(alpha, bt) * p
        r = r - pscale(alpha, bt) * Hp
        rs_new = pdot(r, r, bt)
        live = live & (rs_new > floor)
        p = r + pscale(torch.where(live, _safe_div(rs_new, rs), 0.0), bt) * p
        rs = rs_new
        trace.append(rs_new)
    return x, torch.stack(trace)


METHODS = {
    "ihs": (ihs_init, ihs_step),
    "pcg": (pcg_init, pcg_step),
    "polyak": (polyak_init, polyak_step),
}


def run_fixed(q: Quadratic, P: SketchedPrecond, x0: torch.Tensor, *,
              method: str = "pcg", iters: int = 20, rho: float = 1.0 / 8.0):
    """Run ``iters`` steps under a fixed preconditioner; returns (x, the δ̃
    trace (iters,) or (iters, B))."""
    init_fn, step_fn = METHODS[method]
    st = init_fn(q, P, x0)
    trace = []
    for _ in range(iters):
        st = step_fn(q, P, st, rho)
        trace.append(st.delta_tilde)
    return st.x, torch.stack(trace)


def newton_solve(J: torch.Tensor, grad: torch.Tensor, nu: float, *, method: str = "pcg",
                 sketch: str = "sjlt", max_iters: int = 100, tol: float = 1e-10,
                 seed=0, sampler=None, device=None):
    """Solve the damped Gauss-Newton system (JᵀJ + ν²I) δ = −grad with the
    adaptive sketching solver (``core.adaptive``). J is the (n, d) residual
    Jacobian or Gauss-Newton factor on ``device`` (default cuda); returns
    (δ, the ``AdaptiveResult``). ``seed`` and ``sampler`` go to
    ``adaptive_solve``."""
    from .adaptive import AdaptiveConfig, adaptive_solve

    d = J.shape[1]
    q = Quadratic(A=J, b=-grad, nu=torch.as_tensor(nu, dtype=J.dtype, device=J.device),
                  lam_diag=torch.ones((d,), dtype=J.dtype, device=J.device))
    res = adaptive_solve(q, AdaptiveConfig(method=method, sketch=sketch,
                                           max_iters=max_iters, tol=tol),
                         seed=seed, sampler=sampler, device=device)
    return res.x, res
