"""Regularized GLM objectives for the sketched-Newton layer.

Port of ``repro.core.objectives``. Every objective is a separable per-row
loss plus the ridge term,

    F(x) = Σ_i ℓ(a_iᵀx, y_i) + ν²/2 · xᵀΛx ,

so the Newton system at x is a *weighted* instance of the quadratic:

    (AᵀW(x)A + ν²Λ) Δ = −∇F(x),   W(x) = diag(ℓ''(a_iᵀx, y_i)) ≥ 0 .

``GLMObjective`` packages the three per-row maps (value, ℓ', ℓ''); the
batched evaluations below derive everything from them with one margins
pass t = Ax each. Families:

* ``logistic`` — y ∈ {0, 1}; ℓ = logaddexp(0, t) − y·t, ℓ' = σ(t) − y,
  ℓ'' = σ(t)(1 − σ(t)).
* ``poisson``  — counts y ≥ 0, log link; ℓ = eᵗ − y·t, ℓ' = eᵗ − y,
  ℓ'' = eᵗ, with the margin clipped at ``POISSON_CLIP`` inside eᵗ.
* ``huber``    — residual r = t − y, threshold δ (``"huber:<δ>"``, default
  1): ℓ = r²/2 for |r| ≤ δ else δ|r| − δ²/2; ℓ' = clip(r, ±δ),
  ℓ'' = 1{|r| ≤ δ}.
* ``quadratic``— ℓ = (t − y)²/2: W ≡ 1, the ridge problem itself.

The formulas are the reference's, literally (``torch.logaddexp`` rather
than ``softplus``, whose threshold changes the arithmetic).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

POISSON_CLIP = 30.0     # e³⁰ ≈ 1e13: far beyond sane Poisson rates, finite


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    """Per-row maps of a separable GLM loss ℓ(t, y), t = aᵀx the margin.
    ``d2loss`` is the Newton weight w_i = ℓ''(t_i, y_i), the weighted
    quadratic's ``row_weights``."""

    name: str
    value: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    dloss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    d2loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _logistic_value(t, y):
    return torch.logaddexp(torch.zeros_like(t), t) - y * t


def _logistic_d2(t, y):
    s = torch.sigmoid(t)
    return s * (1.0 - s)


def _poisson_t(t):
    return torch.clamp(t, -POISSON_CLIP, POISSON_CLIP)


def _huber(delta: float) -> GLMObjective:
    def value(t, y):
        r = t - y
        a = torch.abs(r)
        return torch.where(a <= delta, 0.5 * r * r, delta * a - 0.5 * delta * delta)

    def dloss(t, y):
        return torch.clamp(t - y, -delta, delta)

    def d2loss(t, y):
        return (torch.abs(t - y) <= delta).to(t.dtype)

    return GLMObjective(name=f"huber[{delta:g}]", value=value, dloss=dloss,
                        d2loss=d2loss)


OBJECTIVES: dict[str, GLMObjective] = {
    "logistic": GLMObjective(
        name="logistic",
        value=_logistic_value,
        dloss=lambda t, y: torch.sigmoid(t) - y,
        d2loss=_logistic_d2,
    ),
    "poisson": GLMObjective(
        name="poisson",
        value=lambda t, y: torch.exp(_poisson_t(t)) - y * t,
        dloss=lambda t, y: torch.exp(_poisson_t(t)) - y,
        d2loss=lambda t, y: torch.exp(_poisson_t(t)),
    ),
    "huber": _huber(1.0),
    "quadratic": GLMObjective(
        name="quadratic",
        value=lambda t, y: 0.5 * (t - y) ** 2,
        dloss=lambda t, y: t - y,
        d2loss=lambda t, y: torch.ones_like(t),
    ),
}

GLM_FAMILIES = tuple(OBJECTIVES)


def get_objective(family: "GLMObjective | str") -> GLMObjective:
    """Resolve a family name ("huber:0.5" picks the δ); objective instances
    pass through unchanged."""
    if isinstance(family, GLMObjective):
        return family
    if family.startswith("huber:"):
        return _huber(float(family.split(":", 1)[1]))
    try:
        return OBJECTIVES[family]
    except KeyError:
        raise ValueError(
            f"GLM families are {GLM_FAMILIES} (or 'huber:<delta>'), "
            f"got {family!r}") from None


def margins(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """t = Ax, (…, B, n) for x (…, B, d): A (B, n, d) per problem or (n, d)
    shared. Leading axes of x broadcast (the line search's candidates)."""
    if A.dim() == 2:
        return x @ A.T
    return torch.matmul(A, x[..., None])[..., 0]


def glm_value(obj: GLMObjective, A, y, nu, lam_diag, x) -> torch.Tensor:
    """F(x) − Σ_i ℓ(0, y_i) per problem, (…, B): the loss measured relative
    to x = 0. The constant cancels from every comparison the optimizer
    makes, but subtracting it matters in fp32: all-zero padded rows add
    exactly 0 instead of n_pad·ℓ(0, 0), so the line search resolves the
    actual decrease rather than the ulps of an O(n) constant."""
    t = margins(A, x)
    loss = torch.sum(obj.value(t, y) - obj.value(torch.zeros_like(t), y), dim=-1)
    reg = 0.5 * (nu ** 2) * torch.sum(lam_diag * x * x, dim=-1)
    return loss + reg


def glm_grad_and_weights(obj: GLMObjective, A, y, nu, lam_diag, x):
    """(∇F(x), W(x)) in one margins pass: ∇F = Aᵀℓ'(t, y) + ν²Λx (B, d) and
    W = ℓ''(t, y) (B, n), the Newton system's ``row_weights``."""
    t = margins(A, x)
    g_row = obj.dloss(t, y)                                   # (B, n)
    if A.dim() == 2:
        g = g_row @ A
    else:
        g = torch.bmm(g_row[:, None, :], A)[:, 0, :]
    g = g + (nu ** 2)[:, None] * lam_diag * x
    return g, obj.d2loss(t, y)


def synthetic_logistic_problem(generator: torch.Generator, n: int, d: int, *,
                               scale: float = 1.0, dtype=torch.float32):
    """One synthetic logistic design on the generator's device: Gaussian
    A/√d and Bernoulli labels from planted coefficients (margins O(scale),
    so the Hessian weights vary across rows)."""
    dev = generator.device
    A = torch.randn((n, d), generator=generator, dtype=dtype, device=dev) / d ** 0.5
    coef = scale * torch.randn((d,), generator=generator, dtype=dtype, device=dev)
    p = torch.sigmoid(A @ coef)
    y = (torch.rand((n,), generator=generator, dtype=dtype, device=dev) < p).to(dtype)
    return A, y


def synthetic_logistic_batch(generator: torch.Generator, B: int, n: int, d: int, *,
                             scale: float = 1.0, dtype=torch.float32):
    """(A (B, n, d), y (B, n)) stacked from ``synthetic_logistic_problem``."""
    pairs = [synthetic_logistic_problem(generator, n, d, scale=scale, dtype=dtype)
             for _ in range(B)]
    return torch.stack([a for a, _ in pairs]), torch.stack([y for _, y in pairs])
