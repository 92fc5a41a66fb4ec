"""The plain reference of a ridge solve, and its control in TF32.

    min_x ½‖Ax − y‖² + ν²/2·‖x‖²,   x* = (AᵀA + ν²I)⁻¹ Aᵀy

``solve`` works x* out in float64 from A, y and ν alone: the Gram, one
Cholesky, two triangular solves, plain ``torch``. It imports nothing of the
program and takes nothing the program made. ``h_norm_errors`` judges
answers by the relative error in the energy norm ‖e‖_H / ‖x*‖_H, H the
float64 AᵀA + ν²I, the norm that the solvers' δ̃ certificates bound, and
``backward_errors`` by their normwise backward error ‖b − Hx‖ / (‖H‖_F‖x‖
+ ‖b‖), b = Aᵀy, which a solver that is stable in float32 keeps near
float32's rounding unit whatever the conditioning of H.

``solve_tf32`` is the control: the same solve, computed in the precision
just below the float32 the configurations state, TF32 (the tensor cores'
format: every operand of a product rounded to 10 bits of mantissa, the sums
in float32). It rounds the operands itself, so it computes the same on the
CPU and on the card.
"""

from __future__ import annotations

import torch


def _gram(A: torch.Tensor, nu: float) -> torch.Tensor:
    H = A.T @ A
    H.diagonal().add_(nu * nu)
    return H


def solve(A: torch.Tensor, Y: torch.Tensor, nu: float
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x*, H, b = AᵀY) in float64 for every column of Y (n,) or (n, k)."""
    A64 = A.double()
    H = _gram(A64, nu)
    L = torch.linalg.cholesky(H)
    rhs = A64.T @ Y.double()
    x = torch.cholesky_solve(rhs.reshape(rhs.shape[0], -1), L)
    return x.reshape(rhs.shape), H, rhs


def h_norm_errors(H: torch.Tensor, x_star: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """‖x − x*‖_H / ‖x*‖_H for each row x of X (k, d), float64."""
    E = X.double() - x_star[None, :]
    num = ((E @ H) * E).sum(dim=1)
    den = x_star @ H @ x_star
    return torch.sqrt(num / den)


def backward_errors(H: torch.Tensor, b: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """‖b − Hx‖ / (‖H‖_F‖x‖ + ‖b‖) for each row x of X (k, d), float64."""
    X = X.double()
    R = b[None, :] - X @ H
    return R.norm(dim=1) / (torch.linalg.matrix_norm(H) * X.norm(dim=1) + b.norm())


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest, ties
    to even."""
    bits = t.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    return ((bits + 0xFFF + keep) & ~0x1FFF).view(torch.float32)


def solve_tf32(A: torch.Tensor, Y: torch.Tensor, nu: float) -> torch.Tensor:
    """The control: ``solve`` in TF32 products and float32 otherwise."""
    A32 = tf32_round(A.float())
    H = _gram(A32, nu)
    L = torch.linalg.cholesky(H)
    rhs = A32.T @ tf32_round(Y.float())
    x = torch.cholesky_solve(rhs.reshape(rhs.shape[0], -1), L)
    return x.reshape(rhs.shape)
