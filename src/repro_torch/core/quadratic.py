"""Batched problem container for  min_x ½⟨x, Hx⟩ − bᵀx,  H = AᵀWA + ν²Λ.

Port of ``repro.core.quadratic`` for its batched layout (the one the padded
engine and the service use): B independent problems with

* per-problem data:  A (B, n, d), b (B, d), ν (B,), Λ (B, d);
* shared A:          A (n, d), b (B, d), ν (B,), Λ (B, d).

``row_weights`` w (B, n) turns the Gram into AᵀWA; ``hvp`` applies it on the
(B, n) intermediate, and ``direct_solve`` forms the weighted Gram. The
engine of this slice takes unweighted problems only.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Quadratic:
    A: torch.Tensor           # (B, n, d) per problem, or (n, d) shared
    b: torch.Tensor           # (B, d)
    nu: torch.Tensor          # (B,)
    lam_diag: torch.Tensor    # (B, d) diagonal of Λ ⪰ I
    row_weights: torch.Tensor | None = None   # (B, n), W = diag(w)

    @property
    def shared_A(self) -> bool:
        return self.A.dim() == 2

    @property
    def n(self) -> int:
        return self.A.shape[-2]

    @property
    def d(self) -> int:
        return self.A.shape[-1]

    @property
    def batch(self) -> int:
        return self.b.shape[0]

    @property
    def device(self) -> torch.device:
        return self.A.device

    def _reg(self, v: torch.Tensor) -> torch.Tensor:
        """ν²Λ v, per problem."""
        return (self.nu ** 2)[:, None] * self.lam_diag * v

    def hvp(self, v: torch.Tensor) -> torch.Tensor:
        """H v = AᵀWA v + ν²Λ v for v (B, d), in O(nd) per problem (never
        forms H or W^{1/2}A: the weight lands on the (B, n) intermediate)."""
        w = self.row_weights
        if self.shared_A:
            Av = v @ self.A.T                                  # (B, n)
            if w is not None:
                Av = w * Av
            AtAv = Av @ self.A                                 # (B, d)
        else:
            Av = torch.bmm(self.A, v[:, :, None])[:, :, 0]     # (B, n)
            if w is not None:
                Av = w * Av
            AtAv = torch.bmm(Av[:, None, :], self.A)[:, 0, :]  # (B, d)
        return AtAv + self._reg(v)

    def grad(self, x: torch.Tensor) -> torch.Tensor:
        return self.hvp(x) - self.b


def _as_batched_reg(nu, lam_diag, B: int, d: int, dtype, device):
    """ν as (B,) and Λ as (B, d), so batched ops are uniform."""
    nu = torch.as_tensor(nu, dtype=dtype, device=device).reshape(-1)
    nu = nu.expand(B).clone()
    if lam_diag is None:
        lam_diag = torch.ones((d,), dtype=dtype, device=device)
    lam_diag = torch.as_tensor(lam_diag, dtype=dtype, device=device)
    return nu, lam_diag.expand(B, d).clone()


def from_least_squares_batch(A: torch.Tensor, Y: torch.Tensor, nu,
                             lam_diag=None) -> Quadratic:
    """Batched ridge  min ½‖A_b x − y_b‖² + ν_b²/2 ‖Λ_b^{1/2}x‖²:
    A (B, n, d) per problem or (n, d) shared; Y (B, n); ν scalar or (B,);
    Λ (d,) or (B, d)."""
    B, d = Y.shape[0], A.shape[-1]
    if A.dim() == 2:
        b = Y @ A                                        # (B, d)
    else:
        b = torch.bmm(Y[:, None, :], A)[:, 0, :]
    nu, lam_diag = _as_batched_reg(nu, lam_diag, B, d, A.dtype, A.device)
    return Quadratic(A=A, b=b, nu=nu, lam_diag=lam_diag)


def _chol_solve(chol: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Lower-Cholesky solve; batches over leading axes."""
    y = torch.linalg.solve_triangular(chol, z, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)


def direct_solve(q: Quadratic) -> torch.Tensor:
    """Baseline: dense Cholesky factor-and-solve per problem, O(nd²+d³),
    in q's dtype. With shared A and no weights the Gram is formed once. A
    problem whose H is not positive definite gets a NaN solution, as the
    reference's Cholesky gives."""
    w = q.row_weights
    if q.shared_A and w is None:
        G = (q.A.T @ q.A)[None]                          # (1, d, d) once
    elif q.shared_A:
        G = torch.einsum("bn,nd,ne->bde", w, q.A, q.A)
    elif w is None:
        G = torch.bmm(q.A.transpose(1, 2), q.A)
    else:
        G = torch.bmm(q.A.transpose(1, 2), w[:, :, None] * q.A)
    H = G + torch.diag_embed((q.nu ** 2)[:, None] * q.lam_diag)
    chol, info = torch.linalg.cholesky_ex(H)
    chol = torch.where((info != 0)[:, None, None], torch.nan, chol)
    return _chol_solve(chol, q.b[:, :, None])[:, :, 0]
