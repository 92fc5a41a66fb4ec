"""Factorizations of the sketched Hessian H_S = (SA)ᵀ(SA) + ν²Λ.

Port of ``repro.core.precond``. Two regimes, as in the paper (§4.1.1):

* m ≥ d (primal): form H_S ∈ R^{d×d}, Cholesky in O(d³); solves O(d²).
* m < d (dual / Woodbury): form W_S = SAΛ⁻¹(SA)ᵀ + ν²I_m ∈ R^{m×m},
  Cholesky in O(m³); solves O(md) via
      v = Λ⁻¹/ν² · (I_d − (SA)ᵀ W_S⁻¹ SA Λ⁻¹) z .

``factorize`` takes SA (m, d) or a batch (B, m, d); ``factorize_shared``
factorizes one SA against B regularizers with the Gram formed once; and
``shifted_ladder_inverses`` gives the padded engine the explicit inverses
(G_l + ν²Λ)⁻¹ of a λ-free ladder of level Grams, ν²Λ entering only here.

``jnp.linalg.cholesky`` returns NaN for a matrix that is not positive
definite, while ``torch.linalg.cholesky`` raises. The engine's level guards
find bad levels through ``isfinite``, so every factor whose ``cholesky_ex``
reports ``info != 0`` is set to NaN (``_cholesky``): the same
``LEVEL_INVALID`` behaviour, and the same NaN solves, as the reference.
"""

from __future__ import annotations

import dataclasses

import torch


def _cholesky(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of H (batched over leading axes); a matrix
    that is not positive definite gets an all-NaN factor."""
    chol, info = torch.linalg.cholesky_ex(H)
    return torch.where((info != 0)[..., None, None], torch.nan, chol)


def _chol_solve(chol: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Lower-Cholesky solve; batches over leading axes."""
    y = torch.linalg.solve_triangular(chol, z, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)


@dataclasses.dataclass
class SketchedPrecond:
    """Cached factorization of H_S; solves H_S v = z in O(min(m, d)·d)."""

    mode: str                     # "primal" | "dual"
    chol: torch.Tensor            # (d, d) or (m, m) lower Cholesky; (B, ·, ·) batched
    SA: torch.Tensor | None       # (m, d) or (B, m, d), kept only in dual mode
    nu2: torch.Tensor             # scalar ν²; (B,) batched
    lam_diag: torch.Tensor        # (d,) diagonal of Λ; (B, d) batched
    batched: bool = False         # leading problem axis on chol/ν²/Λ

    def solve(self, z: torch.Tensor) -> torch.Tensor:
        """Solve H_S v = z for a vector (d,) or matrix (d, c) RHS; with
        ``batched`` z carries the problem axis: (B, d)."""
        if self.batched:
            return self._solve_batched(z)
        squeeze = z.dim() == 1
        if squeeze:
            z = z[:, None]
        if self.mode == "primal":
            v = _chol_solve(self.chol, z)
        else:
            SA = self.SA
            lam_inv = 1.0 / self.lam_diag
            zi = lam_inv[:, None] * z                      # Λ⁻¹ z
            w = _chol_solve(self.chol, SA @ zi)            # W_S⁻¹ SA Λ⁻¹ z
            v = (zi - lam_inv[:, None] * (SA.T @ w)) / self.nu2
        return v[:, 0] if squeeze else v

    def _solve_batched(self, z: torch.Tensor) -> torch.Tensor:
        if self.mode == "primal":
            return _chol_solve(self.chol, z[..., None])[..., 0]
        SA = self.SA
        lam_inv = 1.0 / self.lam_diag                      # (B, d)
        zi = lam_inv * z                                   # Λ⁻¹ z, (B, d)
        if SA.dim() == 2:                                  # shared sketch
            w = _chol_solve(self.chol, (zi @ SA.T)[..., None])[..., 0]
            back = w @ SA
        else:
            SAzi = torch.bmm(SA, zi[:, :, None])
            w = _chol_solve(self.chol, SAzi)               # (B, m, 1)
            back = torch.bmm(SA.transpose(1, 2), w)[..., 0]
        return (zi - lam_inv * back) / self.nu2[:, None]


def factorize(SA: torch.Tensor, nu, lam_diag: torch.Tensor, *,
              jitter: float = 0.0) -> SketchedPrecond:
    """Factorize H_S given the sketched matrix SA ∈ R^{m×d}, or a batch
    SA ∈ R^{B×m×d} (ν, Λ broadcast or per problem)."""
    if SA.dim() == 3:
        return _factorize_batched(SA, nu, lam_diag, jitter=jitter)
    m, d = SA.shape
    nu2 = torch.as_tensor(nu, dtype=SA.dtype, device=SA.device) ** 2
    if m >= d:
        H_S = SA.T @ SA + torch.diag(nu2 * lam_diag)
        if jitter:
            H_S = H_S + jitter * torch.eye(d, dtype=SA.dtype, device=SA.device)
        return SketchedPrecond(mode="primal", chol=_cholesky(H_S), SA=None,
                               nu2=nu2, lam_diag=lam_diag)
    eye = torch.eye(m, dtype=SA.dtype, device=SA.device)
    lam_inv = 1.0 / lam_diag
    W_S = (SA * lam_inv[None, :]) @ SA.T + nu2 * eye
    if jitter:
        W_S = W_S + jitter * eye
    return SketchedPrecond(mode="dual", chol=_cholesky(W_S), SA=SA, nu2=nu2,
                           lam_diag=lam_diag)


def _factorize_batched(SA: torch.Tensor, nu, lam_diag, *,
                       jitter: float = 0.0) -> SketchedPrecond:
    B, m, d = SA.shape
    nu2 = torch.as_tensor(nu, dtype=SA.dtype, device=SA.device).reshape(-1).expand(B) ** 2
    lam_diag = torch.as_tensor(lam_diag, dtype=SA.dtype, device=SA.device).expand(B, d)
    if m >= d:
        H_S = torch.bmm(SA.transpose(1, 2), SA) + torch.diag_embed(nu2[:, None] * lam_diag)
        if jitter:
            H_S = H_S + jitter * torch.eye(d, dtype=SA.dtype, device=SA.device)
        return SketchedPrecond(mode="primal", chol=_cholesky(H_S), SA=None,
                               nu2=nu2, lam_diag=lam_diag, batched=True)
    eye = torch.eye(m, dtype=SA.dtype, device=SA.device)
    lam_inv = 1.0 / lam_diag
    W_S = torch.bmm(SA * lam_inv[:, None, :], SA.transpose(1, 2)) + nu2[:, None, None] * eye
    if jitter:
        W_S = W_S + jitter * eye
    return SketchedPrecond(mode="dual", chol=_cholesky(W_S), SA=SA, nu2=nu2,
                           lam_diag=lam_diag, batched=True)


def factorize_shared(SA: torch.Tensor, nu: torch.Tensor, lam_diag: torch.Tensor, *,
                     jitter: float = 0.0) -> SketchedPrecond:
    """λ-batch fast path: ONE sketched matrix SA (m, d) factorized against
    a batch of regularizers ν (B,), Λ (d,) shared or (B, d).

    The Gram SAᵀSA (primal) is formed once; only the B diagonal shifts and
    Choleskys are batched. In the dual (m < d) regime SAΛ⁻¹SAᵀ is shared
    only when Λ is; a per-problem Λ gets a batched Gram."""
    m, d = SA.shape
    nu2 = torch.as_tensor(nu, dtype=SA.dtype, device=SA.device).reshape(-1) ** 2
    B = nu2.shape[0]
    lam_diag = torch.as_tensor(lam_diag, dtype=SA.dtype, device=SA.device)
    lam_shared = lam_diag.dim() == 1
    lam_diag = lam_diag.expand(B, d)
    if m >= d:
        H_S = (SA.T @ SA)[None] + torch.diag_embed(nu2[:, None] * lam_diag)
        if jitter:
            H_S = H_S + jitter * torch.eye(d, dtype=SA.dtype, device=SA.device)
        return SketchedPrecond(mode="primal", chol=_cholesky(H_S), SA=None,
                               nu2=nu2, lam_diag=lam_diag, batched=True)
    eye = torch.eye(m, dtype=SA.dtype, device=SA.device)
    if lam_shared:
        K = ((SA * (1.0 / lam_diag[0])[None, :]) @ SA.T)[None]   # once, shared
    else:
        K = torch.einsum("md,bd,nd->bmn", SA, 1.0 / lam_diag, SA)
    W_S = K + nu2[:, None, None] * eye
    if jitter:
        W_S = W_S + jitter * eye
    return SketchedPrecond(mode="dual", chol=_cholesky(W_S), SA=SA, nu2=nu2,
                           lam_diag=lam_diag, batched=True)


def shifted_ladder_inverses(grams: torch.Tensor, nu: torch.Tensor,
                            lam_diag: torch.Tensor) -> torch.Tensor:
    """(L, B, d, d) explicit inverses (G_l + ν²Λ)⁻¹ of a λ-free ladder of
    level Grams (L, B, d, d), per problem ν (B,) and Λ (B, d). A level that
    does not factorize comes back all NaN."""
    L, B, d, _ = grams.shape
    reg = (nu ** 2)[:, None] * lam_diag                      # (B, d)
    HS = (grams + torch.diag_embed(reg)[None]).reshape(L * B, d, d)
    eye = torch.eye(d, dtype=HS.dtype, device=HS.device).expand(L * B, d, d)
    return _chol_solve(_cholesky(HS), eye).reshape(L, B, d, d)


def factorization_cost_flops(m: int, n: int, d: int) -> float:
    """Flops to form + factorize H_S (paper §4.1.1), excluding the sketch."""
    if m >= d:
        return 2.0 * m * d * d + d ** 3 / 3.0
    return 2.0 * m * m * d + m ** 3 / 3.0
