"""Shifted factorizations of the sketched-Gram ladder.

Port of ``repro.core.precond.shifted_ladder_inverses``: the (L, B, d, d)
level Grams (SA)ᵀ(SA) are λ-free, and ν²Λ enters only here, as a diagonal
shift added just before one flattened batched Cholesky and two triangular
solves.

``jnp.linalg.cholesky`` returns NaN for a matrix that is not positive
definite, while ``torch.linalg.cholesky`` raises. The engine's level guards
find bad levels through ``isfinite``, so the factors whose ``cholesky_ex``
reports ``info != 0`` are set to NaN before the inverse: the same
``LEVEL_INVALID`` behaviour as the reference.
"""

from __future__ import annotations

import torch


def shifted_ladder_inverses(grams: torch.Tensor, nu: torch.Tensor,
                            lam_diag: torch.Tensor) -> torch.Tensor:
    """(L, B, d, d) explicit inverses (G_l + ν²Λ)⁻¹ of a λ-free ladder of
    level Grams (L, B, d, d), per problem ν (B,) and Λ (B, d). A level that
    does not factorize comes back all NaN."""
    L, B, d, _ = grams.shape
    reg = (nu ** 2)[:, None] * lam_diag                      # (B, d)
    HS = (grams + torch.diag_embed(reg)[None]).reshape(L * B, d, d)
    chol, info = torch.linalg.cholesky_ex(HS)
    chol = torch.where((info != 0)[:, None, None], torch.nan, chol)
    eye = torch.eye(d, dtype=HS.dtype, device=HS.device).expand(L * B, d, d)
    y = torch.linalg.solve_triangular(chol, eye, upper=False)
    pinv = torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)
    return pinv.reshape(L, B, d, d)
