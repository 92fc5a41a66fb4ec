"""Problem container for  min_x ½⟨x, Hx⟩ − bᵀx,  H = AᵀWA + ν²Λ.

Port of ``repro.core.quadratic``. ``Quadratic`` is matrix-free: it exposes
Hv, ∇f, f and the error δ_x, for a vector b (d,) or a matrix right-hand
side (d, c). Row weights w ≥ 0 (``row_weights``, (n,) single or (B, n)
batched, per problem even with shared A) turn the Gram into AᵀWA; ``hvp``
applies them on the (·, n) intermediate, never forming W^{1/2}A.

A batched problem (``batched=True``) holds B independent problems:

* per-problem data:  A (B, n, d), b (B, d), ν (B,), Λ (B, d);
* shared A:          A (n, d), b (B, d), ν (B,), Λ (B, d).

Scalar reductions (value, error) return (B,) in batched mode. The padded
engine and the service take batched problems only.
"""

from __future__ import annotations

import dataclasses

import torch

from .precond import _chol_solve, _cholesky


def pdot(a: torch.Tensor, b: torch.Tensor, batched: bool) -> torch.Tensor:
    """⟨a, b⟩ summed over all axes, except the leading problem axis when
    ``batched`` (then (B,))."""
    if batched:
        return torch.sum(a * b, dim=tuple(range(1, a.dim())))
    return torch.sum(a * b)


def pscale(c: torch.Tensor, batched: bool) -> torch.Tensor:
    """A per-problem scalar (B,) broadcast against (B, d) state."""
    return c[..., None] if batched else c


@dataclasses.dataclass
class Quadratic:
    A: torch.Tensor           # (n, d); (B, n, d) or shared (n, d) when batched
    b: torch.Tensor           # (d,) or (d, c); (B, d) when batched
    nu: torch.Tensor          # scalar ν; (B,) when batched
    lam_diag: torch.Tensor    # (d,) diagonal of Λ ⪰ I; (B, d) when batched
    batched: bool = False     # leading problem axis on b/ν/Λ (and A unless shared)
    row_weights: torch.Tensor | None = None   # W = diag(w): (n,); (B, n) batched

    @property
    def shared_A(self) -> bool:
        return self.batched and self.A.dim() == 2

    @property
    def n(self) -> int:
        return self.A.shape[-2]

    @property
    def d(self) -> int:
        return self.A.shape[-1]

    @property
    def batch(self) -> int:
        if not self.batched:
            raise ValueError("not a batched problem")
        return self.b.shape[0]

    @property
    def device(self) -> torch.device:
        return self.A.device

    def _reg(self, v: torch.Tensor) -> torch.Tensor:
        """ν²Λ v with the layout's broadcast."""
        if self.batched:
            return (self.nu ** 2)[:, None] * self.lam_diag * v
        if v.dim() == 1:
            return self.nu ** 2 * self.lam_diag * v
        return self.nu ** 2 * self.lam_diag[:, None] * v

    def gram_vp(self, v: torch.Tensor) -> torch.Tensor:
        """AᵀWA v in O(nd) per problem: the data part of H v, and the part a
        row-sharded problem all-reduces (``core.distributed``). Never forms
        AᵀWA or W^{1/2}A: the weight lands on the (·, n) intermediate."""
        w = self.row_weights
        if not self.batched:
            Av = self.A @ v
            if w is not None:
                Av = (w[:, None] if Av.dim() == 2 else w) * Av
            return self.A.T @ Av
        if self.shared_A:
            Av = v @ self.A.T                                  # (B, n)
            if w is not None:
                Av = w * Av
            return Av @ self.A                                 # (B, d)
        Av = torch.bmm(self.A, v[:, :, None])[:, :, 0]         # (B, n)
        if w is not None:
            Av = w * Av
        return torch.bmm(Av[:, None, :], self.A)[:, 0, :]      # (B, d)

    def hvp(self, v: torch.Tensor) -> torch.Tensor:
        """H v = AᵀWA v + ν²Λ v in O(nd) per problem."""
        return self.gram_vp(v) + self._reg(v)

    def grad(self, x: torch.Tensor) -> torch.Tensor:
        return self.hvp(x) - self.b

    def value(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * pdot(x, self.hvp(x), self.batched) - pdot(self.b, x, self.batched)

    def error(self, x: torch.Tensor, x_star: torch.Tensor) -> torch.Tensor:
        """δ_x = ½‖x − x*‖²_H (summed over columns for a matrix RHS; per
        problem when batched)."""
        dx = x - x_star
        return 0.5 * pdot(dx, self.hvp(dx), self.batched)

    def problem(self, i: int) -> "Quadratic":
        """Problem i of a batched Quadratic, as a single problem."""
        if not self.batched:
            raise ValueError("not a batched problem")
        return Quadratic(
            A=self.A if self.shared_A else self.A[i], b=self.b[i], nu=self.nu[i],
            lam_diag=self.lam_diag[i],
            row_weights=None if self.row_weights is None else self.row_weights[i])

    def with_row_weights(self, w: torch.Tensor | None) -> "Quadratic":
        """The same problem under the weighted Gram AᵀWA: ``w`` is (n,)
        single or (B, n) batched, per problem even when A is shared."""
        if w is not None:
            w = torch.as_tensor(w, dtype=self.A.dtype, device=self.A.device)
            want = (self.batch, self.n) if self.batched else (self.n,)
            if tuple(w.shape) != want:
                raise ValueError(f"row_weights shape {tuple(w.shape)} != expected {want}")
        return dataclasses.replace(self, row_weights=w)


def _as_batched_reg(nu, lam_diag, B: int, d: int, dtype, device):
    """ν as (B,) and Λ as (B, d), so batched ops are uniform."""
    nu = torch.as_tensor(nu, dtype=dtype, device=device).reshape(-1)
    nu = nu.expand(B).clone()
    if lam_diag is None:
        lam_diag = torch.ones((d,), dtype=dtype, device=device)
    lam_diag = torch.as_tensor(lam_diag, dtype=dtype, device=device)
    return nu, lam_diag.expand(B, d).clone()


def from_least_squares(A: torch.Tensor, y: torch.Tensor, nu, lam_diag=None) -> Quadratic:
    """Ridge regression  min ½‖Ax − y‖² + ν²/2 ‖Λ^{1/2}x‖²  as one problem;
    y (n,) or (n, c)."""
    if lam_diag is None:
        lam_diag = torch.ones((A.shape[1],), dtype=A.dtype, device=A.device)
    return Quadratic(A=A, b=A.T @ y, nu=torch.as_tensor(nu, dtype=A.dtype, device=A.device),
                     lam_diag=lam_diag)


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
    return Quadratic(A=A, b=b, nu=nu, lam_diag=lam_diag, batched=True)


def lambda_sweep(A: torch.Tensor, y: torch.Tensor, nus, lam_diag=None) -> Quadratic:
    """Shared-A regularization-path batch: one (A, y), B values of ν. A is
    shared, so Gram-forming consumers (``direct_solve``,
    ``precond.factorize_shared``) pay the O(nd²) once."""
    nus = torch.as_tensor(nus, dtype=A.dtype, device=A.device)
    B, d = nus.shape[0], A.shape[1]
    b = (A.T @ y)[None, :].expand(B, d).clone()
    nu, lam_diag = _as_batched_reg(nus, lam_diag, B, d, A.dtype, A.device)
    return Quadratic(A=A, b=b, nu=nu, lam_diag=lam_diag, batched=True)


def stack_quadratics(qs: list[Quadratic]) -> Quadratic:
    """Stack same-shape single problems along a new problem axis. Row
    weights stack too: all problems weighted or none (a mix has no
    faithful batched form and must not drop weights silently)."""
    if any(q.batched for q in qs):
        raise ValueError("stack_quadratics takes single problems")
    n_weighted = sum(q.row_weights is not None for q in qs)
    if n_weighted not in (0, len(qs)):
        raise ValueError(f"cannot stack {n_weighted} weighted with "
                         f"{len(qs) - n_weighted} unweighted problems")
    return Quadratic(
        A=torch.stack([q.A for q in qs]), b=torch.stack([q.b for q in qs]),
        nu=torch.stack([torch.as_tensor(q.nu) for q in qs]),
        lam_diag=torch.stack([q.lam_diag for q in qs]), batched=True,
        row_weights=torch.stack([q.row_weights for q in qs]) if n_weighted else None)


def weighted_gram(A: torch.Tensor, w: torch.Tensor, *, chunk: int = 1024) -> torch.Tensor:
    """AᵀWA as (B, d, d) by a loop over n-chunks whose only weighted
    intermediate is the (B, chunk, d) tile: never an (n, d)-sized weighted
    copy of A. A is (B, n, d) per problem or (n, d) shared; w is (B, n)."""
    n, d = A.shape[-2], A.shape[-1]
    acc = torch.zeros((w.shape[0], d, d), dtype=A.dtype, device=A.device)
    for r0 in range(0, n, chunk):
        a_c = A[..., r0:r0 + chunk, :]                   # (chunk, d) or (B, chunk, d)
        aw = w[:, r0:r0 + chunk, None] * a_c             # (B, chunk, d)
        acc = acc + torch.matmul(aw.transpose(1, 2), a_c)
    return acc


def direct_solve(q: Quadratic, *, reduce=None) -> torch.Tensor:
    """Baseline: dense Cholesky factor-and-solve, O(nd²+d³), in q's dtype.
    Batched problems get a batched Cholesky; with shared A and no weights
    the Gram is formed once. A problem whose H is not positive definite
    gets a NaN solution, as the reference's Cholesky gives. ``reduce`` maps
    the local Gram to the global one (a row-sharded q's all-reduce)."""
    w = q.row_weights
    reduce = reduce or (lambda G: G)
    if not q.batched:
        Aw = q.A if w is None else q.A * w[:, None]
        H = reduce(Aw.T @ q.A) + torch.diag(q.nu ** 2 * q.lam_diag)
        chol = _cholesky(H)
        if q.b.dim() == 1:
            return _chol_solve(chol, q.b[:, None])[:, 0]
        return _chol_solve(chol, q.b)
    if q.shared_A and w is None:
        G = (q.A.T @ q.A)[None]                          # (1, d, d) once
    elif q.shared_A:
        G = torch.einsum("bn,nd,ne->bde", w, q.A, q.A)
    elif w is None:
        G = torch.bmm(q.A.transpose(1, 2), q.A)
    else:
        G = torch.bmm(q.A.transpose(1, 2), w[:, :, None] * q.A)
    H = reduce(G) + torch.diag_embed((q.nu ** 2)[:, None] * q.lam_diag)
    return _chol_solve(_cholesky(H), q.b[:, :, None])[:, :, 0]
