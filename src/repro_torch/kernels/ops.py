"""Device-dispatching wrappers of the sketch kernels.

A CPU tensor takes the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel or raises. There is no fallback from the
kernel to the plain version. ``LAUNCHES`` counts kernel launches per
kernel: each wrapper adds one where it launches its kernel, and nowhere
else, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import torch

from .fwht import fwht_passes_cuda, fwht_ref
from .gaussian_gram import gaussian_sa_cuda, gaussian_sa_ref
from .precision import require_fp32

LAUNCHES = {"gaussian_sa": 0, "fwht": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no sketch kernel for device {t.device}")
    return False


def gaussian_sa(A: torch.Tensor, seeds: torch.Tensor, m: int, *,
                row_weights: torch.Tensor | None = None,
                compute_dtype: str | None = None) -> torch.Tensor:
    """Streamed Gaussian sketch S·W^{1/2}·A (B, m, d) without materializing
    S: A (n, d) shared or (B, n, d) per problem, seeds (B,) int64 holding
    uint32 values, optional row weights (B, n) (W = I when None)."""
    require_fp32(compute_dtype)
    scale = None if row_weights is None else torch.sqrt(
        row_weights.to(torch.float32))
    if not _on_cuda(A):
        return gaussian_sa_ref(A, seeds, m, scale=scale)
    out = gaussian_sa_cuda(A, seeds, m, scale=scale)
    LAUNCHES["gaussian_sa"] += 1
    return out


def fwht_cols(X: torch.Tensor, *, row_scale: torch.Tensor | None = None,
              batch: int | None = None,
              compute_dtype: str | None = None) -> torch.Tensor:
    """Unnormalized FWHT along axis -2 of a (B, n, d) stack (n a power of
    two), or of a shared (n, d) for ``batch`` problems; ``row_scale``
    (B, n) computes H·diag(s_b)·X_b per problem, fused into the kernel's
    first pass."""
    require_fp32(compute_dtype)
    if not _on_cuda(X):
        B = X.shape[0] if X.dim() == 3 else batch
        Xb = X.expand(B, *X.shape[-2:])
        if row_scale is not None:
            Xb = Xb * row_scale[:, :, None]
        return fwht_ref(Xb)
    out, launches = fwht_passes_cuda(X, row_scale, batch=batch)
    LAUNCHES["fwht"] += launches
    return out


def fwht(x: torch.Tensor, *, row_scale: torch.Tensor | None = None,
         compute_dtype: str | None = None) -> torch.Tensor:
    """Unnormalized FWHT along axis 0 of x (n, d); ``row_scale`` (n,)
    computes H·diag(s)·x."""
    scale = None if row_scale is None else row_scale[None]
    return fwht_cols(x[None], row_scale=scale, compute_dtype=compute_dtype)[0]
