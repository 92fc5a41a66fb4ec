"""Device-dispatching wrappers of the sketch kernels.

A CPU tensor takes the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel or raises. There is no fallback from the
kernel to the plain version. ``LAUNCHES`` counts kernel launches per kernel
and compute-dtype leg (``"sjlt"`` is the fp32 leg, ``"sjlt.bf16"`` and
``"sjlt.int8"`` the others): each wrapper adds one where it launches its
kernel, and nowhere else, so a run can show that its main path went through
every kernel leg it should have. The FWHT counts each launch of its plan; the
SJLT counts one per sketch pass, whatever the launches inside it (its bucket
pass and segment sum: ``sjlt.sjlt_launch``).
"""

from __future__ import annotations

import torch

from .fwht import fwht_passes_cuda, fwht_passes_ref
from .gaussian_gram import gaussian_sa_cuda, gaussian_sa_ref, resolve_stream
from .precision import COMPUTE_DTYPES, canonical_compute_dtype
from .sjlt import fold_row_weights, sjlt_cuda_batched, sjlt_ref_batched

KERNELS = ("gaussian_sa", "fwht", "sjlt")


def leg(kernel: str, compute_dtype: str | None) -> str:
    """The launch counter of a kernel's compute-dtype leg."""
    name = canonical_compute_dtype(compute_dtype)
    return kernel if name == "fp32" else f"{kernel}.{name}"


LAUNCHES = {leg(k, c): 0 for k in KERNELS for c in COMPUTE_DTYPES}


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
    """Streamed Gaussian sketch S·W^{1/2}·A (B, m, d) fp32 without
    materializing S: A (n, d) shared or (B, n, d) per problem, seeds (B,)
    int64 holding uint32 values, optional row weights (B, n) (W = I when
    None); ``compute_dtype`` selects the pass's precision."""
    A, scale = resolve_stream(A, seeds.shape[0], row_weights, compute_dtype)
    if not _on_cuda(A):
        return gaussian_sa_ref(A, seeds, m, scale=scale, compute_dtype=compute_dtype)
    out = gaussian_sa_cuda(A, seeds, m, scale=scale, compute_dtype=compute_dtype)
    LAUNCHES[leg("gaussian_sa", compute_dtype)] += 1
    return out


def fwht_cols(X: torch.Tensor, *, row_scale: torch.Tensor | None = None,
              batch: int | None = None,
              compute_dtype: str | None = None) -> torch.Tensor:
    """Unnormalized FWHT along axis -2 of a (B, n, d) stack (n a power of
    two), or of a shared (n, d) for ``batch`` problems; ``row_scale``
    (B, n) computes H·diag(s_b)·X_b per problem, fused into the kernel's
    first pass. In the bf16 and int8 modes X (fp32, bf16 or int8 codes) and
    the scale are cast to bf16, every stage rounds to bf16, and the result
    is a bf16 stack."""
    if not _on_cuda(X):
        return fwht_passes_ref(X, row_scale, batch=batch, compute_dtype=compute_dtype)
    out, launches = fwht_passes_cuda(X, row_scale, batch=batch,
                                     compute_dtype=compute_dtype)
    LAUNCHES[leg("fwht", compute_dtype)] += launches
    return out


def fwht(x: torch.Tensor, *, row_scale: torch.Tensor | None = None,
         compute_dtype: str | None = None) -> torch.Tensor:
    """Unnormalized FWHT along axis 0 of x (n, d); ``row_scale`` (n,)
    computes H·diag(s)·x."""
    scale = None if row_scale is None else row_scale[None]
    return fwht_cols(x[None], row_scale=scale, compute_dtype=compute_dtype)[0]


def sjlt_apply_batched(A: torch.Tensor, rows: torch.Tensor, signs: torch.Tensor,
                       m: int, *, row_weights: torch.Tensor | None = None,
                       compute_dtype: str | None = None) -> torch.Tensor:
    """Batch of s = 1 SJLT sketches (B, m, d) fp32: A per problem (B, n, d)
    or shared (n, d), rows and signs (B, n); targets outside [0, m) drop
    out. ``row_weights`` (B, n) folds w^{1/2} into the signs;
    ``compute_dtype`` selects the pass's precision (int8 folds the
    quantization scales into the signs)."""
    signs = fold_row_weights(signs, row_weights)
    if not _on_cuda(A):
        return sjlt_ref_batched(A, rows, signs, m, compute_dtype)
    out = sjlt_cuda_batched(A, rows, signs, m, compute_dtype)
    LAUNCHES[leg("sjlt", compute_dtype)] += 1
    return out


def sjlt_apply(A: torch.Tensor, rows: torch.Tensor, signs: torch.Tensor, m: int,
               *, row_weights: torch.Tensor | None = None,
               compute_dtype: str | None = None) -> torch.Tensor:
    """S·A (m, d) for one s = 1 SJLT: A (n, d), rows and signs (n,),
    ``row_weights`` (n,)."""
    w = None if row_weights is None else row_weights[None]
    return sjlt_apply_batched(A, rows[None], signs[None], m, row_weights=w,
                              compute_dtype=compute_dtype)[0]
