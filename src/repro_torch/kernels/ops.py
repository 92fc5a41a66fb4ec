"""Device-dispatching wrappers of the sketch kernels.

A CPU tensor takes the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel or raises. There is no fallback from the
kernel to the plain version. ``LAUNCHES`` counts kernel launches per kernel
and compute-dtype leg (``"sjlt"`` is the fp32 leg, ``"sjlt.bf16"`` and
``"sjlt.int8"`` the others): each wrapper adds one where it launches its
kernel, and nowhere else, so a run can show that its main path went through
every kernel leg it should have. The FWHT counts each launch of its plan; the
SJLT counts one per sketch pass, whatever the launches inside it (its bucket
pass and segment sum: ``sjlt.sjlt_launch``). A Gaussian call with row
weights in the fp32 or bf16 mode counts under its weighted leg
(``"gaussian_sa.weighted"``, ``"gaussian_sa.bf16.weighted"``: the Pallas
body ``_gauss_sa_kernel_scaled``, whose int8 leg every int8 call is).

``BODY_LAUNCHES`` counts the same launches by the reference's Pallas body
they replace, whatever the dtype: ``_gauss_sa_kernel`` (no column scale)
or ``_gauss_sa_kernel_scaled``; ``_fwht_kernel`` (a launch without the row
scale, the later passes of a split plan included) or
``_fwht_kernel_scaled``; ``_sjlt_kernel`` (one sketch of a shared A, B = 1)
or ``_sjlt_kernel_batched``. The paper-literal sketches
(``core.sketches``) are what launch the unscaled FWHT and the B = 1 SJLT.
"""

from __future__ import annotations

import math

import torch

from .fwht import fwht_passes_cuda, fwht_passes_ref
from .gaussian_gram import (
    gaussian_sa_cuda,
    gaussian_sa_ref,
    hash_signs,
    hash_stream,
    resolve_stream,
)
from .precision import COMPUTE_DTYPES, canonical_compute_dtype
from .sjlt import fold_row_weights, sjlt_cuda_batched, sjlt_ref_batched

KERNELS = ("gaussian_sa", "fwht", "sjlt")


def leg(kernel: str, compute_dtype: str | None, weighted: bool = False) -> str:
    """The launch counter of a kernel's compute-dtype leg; ``weighted`` picks
    the Gaussian kernel's row-weighted leg (int8 has one leg either way)."""
    name = canonical_compute_dtype(compute_dtype)
    base = kernel if name == "fp32" else f"{kernel}.{name}"
    return f"{base}.weighted" if weighted and name != "int8" else base


WEIGHTED_LEGS = tuple(leg("gaussian_sa", c, weighted=True) for c in ("fp32", "bf16"))
LAUNCHES = {**{leg(k, c): 0 for k in KERNELS for c in COMPUTE_DTYPES},
            **dict.fromkeys(WEIGHTED_LEGS, 0)}


BODIES = ("_gauss_sa_kernel", "_gauss_sa_kernel_scaled", "_fwht_kernel",
          "_fwht_kernel_scaled", "_sjlt_kernel", "_sjlt_kernel_batched")
BODY_LAUNCHES = dict.fromkeys(BODIES, 0)


def reset_launches() -> None:
    for counts in (LAUNCHES, BODY_LAUNCHES):
        for k in counts:
            counts[k] = 0


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
    LAUNCHES[leg("gaussian_sa", compute_dtype, weighted=row_weights is not None)] += 1
    BODY_LAUNCHES["_gauss_sa_kernel" if scale is None else "_gauss_sa_kernel_scaled"] += 1
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
    scaled = int(row_scale is not None)
    BODY_LAUNCHES["_fwht_kernel_scaled"] += scaled
    BODY_LAUNCHES["_fwht_kernel"] += launches - scaled
    return out


def fwht(x: torch.Tensor, *, row_scale: torch.Tensor | None = None,
         compute_dtype: str | None = None) -> torch.Tensor:
    """Unnormalized FWHT along axis 0 of x (n, d); ``row_scale`` (n,)
    computes H·diag(s)·x."""
    scale = None if row_scale is None else row_scale[None]
    return fwht_cols(x[None], row_scale=scale, compute_dtype=compute_dtype)[0]


def srht_sample(seed: torch.Tensor, n: int, m: int) -> dict:
    """The fixed-size SRHT's randomness from one uint32 seed (a 0-d int64
    tensor): ``signs`` (n,) ±1 from stream 0 of the counter hash, and ``rows``
    (m,) of the padded index space [0, n_pad) drawn WITHOUT replacement while
    m ≤ n_pad: the first m of a stable argsort of n_pad hash words of stream
    1 (ties broken by index). For m > n_pad the rows are drawn with
    replacement, from the low bits of the same stream."""
    seeds = seed.reshape(1)
    n_pad = 1 << max(0, (n - 1).bit_length())
    signs = hash_signs(hash_stream(seeds, 0, n))[0]
    if m <= n_pad:
        words = hash_stream(seeds, 1, n_pad)[0]
        rows = torch.sort(words, stable=True).indices[:m]
    else:
        rows = hash_stream(seeds, 1, m)[0] & (n_pad - 1)
    return {"signs": signs, "rows": rows}


def srht_sketch(A: torch.Tensor, seed, m: int, *,
                row_weights: torch.Tensor | None = None,
                compute_dtype: str | None = None,
                sample: dict | None = None) -> torch.Tensor:
    """The fixed-size SRHT sketch √(n_pad/m)·R·H·E·A (m, d) fp32 of A (n, d)
    through one FWHT call, with H unnormalized and R the m rows of
    ``srht_sample(seed, n, m)`` (or of ``sample``, a dict of ``signs`` (n,)
    and ``rows`` (m,)). ``row_weights`` (n,) sketches W^{1/2}A by folding
    w^{1/2} into the sign flip, the FWHT's one fused row scale; the int8
    mode streams A's codes with their scales in the same row scale.

    Rows are sampled WITHOUT replacement (every row distinct while
    m ≤ n_pad), the classical SRHT; ``core.level_grams.SRHTProvider`` draws
    its ladder's rows WITH replacement instead, since every prefix of its
    row stream must be a valid sample. Both are unbiased (E[SᵀS] = I)."""
    name = canonical_compute_dtype(compute_dtype)
    n = A.shape[0]
    n_pad = 1 << max(0, (n - 1).bit_length())
    if sample is None:
        sample = srht_sample(torch.as_tensor(seed, dtype=torch.int64, device=A.device),
                             n, m)
    scale = sample["signs"]
    if row_weights is not None:
        scale = scale * torch.sqrt(row_weights).to(scale.dtype)
    if name == "int8" and A.dtype != torch.int8:
        from repro_torch.dist.compress import quantize_rows

        A, a_scales = quantize_rows(A)
        scale = scale * a_scales
    if n_pad != n:
        A = torch.nn.functional.pad(A, (0, 0, 0, n_pad - n))
        scale = torch.nn.functional.pad(scale, (0, n_pad - n))
    HX = fwht(A, row_scale=scale, compute_dtype=compute_dtype)
    return HX[sample["rows"]].to(torch.float32) * math.sqrt(1.0 / m)


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
    single = A.dim() == 2 and rows.shape[0] == 1
    BODY_LAUNCHES["_sjlt_kernel" if single else "_sjlt_kernel_batched"] += 1
    return out


def sjlt_apply(A: torch.Tensor, rows: torch.Tensor, signs: torch.Tensor, m: int,
               *, row_weights: torch.Tensor | None = None,
               compute_dtype: str | None = None) -> torch.Tensor:
    """S·A (m, d) for one s = 1 SJLT: A (n, d), rows and signs (n,),
    ``row_weights`` (n,)."""
    w = None if row_weights is None else row_weights[None]
    return sjlt_apply_batched(A, rows[None], signs[None], m, row_weights=w,
                              compute_dtype=compute_dtype)[0]
