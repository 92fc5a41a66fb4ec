"""The compute-dtype names of the one-touch sketch passes.

An own copy of ``repro.kernels.precision``'s names. This slice implements
``"fp32"`` only; ``"bf16"`` and ``"int8"`` are accepted names whose sketch
passes raise ``NotImplementedError`` (ROADMAP queue 2: the bf16/int8 legs
of the Gaussian and FWHT kernels).
"""

from __future__ import annotations

import torch

COMPUTE_DTYPES = ("fp32", "bf16", "int8")


def canonical_compute_dtype(compute_dtype: str | None) -> str:
    """Validate and canonicalize (None → "fp32")."""
    name = compute_dtype or "fp32"
    if name not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {COMPUTE_DTYPES}, "
            f"got {compute_dtype!r}")
    return name


def contract_dtype(compute_dtype: str | None) -> torch.dtype:
    """The dtype sketch operands are cast to before the contraction
    (accumulation is always fp32)."""
    return (torch.float32 if canonical_compute_dtype(compute_dtype) == "fp32"
            else torch.bfloat16)


def require_fp32(compute_dtype: str | None) -> None:
    """Raise for the reduced-precision sketch passes this slice lacks."""
    name = canonical_compute_dtype(compute_dtype)
    if name != "fp32":
        raise NotImplementedError(
            f"compute_dtype={name!r} is not ported yet (ROADMAP queue 2: "
            "bf16/int8 legs of the Gaussian and FWHT kernels)")
