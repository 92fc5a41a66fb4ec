"""The compute-dtype axis of the one-touch sketch passes.

An own copy of ``repro.kernels.precision``. Three modes, applied to the
sketch pass only; the level Grams, the Cholesky factors and the δ̃
certificates downstream stay fp32 in every mode:

* ``"fp32"`` (default): the full-precision pass.
* ``"bf16"``: the sketch operands (generated S entries, SJLT sign streams,
  FWHT tiles, A) are rounded to bfloat16 and contracted with exact fp32
  products and fp32 sums; the FWHT runs its butterflies in bf16.
* ``"int8"``: A is quantized per row (``dist.compress.quantize_rows``), the
  int8 codes are what streams, and each family folds the dequantization
  scales into the per-row scale slot it already owns. Codes lie in
  [−127, 127], so their bf16 cast is exact and the contraction is the bf16
  mode's.
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
    """The dtype sketch operands are rounded to before the contraction
    (products and sums are always fp32)."""
    return (torch.float32 if canonical_compute_dtype(compute_dtype) == "fp32"
            else torch.bfloat16)


def stream_itemsize(compute_dtype: str | None) -> int:
    """Bytes per streamed A element (the bandwidth axis of the modes)."""
    return {"fp32": 4, "bf16": 2, "int8": 1}[
        canonical_compute_dtype(compute_dtype)]


def round_to(x: torch.Tensor, ct: torch.dtype) -> torch.Tensor:
    """x rounded to ``ct`` (round to nearest even) and held in fp32, so that
    a product of two such values is exact in fp32."""
    return x.to(ct).to(torch.float32)
