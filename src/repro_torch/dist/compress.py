"""Per-row symmetric int8 quantization of the sketch passes' int8 mode.

An own copy of ``repro.dist.compress.quantize_rows`` / ``dequantize_rows``
(the error-feedback gradient compression of that module is not ported).
The codes and scales are bitwise the reference's, on the CPU and on the
card: the scale is max|row|/127 in fp32, an all-zero row divides by 1
(codes 0, scale 0), and the codes are v/scale rounded half to even and
clipped to ±127.
"""

from __future__ import annotations

import torch


def quantize_rows(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """v (…, n, d) → (codes int8 (…, n, d), scales fp32 (…, n)) with
    v̂ = scales[…, None]·codes and |v̂ − v| ≤ scales/2 entrywise."""
    v = v.to(torch.float32)
    amax = v.abs().amax(dim=-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which rounds some scales one ulp off max|row|/127
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    # one A-sized fp32 temporary: rounded and clamped in place
    codes = v.div(safe[..., None]).round_().clamp_(-127, 127).to(torch.int8)
    return codes, scale


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Materialized Â = diag(scales)·codes: the dense oracle of the int8
    passes, which never build it themselves."""
    return codes.to(dtype) * scales[..., None].to(dtype)
