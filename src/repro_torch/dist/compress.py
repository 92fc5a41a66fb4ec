"""Int8 quantization: per-row for the sketch passes' int8 mode, and
error-feedback gradient compression (port of ``repro.dist.compress``).

The codes and scales are bitwise the reference's, on the CPU and on the
card: the scale is max|v|/127 in fp32 (of a row, or of a whole tensor), an
all-zero input divides by 1 (codes 0, scale 0), and the codes are v/scale
rounded half to even and clipped to ±127.

Error feedback (EF-SGD): ``compress_decompress`` quantizes v + residual
per tensor and carries the new residual, (v + residual) − v̂, to the next
call, so the accumulated signal stays unbiased up to a bounded lag.
``compress_tree`` does that over a tree of tensors (a tensor, or dicts,
lists and NamedTuples of them). As in the reference, no train step calls
it: it is a library function, on no path.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .sharding import tree_leaves, tree_map


def _scale(amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(max|v| / 127, the same with 0 → 1): a tensor divisor, since PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, which
    rounds some scales one ulp off."""
    scale = amax / torch.full_like(amax, 127.0)
    return scale, torch.where(scale > 0, scale, torch.ones_like(scale))


def quantize_rows(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """v (…, n, d) → (codes int8 (…, n, d), scales fp32 (…, n)) with
    v̂ = scales[…, None]·codes and |v̂ − v| ≤ scales/2 entrywise."""
    v = v.to(torch.float32)
    scale, safe = _scale(v.abs().amax(dim=-1))
    # one A-sized fp32 temporary: rounded and clamped in place
    codes = v.div(safe[..., None]).round_().clamp_(-127, 127).to(torch.int8)
    return codes, scale


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Materialized Â = diag(scales)·codes: the dense oracle of the int8
    passes, which never build it themselves."""
    return codes.to(dtype) * scales[..., None].to(dtype)


class EFState(NamedTuple):
    residual: Any                     # a tree shaped like the gradients


def init_ef(grads) -> EFState:
    """Zero error-feedback state shaped like the gradient tree."""
    return EFState(residual=tree_map(torch.zeros_like, grads))


def _quantize(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (codes int8, scale fp32 0-d)."""
    scale, safe = _scale(v.abs().amax())
    return torch.clamp(torch.round(v / safe), -127, 127).to(torch.int8), scale


def _dequantize(codes: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return codes.to(dtype) * scale


def compress_decompress(v: torch.Tensor, residual: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One EF-int8 round of one tensor: (v̂, new residual), v̂ = Q(v +
    residual) in v's dtype (what the wire would carry: the codes and one
    scale), the residual (v + residual) − v̂."""
    target = v + residual
    codes, scale = _quantize(target)
    v_hat = _dequantize(codes, scale, v.dtype)
    return v_hat, target - v_hat


def compress_tree(grads, ef: EFState):
    """EF-int8 over a gradient tree: (decompressed grads, new EFState)."""
    out = [compress_decompress(g, r) for g, r in zip(tree_leaves(grads),
                                                      tree_leaves(ef.residual))]
    hats, residuals = iter([o[0] for o in out]), iter([o[1] for o in out])
    return (tree_map(lambda _: next(hats), grads),
            EFState(residual=tree_map(lambda _: next(residuals), grads)))


def compression_ratio(grads) -> float:
    """Wire bytes of fp32 against int8 codes plus one fp32 scale a tensor."""
    leaves = tree_leaves(grads)
    return sum(4 * t.numel() for t in leaves) / sum(t.numel() + 4 for t in leaves)
