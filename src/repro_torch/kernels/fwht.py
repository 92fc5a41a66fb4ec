"""Fast Walsh–Hadamard transform: the plain PyTorch version and the CUDA kernel.

Port of ``repro.kernels.fwht`` and ``repro.kernels.ref.fwht_ref``. The
kernel (``csrc/fwht.cu``) transforms one axis of a batch viewed as
(B, a, L, c), with an optional row scale fused into its load. A long axis
n = f_0·f_1·… is transformed in one launch per factor of the radix split
H_n = (H_a ⊗ I_b)(I_a ⊗ H_b), innermost factor first (``split_plan``). Each
launch runs a contiguous block of the one-pass butterfly's stages in the
same order, so the composition is bitwise the one-pass transform;
``fwht_passes_ref`` runs the same plan with the plain axis transform, which
the tests hold against ``fwht_ref``.

In the bf16 and int8 modes (``kernels.precision``) the input, which may be
int8 codes, and the row scale are cast to bf16, their product is rounded to
bf16, and every butterfly stage rounds to bf16 (``ops.fwht`` of the
reference); the result is a bf16 stack. The passes stay bitwise the
one-pass bf16 butterfly.
"""

from __future__ import annotations

import torch

from . import _build
from .precision import contract_dtype

# A Hopper block may use 227 KB of shared memory; an (L × 32) tile fits for
# L ≤ 1024 in fp32 and L ≤ 2048 in bf16 (128 KB each). Longer axes take the
# radix split.
SMEM_BUDGET = 232_448
TILE_COLS = 32


def max_axis(itemsize: int = 4) -> int:
    """The longest axis one launch transforms with tile elements of
    ``itemsize`` bytes."""
    return 1 << ((SMEM_BUDGET // (itemsize * TILE_COLS)).bit_length() - 1)


def fwht_ref(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized FWHT along axis -2 of x (..., n, d), n a power of two:
    the butterfly of ``repro.kernels.ref.fwht_ref``, batched."""
    n, d = x.shape[-2], x.shape[-1]
    if n & (n - 1):
        raise ValueError("n must be a power of 2")
    lead = x.shape[:-2]
    h = 1
    while h < n:
        x = x.reshape(*lead, n // (2 * h), 2, h, d)
        a, b = x[..., 0, :, :], x[..., 1, :, :]
        x = torch.cat([(a + b).unsqueeze(-3), (a - b).unsqueeze(-3)], dim=-3)
        h *= 2
    return x.reshape(*lead, n, d)


def hadamard_dense(n: int) -> torch.Tensor:
    """Dense Hadamard matrix (tiny-n ground truth)."""
    H = torch.ones((1, 1), dtype=torch.float32)
    while H.shape[0] < n:
        H = torch.cat([torch.cat([H, H], 1), torch.cat([H, -H], 1)], 0)
    return H


def split_plan(n: int, itemsize: int = 4) -> list[int]:
    """Factors of n, innermost first, each at most ``max_axis(itemsize)``:
    one pass each."""
    if n & (n - 1):
        raise ValueError(f"n={n} must be a power of 2")
    max_l = max_axis(itemsize)
    if n <= max_l:
        return [n]
    lg = n.bit_length() - 1
    inner = 1 << ((lg + 1) // 2)
    if inner > max_l:
        raise ValueError(f"n={n} exceeds the two-pass limit {max_l ** 2}")
    return [inner, n // inner]


def fwht_axis_ref(x: torch.Tensor, a: int, L: int, c: int,
                  scale: torch.Tensor | None) -> torch.Tensor:
    """Plain version of one kernel launch: x (B, a·L·c) viewed as
    (B, a, L, c), times the (B, a·L) row scale, transformed along L."""
    B = x.shape[0]
    y = x.reshape(B, a, L, c)
    if scale is not None:
        y = y * scale.reshape(B, a, L, 1)
    return fwht_ref(y).reshape(B, a * L * c)


# in_kind of fwht_axis_launch, by the input's dtype
_IN_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def fwht_axis_cuda(x: torch.Tensor, a: int, L: int, c: int,
                   scale: torch.Tensor | None, *, out: torch.Tensor | None = None,
                   batch: int | None = None, x_batch_stride: int | None = None,
                   tile: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch ``csrc/fwht.cu`` once: the kernel counterpart of
    ``fwht_axis_ref``, with the tile, the scale and the result in ``tile``
    (fp32, or bf16 from an fp32, bf16 or int8 input). ``out`` may be ``x``
    (in place). ``x_batch_stride`` 0 with ``batch`` = B shares one input
    across the batch (a shared A)."""
    max_l = max_axis(tile.itemsize)
    if L & (L - 1) or L > max_l:
        raise ValueError(f"axis length {L} must be a power of 2 ≤ {max_l}")
    if (x.dtype not in _IN_KIND or not x.is_contiguous()
            or (tile == torch.float32 and x.dtype != torch.float32)
            or tile not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"fwht kernel takes a contiguous fp32 input to an fp32 "
                         f"tile, or fp32/bf16/int8 to a bf16 tile; got {x.dtype} "
                         f"to {tile}")
    B = batch or (x.shape[0] if out is None else out.shape[0])
    if out is None:
        out = torch.empty((B, a * L * c), dtype=tile, device=x.device)
    if out.dtype != tile:
        raise ValueError(f"out must be {tile}")
    if scale is not None:
        if scale.dtype != tile or scale.numel() != B * a * L:
            raise ValueError(f"row scale must hold {B}·{a * L} {tile} values")
        scale = scale.contiguous()
        if scale.device != x.device:
            raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    if x_batch_stride is None:
        x_batch_stride = a * L * c
    lib = _build.load("fwht")
    code = lib.fwht_axis_launch(
        x.data_ptr(), out.data_ptr(),
        None if scale is None else scale.data_ptr(),
        B, a, L, c, x_batch_stride, _IN_KIND[x.dtype], int(tile == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(code, "fwht")
    return out


def pass_shapes(n: int, d: int, itemsize: int = 4) -> list[tuple[int, int, int]]:
    """(a, L, c) of each pass over a (B, n, d) stack, innermost factor
    first: pass k transforms factor L = f_k with the factors already done
    folded into its columns."""
    shapes, done = [], 1
    for L in split_plan(n, itemsize):
        shapes.append((n // (L * done), L, d * done))
        done *= L
    return shapes


def fwht_passes_ref(X: torch.Tensor, row_scale: torch.Tensor | None, *,
                    batch: int | None = None,
                    compute_dtype: str | None = None) -> torch.Tensor:
    """Plain version of the kernel's pass plan: H·diag(s_b)·X_b per problem
    b, with X (B, n, d) or a shared (n, d) and ``batch`` = B; the (B, n) row
    scale fuses into the first pass. Bitwise ``fwht_ref`` of the scaled X,
    in the mode's contract dtype (fp32, or bf16 in the reduced modes)."""
    n, d = X.shape[-2], X.shape[-1]
    B = X.shape[0] if X.dim() == 3 else batch
    tile = contract_dtype(compute_dtype)
    X = X.to(tile)
    if row_scale is not None:
        row_scale = row_scale.to(tile)
    y = X.expand(B, n, d).reshape(B, n * d)
    for k, (a, L, c) in enumerate(pass_shapes(n, d, tile.itemsize)):
        y = fwht_axis_ref(y, a, L, c, row_scale if k == 0 else None)
    return y.reshape(B, n, d)


def fwht_passes_cuda(X: torch.Tensor, row_scale: torch.Tensor | None, *,
                     batch: int | None = None,
                     compute_dtype: str | None = None) -> tuple[torch.Tensor, int]:
    """The kernel's pass plan on the card: the first launch reads X (a shared
    (n, d) X at batch stride 0, fp32, bf16 or int8 codes) with the row scale
    fused in, later launches run in place. Same contract as
    ``fwht_passes_ref``; returns the number of launches beside the result."""
    n, d = X.shape[-2], X.shape[-1]
    shared = X.dim() == 2
    B = batch if shared else X.shape[0]
    tile = contract_dtype(compute_dtype)
    if row_scale is not None:
        row_scale = row_scale.to(tile)
    y = None
    shapes = pass_shapes(n, d, tile.itemsize)
    for k, (a, L, c) in enumerate(shapes):
        if k == 0:
            y = fwht_axis_cuda(X, a, L, c, row_scale, batch=B,
                               x_batch_stride=0 if shared else n * d, tile=tile)
        else:
            fwht_axis_cuda(y, a, L, c, None, out=y, tile=tile)
    return y.reshape(B, n, d), len(shapes)
