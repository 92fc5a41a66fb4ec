"""s = 1 SJLT sketch: the plain PyTorch version and the CUDA kernel.

Port of ``repro.kernels.sjlt`` and of the segment-sum oracles
``repro.kernels.ref.sjlt_ref(_batched)``. The sketch has one signed nonzero
per column: (SA)[r] = Σ_{i : rows[i] = r} signs[i]·A[i]. Targets outside
[0, m) drop out (the reference pads ragged blocks with target m).

Row weights and the int8 dequantization scales fold into the sign stream
(``fold_row_weights``, ``fold_stream``), exactly, because each column of
S has one nonzero. In the bf16 and int8 modes the folded signs and A are
rounded to bf16 and multiplied exactly in fp32; every sum is fp32.

The plain version is a sequential ``index_add_`` in increasing i; the
kernel (``csrc/sjlt.cu``) sums each output row in the same order without
atomics, so its repeats are bitwise.
"""

from __future__ import annotations

import torch

from . import _build
from .precision import canonical_compute_dtype, contract_dtype, round_to

MAX_N = 1 << 26     # the kernel's list entries pack i << 5 into an int32


def fold_row_weights(signs: torch.Tensor,
                     row_weights: torch.Tensor | None) -> torch.Tensor:
    """S·diag(w^{1/2}): scaling column i of a one-nonzero-per-column sketch
    is scaling its sign, so the weight folds into the (…, n) sign stream and
    no weighted copy of A exists."""
    if row_weights is None:
        return signs
    return signs * torch.sqrt(row_weights).to(signs.dtype)


def fold_stream(A: torch.Tensor, signs: torch.Tensor, compute_dtype: str | None):
    """The SJLT's compute-dtype prep, shared by the plain version and the
    kernel's wrapper: in int8 mode A is quantized per row and the scales
    fold into the signs. Returns (A_stream, signs rounded to the contract
    dtype and held in fp32)."""
    name = canonical_compute_dtype(compute_dtype)
    if name == "int8" and A.dtype != torch.int8:
        from repro_torch.dist.compress import quantize_rows

        A, a_scales = quantize_rows(A)
        if a_scales.dim() < signs.dim():        # shared A under batched signs
            a_scales = a_scales[None, :]
        signs = signs * a_scales
    if A.dtype == torch.int8 and name == "fp32":
        raise ValueError("int8 codes stream only in the bf16/int8 modes")
    return A, round_to(signs.to(torch.float32), contract_dtype(name))


def _check(A: torch.Tensor, rows: torch.Tensor, signs: torch.Tensor) -> None:
    B, n = rows.shape
    if signs.shape != (B, n):
        raise ValueError(f"signs {tuple(signs.shape)} != rows {(B, n)}")
    if A.shape[-2] != n or (A.dim() == 3 and A.shape[0] != B):
        raise ValueError(f"A {tuple(A.shape)} does not match rows {(B, n)}")


def sjlt_ref_batched(A: torch.Tensor, rows: torch.Tensor, signs: torch.Tensor,
                     m: int, compute_dtype: str | None = None) -> torch.Tensor:
    """Plain batch of SJLT sketches (B, m, d) fp32: A (B, n, d) or shared
    (n, d), rows and signs (B, n). Targets outside [0, m) drop out."""
    A, signs = fold_stream(A, signs, compute_dtype)
    _check(A, rows, signs)
    B, n = rows.shape
    d = A.shape[-1]
    prod = round_to(A, contract_dtype(compute_dtype)) * signs[:, :, None]
    rows = rows.to(torch.int64)
    keep = (rows >= 0) & (rows < m)
    offset = m * torch.arange(B, device=rows.device)[:, None]
    idx = torch.where(keep, rows + offset, B * m)        # row B·m collects drops
    out = torch.zeros((B * m + 1, d), dtype=torch.float32, device=A.device)
    out.index_add_(0, idx.reshape(-1), prod.expand(B, n, d).reshape(B * n, d))
    return out[:B * m].reshape(B, m, d)


def sjlt_ref(A: torch.Tensor, rows: torch.Tensor, signs: torch.Tensor, m: int,
             compute_dtype: str | None = None) -> torch.Tensor:
    """Plain single sketch (m, d) from A (n, d), rows and signs (n,)."""
    return sjlt_ref_batched(A, rows[None], signs[None], m, compute_dtype)[0]


def sjlt_launch(A: torch.Tensor, rows: torch.Tensor, signs: torch.Tensor, m: int,
                *, compute_dtype: str | None = None) -> torch.Tensor:
    """Launch ``csrc/sjlt.cu`` once on the current stream, on a stream that
    ``fold_stream`` has prepared: A (B, n, d) or shared (n, d) as fp32, bf16
    or int8 codes, rows (B, n) integer targets, signs (B, n) fp32."""
    _check(A, rows, signs)
    B, n = rows.shape
    d = A.shape[-1]
    if n >= MAX_N:
        raise ValueError(f"sjlt kernel takes n < {MAX_N}, got {n}")
    kind = _build.a_kind(A.dtype, contract_dtype(compute_dtype) == torch.bfloat16)
    if kind is None or not A.is_contiguous():
        raise ValueError(
            f"sjlt kernel takes a contiguous A of fp32 (any mode), bf16 or int8 "
            f"codes (bf16/int8 modes); got {A.dtype} in "
            f"{canonical_compute_dtype(compute_dtype)} mode")
    if signs.dtype != torch.float32:
        raise ValueError("sjlt kernel takes fp32 signs")
    for name, t in (("rows", rows), ("signs", signs)):
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
    rows = rows.to(torch.int32).contiguous()
    signs = signs.contiguous()
    out = torch.empty((B, m, d), dtype=torch.float32, device=A.device)
    lib = _build.load("sjlt")
    code = lib.sjlt_launch(
        A.data_ptr(), 0 if A.dim() == 2 else n * d, rows.data_ptr(),
        signs.data_ptr(), out.data_ptr(), B, n, d, m, kind,
        torch.cuda.current_stream(A.device).cuda_stream)
    _build.check_launch(code, "sjlt")
    return out


def sjlt_cuda_batched(A: torch.Tensor, rows: torch.Tensor, signs: torch.Tensor,
                      m: int, compute_dtype: str | None = None) -> torch.Tensor:
    """The kernel counterpart of ``sjlt_ref_batched``, for CUDA tensors."""
    A, signs = fold_stream(A, signs, compute_dtype)
    return sjlt_launch(A, rows, signs, m, compute_dtype=compute_dtype)


def sjlt_cuda(A: torch.Tensor, rows: torch.Tensor, signs: torch.Tensor, m: int,
              compute_dtype: str | None = None) -> torch.Tensor:
    """The kernel counterpart of ``sjlt_ref``: the batched kernel's B = 1,
    shared-A case."""
    return sjlt_cuda_batched(A, rows[None], signs[None], m, compute_dtype)[0]
