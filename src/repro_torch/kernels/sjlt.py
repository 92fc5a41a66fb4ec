"""s = 1 SJLT sketch: the plain PyTorch version and the CUDA kernel.

Port of ``repro.kernels.sjlt`` and of the segment-sum oracles
``repro.kernels.ref.sjlt_ref(_batched)``. The sketch has one signed nonzero
per column: (SA)[r] = Σ_{i : rows[i] = r} signs[i]·A[i]. Targets outside
[0, m) drop out (the reference pads ragged blocks with target m).

Row weights and the int8 dequantization scales fold into the sign stream
(``fold_row_weights``, ``fold_stream``), exactly, because each column of
S has one nonzero. In the bf16 and int8 modes the folded signs and A are
rounded to bf16 and multiplied exactly in fp32; every sum is fp32.

The plain version is a sequential ``index_add_`` in increasing i. The
kernel (``csrc/sjlt.cu``) runs in two passes: a bucket pass, a stable
counting sort of each problem's targets (``bucket_chunk`` picks its form),
then a segment sum that adds each bucket in increasing i without atomics,
so its repeats are bitwise and equal to the plain version on the CPU.
``sjlt_buckets_ref`` models the bucket pass's result on the CPU and
``sjlt_bucketed_ref`` sums its buckets as the segment sum does.
"""

from __future__ import annotations

import torch

from . import _build
from .precision import canonical_compute_dtype, contract_dtype, round_to

MAX_N = 1 << 26     # the kernel's positions and indices are int32

# The bucket pass's plan, as csrc/sjlt.cu takes it. The cluster form gives a
# problem CLUSTER_BLOCKS blocks of BLOCK_WARPS warps, each warp a segment of
# the targets; a block holds its slice of the targets and their signs, its
# (M + 1) × (BLOCK_WARPS + 1) counts, every block's (M + 1) totals and two
# more (M + 1) arrays in dynamic shared memory. Otherwise each warp takes a
# chunk of CHUNK targets or more, so that the (B, M + 1, chunks) counts stay
# within CHUNK_COUNTS_MAX words.
CLUSTER_MAX_N = 16384
CLUSTER_BLOCKS = 8
BLOCK_WARPS = 8
SMEM_MAX = 232448 - 1024
CHUNK = 1024
CHUNK_COUNTS_MAX = 1 << 24


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


def _segment(n: int) -> int:
    """Targets per warp in the cluster form: a multiple of 32."""
    return (-(-n // (CLUSTER_BLOCKS * BLOCK_WARPS)) + 31) // 32 * 32


def bucket_chunk(B: int, n: int, m: int) -> int:
    """The bucket pass's form: 0 for a cluster of blocks per problem
    (n ≤ CLUSTER_MAX_N and a block's share fits shared memory), else the
    targets per warp of the multi-chunk form."""
    smem = 4 * ((m + 1) * (BLOCK_WARPS + 3 + CLUSTER_BLOCKS) + 2 * BLOCK_WARPS * _segment(n))
    if n <= CLUSTER_MAX_N and smem <= SMEM_MAX:
        return 0
    chunk = CHUNK
    while chunk < n and B * (m + 1) * -(-n // chunk) > CHUNK_COUNTS_MAX:
        chunk *= 2
    return chunk


def _chunks(n: int, chunk: int) -> int:
    return max(1, -(-n // chunk))


def workspace_ints(B: int, n: int, m: int, chunk: int) -> int:
    """int32 words of the kernel's workspace: the (B, n) entries of an index
    and its sign (two words each), offsets (B, m+1) and, in the multi-chunk
    form, the counts."""
    counts = B * (m + 1) * _chunks(n, chunk) if chunk else 0
    return 2 * B * n + B * (m + 1) + counts


def split_workspace(ws: torch.Tensor, B: int, n: int, m: int):
    """(offsets (B, m+1) int32, order (B, n) int32, order_s (B, n) fp32),
    views of the workspace as the bucket pass leaves it: each index sits
    beside its sign."""
    entries = ws[:2 * B * n].view(B, n, 2)
    return (ws[2 * B * n:2 * B * n + B * (m + 1)].view(B, m + 1), entries[..., 0],
            entries[..., 1].view(torch.float32))


def sjlt_buckets_ref(rows: torch.Tensor, signs: torch.Tensor, m: int):
    """CPU model of the kernel's bucket pass: (offsets (B, m+1) int32,
    order (B, n) int32, order_s (B, n) fp32) as the kernel lays them out.
    A stable grouping by target has one result, whatever its schedule:
    offsets is the exclusive prefix of the in-range target counts, order
    the stable argsort of the targets with the dropped ones (outside
    [0, m)) as target m after the rest, order_s the signs gathered by it."""
    t = rows.to(torch.int64)
    t = torch.where((t >= 0) & (t < m), t, m)
    counts = torch.stack([torch.bincount(x, minlength=m + 1) for x in t])
    offsets = torch.cumsum(counts, 1) - counts
    order = torch.argsort(t, dim=1, stable=True)
    return (offsets.to(torch.int32), order.to(torch.int32),
            signs.to(torch.float32).gather(1, order))


def sjlt_bucketed_ref(A: torch.Tensor, rows: torch.Tensor, signs: torch.Tensor,
                      m: int, compute_dtype: str | None = None) -> torch.Tensor:
    """The kernel's segment sum on the CPU: each output row adds its
    bucket of ``sjlt_buckets_ref`` in the bucket's order from +0.0, with a
    separately rounded fp32 product and add. Same arguments and result as
    ``sjlt_ref_batched``."""
    A, signs = fold_stream(A, signs, compute_dtype)
    _check(A, rows, signs)
    B, n = rows.shape
    d = A.shape[-1]
    offsets, order, order_s = sjlt_buckets_ref(rows, signs, m)
    A = round_to(A, contract_dtype(compute_dtype)).expand(B, n, d)
    start = offsets[:, :m].to(torch.int64)
    size = offsets[:, 1:].to(torch.int64) - start
    order = order.to(torch.int64)
    problem = torch.arange(B)[:, None]
    acc = torch.zeros((B, m, d), dtype=torch.float32)
    for j in range(int(size.max())):
        live = size > j
        k = torch.where(live, start + j, 0)
        prod = A[problem, order.gather(1, k)] * order_s.gather(1, k)[:, :, None]
        acc = torch.where(live[:, :, None], acc + prod, acc)
    return acc


def _launch(A: torch.Tensor, rows: torch.Tensor, signs: torch.Tensor, m: int,
            compute_dtype: str | None):
    """(SA, workspace) of one launch of ``csrc/sjlt.cu``'s two passes."""
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
    chunk = bucket_chunk(B, n, m)
    out = torch.empty((B, m, d), dtype=torch.float32, device=A.device)
    ws = torch.empty(workspace_ints(B, n, m, chunk), dtype=torch.int32, device=A.device)
    lib = _build.load("sjlt")
    code = lib.sjlt_launch(
        A.data_ptr(), 0 if A.dim() == 2 else n * d, rows.data_ptr(),
        signs.data_ptr(), out.data_ptr(), ws.data_ptr(), B, n, d, m, chunk, kind,
        torch.cuda.current_stream(A.device).cuda_stream)
    _build.check_launch(code, "sjlt")
    return out, ws


def sjlt_launch(A: torch.Tensor, rows: torch.Tensor, signs: torch.Tensor, m: int,
                *, compute_dtype: str | None = None) -> torch.Tensor:
    """Launch ``csrc/sjlt.cu``'s two passes on the current stream, on a
    stream that ``fold_stream`` has prepared: A (B, n, d) or shared (n, d)
    as fp32, bf16 or int8 codes, rows (B, n) integer targets, signs (B, n)
    fp32. A pass is two launches (cluster bucket form) or a memset and four
    (multi-chunk form, ``bucket_chunk``)."""
    return _launch(A, rows, signs, m, compute_dtype)[0]


def sjlt_launch_buckets(A: torch.Tensor, rows: torch.Tensor, signs: torch.Tensor,
                        m: int):
    """The bucket pass's (offsets, order, order_s) from one fp32 launch,
    for holding it against ``sjlt_buckets_ref`` (card tests, chip_smoke)."""
    ws = _launch(A, rows, signs, m, None)[1]
    return split_workspace(ws, *rows.shape, m)


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
