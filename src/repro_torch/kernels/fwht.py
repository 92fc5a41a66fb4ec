"""Fast Walsh–Hadamard transform: the plain PyTorch version and the CUDA kernel.

Port of ``repro.kernels.fwht`` and ``repro.kernels.ref.fwht_ref``. The
kernel (``csrc/fwht.cu``) transforms one axis of a batch viewed as
(B, a, L, c), with an optional row scale fused into its load. One launch
transforms an axis of up to ``MAX_AXIS`` = 16384 rows: a thread block
cluster holds the whole axis of a column group, each block a slab of it
(``cluster_plan``). A longer axis n = f_0·f_1 is transformed in one launch
per factor of the radix split H_n = (H_a ⊗ I_b)(I_a ⊗ H_b), innermost
factor first (``split_plan``). Each launch runs a contiguous block of the
one-pass butterfly's stages in the same order, so the composition is
bitwise the one-pass transform; ``fwht_passes_ref`` runs the same plan with
the plain axis transform, and ``fwht_schedule_ref`` models how one launch
orders its stages (register rounds in each slab, then the rounds across
the cluster), both of which the tests hold against ``fwht_ref``.

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

# One launch: a block holds a slab of at most 2^LG_MAX_SLAB rows × ROW_BYTES
# of columns (8 fp32 or 16 bf16 columns), 2048 · 32 B = 64 KB, so two blocks
# share an SM's 227 KB; a cluster of at most MAX_CLUSTER blocks (the
# portable cluster size) pools its slabs through distributed shared memory.
# So one launch transforms an axis of 8 · 2048 = 16384 rows, in either tile
# dtype; longer axes take the radix split, two launches up to 16384².
ROW_BYTES = 32
LG_MAX_SLAB = 11
MAX_CLUSTER = 8
MAX_AXIS = MAX_CLUSTER << LG_MAX_SLAB   # in either tile dtype
ROUND_BITS = 3        # butterfly stages a thread runs in registers per round


def cluster_plan(L: int) -> tuple[int, int]:
    """(slab rows, blocks per cluster) of one launch over an axis of L rows:
    one block while the axis fits a slab, else full slabs."""
    if L & (L - 1) or not 0 < L <= MAX_AXIS:
        raise ValueError(f"axis length {L} must be a power of 2 ≤ {MAX_AXIS}")
    cluster = max(1, L >> LG_MAX_SLAB)
    return L // cluster, cluster


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


def hadamard_dense(n: int, device=None) -> torch.Tensor:
    """Dense Hadamard matrix (tiny-n ground truth; the card's yardstick)."""
    H = torch.ones((1, 1), dtype=torch.float32, device=device)
    while H.shape[0] < n:
        H = torch.cat([torch.cat([H, H], 1), torch.cat([H, -H], 1)], 0)
    return H


def split_plan(n: int) -> list[int]:
    """Factors of n, innermost first, each at most ``MAX_AXIS``: one launch
    each."""
    if n & (n - 1):
        raise ValueError(f"n={n} must be a power of 2")
    if n <= MAX_AXIS:
        return [n]
    lg = n.bit_length() - 1
    inner = 1 << ((lg + 1) // 2)
    if inner > MAX_AXIS:
        raise ValueError(f"n={n} exceeds the two-pass limit {MAX_AXIS ** 2}")
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


def _register_stages(v: torch.Tensor, R: int, dim: int) -> torch.Tensor:
    """Stages 0..R-1 among the 2^R rows that ``dim`` indexes, lowest bit
    first: what one thread does to its rows in registers."""
    rows = list(v.unbind(dim))
    for lh in range(R):
        h = 1 << lh
        for e in range(1 << R):
            if not e & h:
                u, w = rows[e], rows[e + h]
                rows[e], rows[e + h] = u + w, u - w
    return torch.stack(rows, dim)


def fwht_schedule_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain model of how one kernel launch orders the stages along axis -2
    of x (..., L, c): in each block's slab, rounds of up to ROUND_BITS
    stages over groups of rows base + e·2^b (e < 2^R); then the top
    log2(cluster) stages over the rows r + slab·k gathered from every block
    of the cluster. Bitwise ``fwht_ref`` (the same adds in the same stage
    order), in x's dtype."""
    L, c = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    slab, cluster = cluster_plan(L)
    lg_slab = slab.bit_length() - 1
    b = 0
    while True:
        R = min(ROUND_BITS, lg_slab - b)
        groups = x.reshape(*lead, cluster, slab >> (b + R), 1 << R, 1 << b, c)
        x = _register_stages(groups, R, dim=-3)
        b += R
        if b == lg_slab:
            break
    x = x.reshape(*lead, cluster, slab, c)
    x = _register_stages(x, cluster.bit_length() - 1, dim=-3)
    return x.reshape(*lead, L, c)


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
    cluster_plan(L)   # raises unless one launch can transform L rows
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


def active_clusters(L: int, x_dtype: torch.dtype = torch.float32,
                    tile: torch.dtype = torch.float32) -> int:
    """How many of a launch's clusters the card keeps resident at once, for
    an axis of L rows (one block per cluster below 2^LG_MAX_SLAB rows)."""
    lib = _build.load("fwht")
    count = lib.fwht_active_clusters(L, _IN_KIND[x_dtype], int(tile == torch.bfloat16))
    if count < 0:
        raise RuntimeError(f"fwht: cluster occupancy query failed with cudaError_t {-count}")
    return count


def pass_shapes(n: int, d: int) -> list[tuple[int, int, int]]:
    """(a, L, c) of each pass over a (B, n, d) stack, innermost factor
    first: pass k transforms factor L = f_k with the factors already done
    folded into its columns."""
    shapes, done = [], 1
    for L in split_plan(n):
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
    for k, (a, L, c) in enumerate(pass_shapes(n, d)):
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
    shapes = pass_shapes(n, d)
    for k, (a, L, c) in enumerate(shapes):
        if k == 0:
            y = fwht_axis_cuda(X, a, L, c, row_scale, batch=B,
                               x_batch_stride=0 if shared else n * d, tile=tile)
        else:
            fwht_axis_cuda(y, a, L, c, None, out=y, tile=tile)
    return y.reshape(B, n, d), len(shapes)
