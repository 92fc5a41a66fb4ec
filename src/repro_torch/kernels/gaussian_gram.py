"""Streamed Gaussian sketch→SA: the plain PyTorch version and the CUDA kernel.

Port of ``repro.kernels.gaussian_gram``. Entry S[b, r, c] is a pure
function of (seed_b, r, c): the murmur3 finalizer of the uint32 counter
``r·2^20 + c`` keyed by the seed, then Box–Muller. The plain version
(``gaussian_tile`` / ``gaussian_s_dense`` / ``gaussian_sa_ref``) and the
kernel (``csrc/gaussian_sa.cu``) draw the same entries; the hash words are
bitwise those of the JAX reference.

The compute dtype (``kernels.precision``) enters through ``resolve_stream``:
in bf16 and int8 mode the scaled S entry and the A element are rounded to
bf16 and multiplied exactly in fp32, with fp32 sums; int8 mode streams the
per-row codes of A and folds their scales into the column scale.

This torch has no uint32 shifts or adds on the CPU, so the plain hash runs
in int64 masked to 32 bits, with every 32×32-bit product split into 16-bit
halves so that no intermediate overflows int64. Seeds are uint32 values
held in int64 tensors.
"""

from __future__ import annotations

import torch

from . import _build
from .precision import canonical_compute_dtype, contract_dtype, round_to

# Canonical micro-tile of the n axis: the plain version always reduces n in
# _MICRO-column steps, so its chunk size never changes the numbers.
_MICRO = 256
_COL_BITS = 20                 # counters: row · 2^20 + col
# The dense S is built in this many column blocks: the plain hash keeps
# about eight int64 block-sized temporaries alive at once, which then total
# about an eighth of S's 4·B·m·n bytes at every n
_DENSE_STEPS = 128
MAX_N = 1 << _COL_BITS         # column capacity of the counter packing
MAX_M = 1 << (32 - _COL_BITS)  # row capacity

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9
_SEQ2 = 0x7F4A7C15
_MUL1 = 0x85EBCA6B
_MUL2 = 0xC2B2AE35


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for x in [0, 2^32) held in int64: the high half's
    product is reduced mod 2^16 before it is shifted up."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: a bijective uint32 avalanche (int64 carrier)."""
    x = _mul32(x ^ (x >> 16), _MUL1)
    x = _mul32(x ^ (x >> 13), _MUL2)
    return x ^ (x >> 16)


def counter_hash(seeds: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """h1 = mix(ctr ^ mix(seed ^ GOLD)), broadcasting seeds (B,) against
    counters (...): the first hash word of every sketch entry."""
    k = _mix((seeds & _M32) ^ _GOLD)
    return _mix(ctr[None] ^ k.reshape((-1,) + (1,) * ctr.dim()))


def fold_seeds(seeds: torch.Tensor, tag) -> torch.Tensor:
    """A new uint32 seed per problem from (seed, tag): mix(mix(seed) + mix(tag)).
    For a fixed tag it is a bijection of the seed. ``tag`` is an int or a
    tensor broadcasting against ``seeds``. The robust driver folds in the
    retry attempt, the Newton driver its outer step, the service its slot
    ids, the SRHT its two streams."""
    tag = torch.as_tensor(tag, dtype=torch.int64, device=seeds.device) & _M32
    return _mix((_mix(seeds & _M32) + _mix(tag)) & _M32)


def hash_stream(seeds: torch.Tensor, tag: int, length: int) -> torch.Tensor:
    """(B, length) uint32 words (int64 carrier) of stream ``tag`` of each
    seed (B,): the samples of the SRHT and the SJLT."""
    ctr = torch.arange(length, dtype=torch.int64, device=seeds.device)
    return counter_hash(fold_seeds(seeds, tag), ctr)


def hash_signs(h: torch.Tensor) -> torch.Tensor:
    """±1 fp32 from the top bit of each hash word."""
    return 1.0 - 2.0 * (h >> 31).to(torch.float32)


def hash_words(seeds: torch.Tensor, ctr: torch.Tensor):
    """(h1, h2): the two uint32 hash words (int64 carrier) of each counter."""
    h1 = counter_hash(seeds, ctr)
    return h1, _mix((h1 + _SEQ2) & _M32)


def uniforms(h1: torch.Tensor, h2: torch.Tensor):
    """(u1, u2) fp32: 24-bit mantissas, u1 offset into (0, 1) so that
    log(u1) is finite."""
    u1 = (h1 >> 8).to(torch.float32) * (1.0 / 16777216.0) + (0.5 / 16777216.0)
    u2 = (h2 >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return u1, u2


def gaussian_tile(seeds: torch.Tensor, row0: int, col0: int,
                  shape: tuple[int, int]) -> torch.Tensor:
    """(B, *shape) fp32 tile of each seed's N(0,1) sketch at (row0, col0)."""
    dev = seeds.device
    r = row0 + torch.arange(shape[0], dtype=torch.int64, device=dev)
    c = col0 + torch.arange(shape[1], dtype=torch.int64, device=dev)
    ctr = ((r[:, None] << _COL_BITS) + c[None, :]) & _M32
    u1, u2 = uniforms(*hash_words(seeds, ctr))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.2831853071795864 * u2)


def check_caps(n: int, m: int) -> None:
    if n > MAX_N or m > MAX_M:
        raise ValueError(
            f"counter packing supports n ≤ {MAX_N}, m ≤ {MAX_M}; "
            f"got n={n}, m={m}")


def gaussian_s_dense(seeds: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """The full (B, m, n) fp32 sketch, materialized: the dense baseline.

    S is preallocated and filled in ``_DENSE_STEPS`` column blocks. The
    entries are counter hashes of (row, column), so the result is bitwise
    one ``gaussian_tile`` call's, while each of the plain hash's int64
    temporaries is one block's (1/64 of S's bytes) instead of twice S's."""
    check_caps(n, m)
    S = torch.empty((seeds.shape[0], m, n), dtype=torch.float32, device=seeds.device)
    blk = -(-n // _DENSE_STEPS)
    for c0 in range(0, n, blk):
        c1 = min(n, c0 + blk)
        S[:, :, c0:c1] = gaussian_tile(seeds, 0, c0, (m, c1 - c0))
    return S


def resolve_stream(A: torch.Tensor, B: int, row_weights: torch.Tensor | None,
                   compute_dtype: str | None):
    """The Gaussian family's compute-dtype prep: (A_stream, scale (B, n) or
    None). Everything that scales the columns of S folds into ONE fp32
    column scale: w^{1/2} and, in int8 mode, the per-row dequantization
    scales of A, whose int8 codes then stream in place of A."""
    scale = None if row_weights is None else torch.sqrt(row_weights.to(torch.float32))
    if canonical_compute_dtype(compute_dtype) == "int8" and A.dtype != torch.int8:
        from repro_torch.dist.compress import quantize_rows

        A, a_scales = quantize_rows(A)
        if A.dim() == 2:                      # shared A: one scale row per problem
            a_scales = a_scales[None, :].expand(B, A.shape[0])
        scale = a_scales if scale is None else scale * a_scales
    return A, scale


def gaussian_sa_ref(A: torch.Tensor, seeds: torch.Tensor, m: int, *,
                    chunk_cols: int = 2048,
                    scale: torch.Tensor | None = None,
                    compute_dtype: str | None = None) -> torch.Tensor:
    """Plain streamed S·diag(scale)·A, (B, m, d) fp32, from A (n, d) shared
    or (B, n, d) per problem (fp32, bf16 or, in int8 mode, int8 codes),
    seeds (B,) and an optional (B, n) column scale (``resolve_stream``).

    Each step walks a chunk of n in fixed _MICRO-column micro-tiles and
    generates S one (B, m, _MICRO) micro-tile at a time, as the reference
    does, so the sequence of partial products, and so the result bit for
    bit, does not depend on ``chunk_cols``: zero padding adds exact zeros.
    In bf16 and int8 mode the scaled S micro-tile and the A slice are
    rounded to bf16 elementwise, which keeps that invariance per dtype. The
    live sketch state is one micro-tile: its int64 hash words, 8·B·m·_MICRO
    bytes, are the pass's largest new tensor (the one-touch rule's budget,
    ``analysis.audit.rules``)."""
    n, d = A.shape[-2], A.shape[-1]
    B = seeds.shape[0]
    check_caps(n, m)
    ct = contract_dtype(compute_dtype)
    if A.dtype == torch.int8 and ct != torch.bfloat16:
        raise ValueError("int8 codes stream only in the bf16/int8 modes")
    k = max(1, -(-chunk_cols // _MICRO))
    k = min(k, -(-n // _MICRO))
    chunk = k * _MICRO
    pad = (-n) % chunk
    if pad:
        A = torch.nn.functional.pad(A, (0, 0, 0, pad))
        if scale is not None:
            scale = torch.nn.functional.pad(scale, (0, pad))
    acc = torch.zeros((B, m, d), dtype=torch.float32, device=A.device)
    for c0 in range(0, n + pad, chunk):
        for i in range(k):
            c = c0 + i * _MICRO
            s_mu = gaussian_tile(seeds, 0, c, (m, _MICRO))
            if scale is not None:
                s_mu = s_mu * scale[:, None, c:c + _MICRO]
            a_mu = round_to(A[..., c:c + _MICRO, :], ct)
            acc = acc + torch.matmul(round_to(s_mu, ct), a_mu)
    return acc


def entry_mismatches() -> int:
    """On the card: over all 2^24 values of u1 and of u2, how many values of
    the two factors of the kernel's branch-free Box–Muller
    (``csrc/gaussian_sa.cu``), the radius sqrt(-2·log u1) and the cosine
    cos(2π·u2), differ from the CUDA math library's logf/sqrtf and cosf; 0
    when both are bitwise equal, and then so is every entry, their product."""
    count = _build.load("gaussian_sa").gaussian_entry_mismatches()
    if count < 0:
        raise RuntimeError(f"gaussian_entry_mismatches failed with cudaError_t {-count}")
    return count


def gaussian_sa_cuda(A: torch.Tensor, seeds: torch.Tensor, m: int, *,
                     scale: torch.Tensor | None = None,
                     compute_dtype: str | None = None) -> torch.Tensor:
    """Launch ``csrc/gaussian_sa.cu`` on the current stream: same contract
    as ``gaussian_sa_ref``, for CUDA tensors."""
    shared = A.dim() == 2
    n, d = A.shape[-2], A.shape[-1]
    B = seeds.shape[0]
    check_caps(n, m)
    kind = _build.a_kind(A.dtype, contract_dtype(compute_dtype) == torch.bfloat16)
    if kind is None or not A.is_contiguous():
        raise ValueError(
            f"gaussian_sa kernel takes a contiguous A of fp32 (any mode), bf16 "
            f"or int8 codes (bf16/int8 modes); got {A.dtype} in "
            f"{canonical_compute_dtype(compute_dtype)} mode")
    if seeds.dtype != torch.int64 or seeds.shape != (B,):
        raise ValueError("gaussian_sa kernel takes (B,) int64 seeds")
    if not shared and A.shape[0] != B:
        raise ValueError(f"A batch {A.shape[0]} != seeds batch {B}")
    seeds = seeds.contiguous()
    if scale is not None:
        if scale.dtype != torch.float32 or scale.shape != (B, n):
            raise ValueError(f"scale must be ({B}, {n}) fp32")
        scale = scale.contiguous()
    for name, t in (("A", A), ("seeds", seeds), ("scale", scale)):
        if t is not None and t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
    out = torch.empty((B, m, d), dtype=torch.float32, device=A.device)
    lib = _build.load("gaussian_sa")
    code = lib.gaussian_sa_launch(
        A.data_ptr(), 0 if shared else n * d, seeds.data_ptr(),
        None if scale is None else scale.data_ptr(), out.data_ptr(),
        B, n, d, m, kind, torch.cuda.current_stream(A.device).cuda_stream)
    _build.check_launch(code, "gaussian_sa")
    return out
