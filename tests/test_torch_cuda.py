"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (these kernels
have no CPU or interpret mode). On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py --noconftest

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card does
not need and may not have.)
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fwht as tf  # noqa: E402
from repro_torch.kernels import gaussian_gram as tg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("n,d,m", [(777, 130, 70), (256, 32, 64), (4096, 256, 512)])
def test_gaussian_sa_kernel_matches_plain(dev, shared, scaled, n, d, m):
    """Ragged tiles included. Tolerance 1e-4 of max|SA|: the sketch entries
    are the same hash and Box–Muller; fp32 sums of n products taken in two
    orders differ by about sqrt(n)·2^-24 of the result's scale."""
    B = 3
    g = torch.Generator(device=dev).manual_seed(n + d)
    A = torch.randn((n, d) if shared else (B, n, d), generator=g, device=dev)
    seeds = torch.randint(0, 2 ** 32, (B,), generator=g, device=dev, dtype=torch.int64)
    w = torch.rand((B, n), generator=g, device=dev) + 0.5 if scaled else None
    leg = ops.leg("gaussian_sa", "fp32", weighted=scaled)
    before = ops.LAUNCHES[leg]
    got = ops.gaussian_sa(A, seeds, m, row_weights=w)
    assert ops.LAUNCHES[leg] == before + 1
    want = tg.gaussian_sa_ref(A, seeds, m, scale=None if w is None else torch.sqrt(w))
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("n", [1, 8, 1024, 2048, 16384])
@pytest.mark.parametrize("d", [1, 33, 256])
@pytest.mark.parametrize("scaled", [False, True])
def test_fwht_kernel_bitwise_plain(dev, n, d, scaled):
    """The kernel's passes run the one-pass butterfly's stages in the same
    order with the same fp32 adds: bitwise equal to the plain version."""
    B = 2
    g = torch.Generator(device=dev).manual_seed(n * 7 + d)
    X = torch.randn((B, n, d), generator=g, device=dev)
    s = (torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
         if scaled else None)
    before = ops.LAUNCHES["fwht"]
    got = ops.fwht_cols(X, row_scale=s)
    assert ops.LAUNCHES["fwht"] == before + len(tf.split_plan(n))
    want = tf.fwht_ref(X if s is None else X * s[:, :, None])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fwht_kernel_shared_input(dev):
    """A shared (n, d) input is read at batch stride 0 for every problem."""
    B, n, d = 3, 4096, 20
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((n, d), generator=g, device=dev)
    s = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    got = ops.fwht_cols(X, row_scale=s, batch=B)
    assert torch.equal(got, tf.fwht_ref(X[None] * s[:, :, None]))


# (A dtype, compute_dtype) of each AKind: fp32 A, fp32 A rounded to bf16,
# bf16 A, int8 codes
A_KINDS = [(torch.float32, "fp32"), (torch.float32, "bf16"), (torch.bfloat16, "bf16"),
           (torch.int8, "int8")]


def _gaussian_inputs(dev, B, n, d, shared, a_dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((n, d) if shared else (B, n, d), generator=g, device=dev)
    seeds = torch.randint(0, 2 ** 32, (B,), generator=g, device=dev, dtype=torch.int64)
    scale = None
    if a_dtype == torch.int8:
        A, scale = tg.resolve_stream(A, B, None, "int8")
        scale = scale.contiguous()
    return A.to(a_dtype) if a_dtype != torch.int8 else A, seeds, scale


@pytest.mark.parametrize("a_dtype,compute_dtype", A_KINDS)
@pytest.mark.parametrize("shared", [False, True])
def test_gaussian_sa_repeats_bitwise(dev, a_dtype, compute_dtype, shared):
    """No atomics and a fixed order of the partial sums: two launches on the
    same inputs are bitwise equal, in every AKind, per-problem and shared A."""
    B, n, d, m = 4, 1000, 200, 130
    A, seeds, scale = _gaussian_inputs(dev, B, n, d, shared, a_dtype, 5)
    first = tg.gaussian_sa_cuda(A, seeds, m, scale=scale, compute_dtype=compute_dtype)
    again = tg.gaussian_sa_cuda(A, seeds, m, scale=scale, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.parametrize("a_dtype,compute_dtype", A_KINDS)
@pytest.mark.parametrize("B,n,d,m", [(3, 300, 9, 16), (1, 777, 130, 70), (2, 1001, 200, 65),
                                     (1, 4096, 256, 512), (2, 33, 300, 100)])
def test_gaussian_sa_ragged_tiles(dev, a_dtype, compute_dtype, B, n, d, m):
    """The tiling's ragged edges against the plain version: d not a multiple
    of 8 (nor of 4, for the fp32 tile's vector loads), m not a multiple of the
    64-row tile, n not a multiple of the 16-column step, d over one 256-column
    tile, and B = 1. Tolerances as in the tests above: 1e-4 of max|SA| in
    fp32; in the reduced modes also one bf16 flip of an S entry per output
    entry, 2^-8·max|S·scale|·max|A|."""
    A, seeds, scale = _gaussian_inputs(dev, B, n, d, False, a_dtype, n + d + m)
    got = tg.gaussian_sa_cuda(A, seeds, m, scale=scale, compute_dtype=compute_dtype)
    want = tg.gaussian_sa_ref(A, seeds, m, scale=scale, compute_dtype=compute_dtype)
    atol = 1e-4 * float(want.abs().max())
    if compute_dtype != "fp32":
        S = tg.gaussian_s_dense(seeds, m, n)
        s_max = float((S * (1.0 if scale is None else scale[:, None, :])).abs().max())
        atol += 2.0 ** -8 * s_max * float(A.float().abs().max())
    torch.cuda.synchronize()
    assert got.shape == (B, m, d)
    assert float((got - want).abs().max()) <= atol


def test_gaussian_entry_matches_libm_exhaustively(dev):
    """The factors of the kernel's branch-free Box–Muller, the radius of u1
    and the cosine of u2, are bitwise the CUDA math library's logf/sqrtf and
    cosf on every one of the 2^24 values of u1 and of u2."""
    assert tg.entry_mismatches() == 0


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("n", [4096, 8192, 16384, 32768])
def test_fwht_cluster_launches_bitwise_plain(dev, compute_dtype, n):
    """Up to n = 16384 the transform is one launch (one cluster of up to 8
    blocks per column group); n = 32768 is the radix split's two. Bitwise
    the one-pass butterfly in every leg."""
    from repro_torch.dist.compress import quantize_rows

    B, d = 2, 40
    g = torch.Generator(device=dev).manual_seed(n + len(compute_dtype))
    X = torch.randn((B, n, d), generator=g, device=dev)
    s = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    if compute_dtype == "int8":
        X = quantize_rows(X)[0]
    got, launches = tf.fwht_passes_cuda(X, s, compute_dtype=compute_dtype)
    assert launches == (1 if n <= 16384 else 2)
    tile = torch.float32 if compute_dtype == "fp32" else torch.bfloat16
    want = tf.fwht_ref(X.to(tile) * s.to(tile)[:, :, None])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert tf.active_clusters(min(n, 16384), X.dtype, tile) > 0


def test_engine_on_card_matches_cpu(dev):
    """The padded engine on the card (through both kernels) and on the CPU
    (through the plain versions) give the same certificates: status and
    m_final equal, iters within ±2. Each x is within max(1e-4,
    2^-24·κ(H)·√k) of the fp64 solution in the energy norm, k its PCG
    iterations: the attainable accuracy of fp32 PCG, whose recursive
    residual drifts from the true one (this batch reaches κ(H) ≈ 2.5e3)."""
    from repro_torch.core.adaptive_padded import padded_adaptive_solve_batched
    from repro_torch.core.quadratic import from_least_squares_batch

    B, n, d = 4, 2048, 64
    g = torch.Generator().manual_seed(0)
    U, _ = torch.linalg.qr(torch.randn((B, n, d), generator=g))
    V, _ = torch.linalg.qr(torch.randn((B, d, d), generator=g))
    A = (U * (0.9 ** torch.arange(d))[None, None, :]) @ V.transpose(1, 2)
    Y = torch.randn((B, n), generator=g)
    nus = torch.tensor([0.3, 0.1, 0.05, 0.02])
    seeds = torch.tensor([1, 2, 3, 4], dtype=torch.int64)
    A64 = A.double()
    H = A64.transpose(1, 2) @ A64 + torch.diag_embed(
        (nus.double() ** 2)[:, None].expand(B, d))
    x64 = torch.linalg.solve(H, (A64.transpose(1, 2) @ Y.double()[:, :, None]))[..., 0]
    ev = torch.linalg.eigvalsh(H)
    kappa = ev[:, -1] / ev[:, 0]
    for sketch in ("gaussian", "srht"):
        out = {}
        for where in ("cpu", "cuda"):
            q = from_least_squares_batch(A.to(where), Y.to(where), nus.to(where))
            x, st = padded_adaptive_solve_batched(
                q, seeds.to(where), m_max=128, method="pcg", sketch=sketch,
                max_iters=100, device=where)
            k = st["iters"].cpu().clamp(min=1).double()
            tol = torch.clamp(2.0 ** -24 * kappa * k.sqrt(), min=1e-4)
            e = x.cpu().double() - x64
            err = torch.sqrt(torch.einsum("bi,bij,bj->b", e, H, e)
                             / torch.einsum("bi,bij,bj->b", x64, H, x64))
            assert bool((err <= tol).all()), (sketch, where, err, tol)
            out[where] = {k: v.cpu() for k, v in st.items()}
        for k in ("status", "m_final"):
            assert torch.equal(out["cuda"][k], out["cpu"][k]), (sketch, k)
        assert int((out["cuda"]["iters"] - out["cpu"]["iters"]).abs().max()) <= 2


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("n,d,M", [(300, 9, 16), (777, 300, 64), (4096, 256, 512),
                                   (2048, 130, 1)])
def test_sjlt_kernel_matches_plain(dev, compute_dtype, shared, n, d, M):
    """Ragged tiles, out-of-range targets (negative and ≥ M) and all three
    modes. Against the plain version on the card (index_add_ with atomics,
    so another order of the fp32 sums of exact products): 1e-5 of max|SA|.
    Against the plain version on the CPU, whose index_add_ adds in
    increasing i as the kernel does: bitwise."""
    from repro_torch.kernels import sjlt as ts

    B = 3
    g = torch.Generator(device=dev).manual_seed(n + d + M)
    A = torch.randn((n, d) if shared else (B, n, d), generator=g, device=dev)
    rows = torch.randint(-2, M + 3, (B, n), generator=g, device=dev, dtype=torch.int32)
    signs = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    before = ops.LAUNCHES[ops.leg("sjlt", compute_dtype)]
    got = ops.sjlt_apply_batched(A, rows, signs, M, compute_dtype=compute_dtype)
    assert ops.LAUNCHES[ops.leg("sjlt", compute_dtype)] == before + 1
    want = ts.sjlt_ref_batched(A, rows, signs, M, compute_dtype)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    cpu = ts.sjlt_ref_batched(A.cpu(), rows.cpu(), signs.cpu(), M, compute_dtype)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("B,n,d,M", [(1, 4096, 256, 512), (2, 20000, 130, 64)])
def test_sjlt_kernel_single_problem_and_multichunk(dev, compute_dtype, shared, B, n, d, M):
    """B = 1 at the top class's n, d and M (the segment sum takes narrow
    column slices to fill the card) and n = 20000 (the bucket pass's
    multi-chunk form), held as in test_sjlt_kernel_matches_plain: 1e-5 of
    max|SA| against the plain version on the card, bitwise against the CPU,
    and one launch count for the pass."""
    from repro_torch.kernels import sjlt as ts

    g = torch.Generator(device=dev).manual_seed(n + d + M)
    A = torch.randn((n, d) if shared else (B, n, d), generator=g, device=dev)
    rows = torch.randint(-2, M + 3, (B, n), generator=g, device=dev, dtype=torch.int32)
    signs = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    assert (ts.bucket_chunk(B, n, M) > 0) == (n > ts.CLUSTER_MAX_N)
    before = ops.LAUNCHES[ops.leg("sjlt", compute_dtype)]
    got = ops.sjlt_apply_batched(A, rows, signs, M, compute_dtype=compute_dtype)
    assert ops.LAUNCHES[ops.leg("sjlt", compute_dtype)] == before + 1
    want = ts.sjlt_ref_batched(A, rows, signs, M, compute_dtype)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    cpu = ts.sjlt_ref_batched(A.cpu(), rows.cpu(), signs.cpu(), M, compute_dtype)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("shape", [(20000, 130), (3, 4096, 256)])
def test_quantize_rows_matches_cpu(dev, shape):
    """The int8 mode's quantization gives the CPU's codes and scales
    bitwise on the card: max|row|/127 by true division (a CUDA division by a
    Python scalar multiplies by its reciprocal, one ulp off on some rows),
    and the codes rounded from the same scales."""
    from repro_torch.dist.compress import quantize_rows

    g = torch.Generator(device=dev).manual_seed(shape[-2])
    v = torch.randn(shape, generator=g, device=dev)
    v[..., 7, :] = 0.0                                 # an all-zero row: scale 0
    codes, scales = quantize_rows(v)
    cpu_codes, cpu_scales = quantize_rows(v.cpu())
    assert torch.equal(scales.cpu(), cpu_scales)
    assert torch.equal(codes.cpu(), cpu_codes)


@pytest.mark.parametrize("B,n,M", [(3, 300, 16), (1, 4096, 512), (16, 4096, 512),
                                   (3, 2048, 1), (2, 20000, 64), (2, 3000, 5000)])
def test_sjlt_buckets_match_model(dev, B, n, M):
    """The bucket pass against its CPU model ``sjlt_buckets_ref``, exactly:
    offsets, order and the gathered signs, with targets outside [0, M).
    n = 20000 and M = 5000 (whose counts do not fit a block's shared memory)
    take the multi-chunk form."""
    from repro_torch.kernels import sjlt as ts

    g = torch.Generator(device=dev).manual_seed(B + n + M)
    rows = torch.randint(-2, M + 3, (B, n), generator=g, device=dev, dtype=torch.int32)
    signs = torch.randn((B, n), generator=g, device=dev)
    A = torch.randn((n, 8), generator=g, device=dev)
    assert (ts.bucket_chunk(B, n, M) > 0) == (n > ts.CLUSTER_MAX_N or M == 5000)
    got = ts.sjlt_launch_buckets(A, rows, signs, M)
    want = ts.sjlt_buckets_ref(rows.cpu(), signs.cpu(), M)
    torch.cuda.synchronize()
    for name, x, y in zip(("offsets", "order", "order_s"), got, want):
        assert torch.equal(x.cpu(), y), name


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16", "int8"])
def test_sjlt_kernel_repeats_bitwise(dev, compute_dtype):
    """No atomics: two launches on the same inputs are bitwise equal, and
    the single-problem form is the batched kernel's B = 1 shared-A case."""
    from repro_torch.kernels import sjlt as ts

    B, n, d, M = 16, 4096, 256, 512
    g = torch.Generator(device=dev).manual_seed(1)
    A = torch.randn((B, n, d), generator=g, device=dev)
    rows = torch.randint(0, M, (B, n), generator=g, device=dev, dtype=torch.int32)
    signs = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    first = ts.sjlt_cuda_batched(A, rows, signs, M, compute_dtype)
    assert torch.equal(ts.sjlt_cuda_batched(A, rows, signs, M, compute_dtype), first)
    one = ts.sjlt_cuda(A[0], rows[0], signs[0], M, compute_dtype)
    assert torch.equal(one, ts.sjlt_cuda_batched(A[0], rows[:1], signs[:1], M,
                                                 compute_dtype)[0])
    assert torch.equal(one.cpu(), ts.sjlt_ref(A[0].cpu(), rows[0].cpu(), signs[0].cpu(),
                                              M, compute_dtype))


@pytest.mark.parametrize("compute_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("n,d,m", [(777, 130, 70), (4096, 256, 512)])
def test_gaussian_sa_reduced_legs_match_plain(dev, compute_dtype, shared, scaled, n, d, m):
    """The bf16 and int8 legs against the plain version on the card: fp32
    sums in another order (1e-4 of max|SA|), plus one bf16 flip of an S entry
    per output entry, 2^-8·max|S·scale|·max|A|, where the kernel's logf/cosf
    and torch's log/cos put the entry on two sides of a bf16 boundary."""
    B = 3
    g = torch.Generator(device=dev).manual_seed(n + d + 1)
    A = torch.randn((n, d) if shared else (B, n, d), generator=g, device=dev)
    seeds = torch.randint(0, 2 ** 32, (B,), generator=g, device=dev, dtype=torch.int64)
    w = torch.rand((B, n), generator=g, device=dev) + 0.5 if scaled else None
    leg = ops.leg("gaussian_sa", compute_dtype, weighted=scaled)
    before = ops.LAUNCHES[leg]
    got = ops.gaussian_sa(A, seeds, m, row_weights=w, compute_dtype=compute_dtype)
    assert ops.LAUNCHES[leg] == before + 1
    A_s, scale = tg.resolve_stream(A, B, w, compute_dtype)
    want = tg.gaussian_sa_ref(A_s, seeds, m, scale=scale, compute_dtype=compute_dtype)
    S = tg.gaussian_s_dense(seeds, m, n)
    s_max = float((S * (1.0 if scale is None else scale[:, None, :])).abs().max())
    atol = 1e-4 * float(want.abs().max()) + 2.0 ** -8 * s_max * float(A_s.float().abs().max())
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= atol


@pytest.mark.parametrize("compute_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n", [8, 2048, 16384])
@pytest.mark.parametrize("d", [1, 33, 256])
def test_fwht_reduced_legs_bitwise_plain(dev, compute_dtype, n, d):
    """bf16 tiles: the input (fp32, or int8 codes) and the row scale cast to
    bf16, their product and every stage rounded to bf16. Bitwise the
    one-pass bf16 butterfly; a bf16 result."""
    from repro_torch.dist.compress import quantize_rows

    B = 2
    g = torch.Generator(device=dev).manual_seed(n * 5 + d)
    X = torch.randn((B, n, d), generator=g, device=dev)
    s = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    s = s * (torch.rand((B, n), generator=g, device=dev) + 0.5)
    if compute_dtype == "int8":
        X = quantize_rows(X)[0]
    leg = ops.leg("fwht", compute_dtype)
    before = ops.LAUNCHES[leg]
    got = ops.fwht_cols(X, row_scale=s, compute_dtype=compute_dtype)
    assert ops.LAUNCHES[leg] == before + len(tf.split_plan(n))
    bf = torch.bfloat16
    want = tf.fwht_ref(X.to(bf) * s.to(bf)[:, :, None])
    torch.cuda.synchronize()
    assert got.dtype == bf and torch.equal(got, want)


def test_fwht_bf16_shared_input(dev):
    """A shared fp32 (n, d) input, read at batch stride 0, in the bf16 leg."""
    B, n, d = 3, 16384, 20
    g = torch.Generator(device=dev).manual_seed(3)
    X = torch.randn((n, d), generator=g, device=dev)
    s = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    got = ops.fwht_cols(X, row_scale=s, batch=B, compute_dtype="bf16")
    bf = torch.bfloat16
    assert torch.equal(got, tf.fwht_ref(X.to(bf)[None] * s.to(bf)[:, :, None]))


@pytest.mark.parametrize("sketch,compute_dtype", [("sjlt", "fp32"), ("sjlt", "bf16"),
                                                  ("sjlt", "int8"), ("gaussian", "bf16"),
                                                  ("gaussian", "int8"), ("srht", "int8")])
def test_engine_modes_on_card_match_cpu(dev, sketch, compute_dtype):
    """The padded engine on the card (through the kernel legs) and on the CPU
    (through the plain versions) in each family and mode: status and m_final
    equal, iters within ±2, and each x within max(1e-4, 2^-24·κ(H)·√k) of
    the fp64 solution in the energy norm, as in the fp32 test above."""
    from repro_torch.core.adaptive_padded import padded_adaptive_solve_batched
    from repro_torch.core.quadratic import from_least_squares_batch

    B, n, d = 4, 2048, 64
    g = torch.Generator().manual_seed(0)
    U, _ = torch.linalg.qr(torch.randn((B, n, d), generator=g))
    V, _ = torch.linalg.qr(torch.randn((B, d, d), generator=g))
    A = (U * (0.9 ** torch.arange(d))[None, None, :]) @ V.transpose(1, 2)
    Y = torch.randn((B, n), generator=g)
    nus = torch.tensor([0.3, 0.1, 0.05, 0.02])
    seeds = torch.tensor([1, 2, 3, 4], dtype=torch.int64)
    A64 = A.double()
    H = A64.transpose(1, 2) @ A64 + torch.diag_embed(
        (nus.double() ** 2)[:, None].expand(B, d))
    x64 = torch.linalg.solve(H, (A64.transpose(1, 2) @ Y.double()[:, :, None]))[..., 0]
    ev = torch.linalg.eigvalsh(H)
    kappa = ev[:, -1] / ev[:, 0]
    out = {}
    for where in ("cpu", "cuda"):
        q = from_least_squares_batch(A.to(where), Y.to(where), nus.to(where))
        x, st = padded_adaptive_solve_batched(
            q, seeds.to(where), m_max=128, method="pcg", sketch=sketch,
            max_iters=100, compute_dtype=compute_dtype, device=where)
        k = st["iters"].cpu().clamp(min=1).double()
        tol = torch.clamp(2.0 ** -24 * kappa * k.sqrt(), min=1e-4)
        e = x.cpu().double() - x64
        err = torch.sqrt(torch.einsum("bi,bij,bj->b", e, H, e)
                         / torch.einsum("bi,bij,bj->b", x64, H, x64))
        assert bool((err <= tol).all()), (where, err, tol)
        out[where] = {k: v.cpu() for k, v in st.items()}
    for k in ("status", "m_final"):
        assert torch.equal(out["cuda"][k], out["cpu"][k]), k
    assert int((out["cuda"]["iters"] - out["cpu"]["iters"]).abs().max()) <= 2


@pytest.mark.parametrize("segment_trips", [8, 32])
@pytest.mark.parametrize("method", ["ihs", "pcg", "polyak"])
def test_segmented_bitwise_monolithic_on_card(dev, method, segment_trips):
    """The segmented driver on the card at the top class's width (n = 4096,
    d = 256, m_max = 512) with B = 4: x and every certificate bitwise the
    monolithic solve's (the same trips in the same order, through the
    Gaussian kernel)."""
    from repro_torch.core.adaptive_padded import padded_adaptive_solve_batched
    from repro_torch.core.quadratic import from_least_squares_batch
    from repro_torch.core.robust import segmented_padded_solve_batched

    B, n, d = 4, 4096, 256
    g = torch.Generator(device=dev).manual_seed(1)
    U, _ = torch.linalg.qr(torch.randn((B, n, d), generator=g, device=dev))
    V, _ = torch.linalg.qr(torch.randn((B, d, d), generator=g, device=dev))
    A = (U * (0.95 ** torch.arange(d, device=dev))[None, None, :]) @ V.transpose(1, 2)
    Y = torch.randn((B, n), generator=g, device=dev)
    q = from_least_squares_batch(A, Y, torch.tensor([0.1, 0.03, 0.01, 0.003], device=dev))
    seeds = torch.tensor([11, 12, 13, 14], dtype=torch.int64, device=dev)
    kw = dict(m_max=512, method=method, max_iters=200, device=dev)
    before = ops.LAUNCHES["gaussian_sa"]
    x_ref, s_ref = padded_adaptive_solve_batched(q, seeds, **kw)
    x, s = segmented_padded_solve_batched(q, seeds, segment_trips=segment_trips, **kw)
    assert ops.LAUNCHES["gaussian_sa"] == before + 2
    assert torch.equal(x, x_ref)
    for k in ("status", "m_final", "iters", "dtilde", "level", "doublings", "trips"):
        assert torch.equal(s[k], s_ref[k]), k
    assert s["segments"] == -(-int(s_ref["trips"]) // segment_trips)


def _weighted_batch(B, n, d, seed):
    """A weighted batch built on the CPU: A (B, n, d), Newton-like weights
    in (0, 1/4] with a few rows dropped, b, ν and Λ."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((B, n, d), generator=g) / n ** 0.5
    w = 0.02 + 0.23 * torch.rand((B, n), generator=g)
    w[torch.rand((B, n), generator=g) < 0.05] = 0.0
    b = torch.randn((B, d), generator=g)
    return A, w, b


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("family", ["gaussian", "gaussian_dense", "sjlt", "srht"])
def test_weighted_level_grams_on_card_match_cpu(dev, family, compute_dtype):
    """The weighted one-touch pass on the card (the weights folded into the
    Gaussian column scale, the SJLT signs or the FWHT row scale) against the
    plain version on the CPU, inputs built on the CPU, at the top class's
    width: every ladder level within 1e-5 of its largest entry (SJLT and
    FWHT: the same products; the Grams sum in another order). The Gaussian
    families add what the SA tolerances above carry into a Gram,
    2·max|SA|·δ + δ², δ = 1e-4·max|SA| plus, in the reduced legs, one bf16
    flip of an S entry (2^-8·max|S·scale|·max|A|)."""
    from repro_torch.core.adaptive_padded import doubling_ladder
    from repro_torch.core.level_grams import get_provider
    from repro_torch.core.quadratic import Quadratic

    B, n, d, m_max = 4, 4096, 256, 512
    A, w, b = _weighted_batch(B, n, d, 3)
    seeds = torch.tensor([7, 8, 9, 10], dtype=torch.int64)
    prov, ladder = get_provider(family), doubling_ladder(m_max)
    leg = ops.leg({"srht": "fwht", "sjlt": "sjlt"}.get(family, "gaussian_sa"),
                  compute_dtype, weighted=family == "gaussian")
    grams = []
    for device in ("cpu", dev):
        q = Quadratic(A=A.to(device), b=b.to(device), nu=torch.ones(B, device=device),
                      lam_diag=torch.ones((B, d), device=device), batched=True,
                      row_weights=w.to(device))
        data = {k: v.to(device) for k, v in prov.sample(seeds, m_max, n).items()}
        before = ops.LAUNCHES[leg]
        grams.append(prov.level_grams(data, q, ladder, compute_dtype=compute_dtype).cpu())
        launched = ops.LAUNCHES[leg] - before
        assert launched == (0 if device == "cpu" or family == "gaussian_dense" else 1)
    want, got = grams
    if family.startswith("gaussian"):
        from repro_torch.kernels.gaussian_gram import gaussian_s_dense, resolve_stream

        A_s, scale = resolve_stream(A, B, w, compute_dtype)
        s_max = float((gaussian_s_dense(seeds, m_max, n) * scale[:, None, :]).abs().max())
        flip = 0.0 if compute_dtype == "fp32" else 2.0 ** -8 * s_max * float(
            A_s.float().abs().max())
    for lvl, m in enumerate(ladder):
        atol = 1e-5 * float(want[lvl].abs().max())
        if family.startswith("gaussian"):
            # max|SA| over the level's rows, from the Gram's diagonal (m·G_jj)
            sa_max = float(want[lvl].diagonal(dim1=-2, dim2=-1).max() * m) ** 0.5
            delta = 1e-4 * sa_max + flip
            atol += 2.0 * sa_max * delta + delta ** 2
        assert float((got[lvl] - want[lvl]).abs().max()) <= atol, (lvl, m)


@pytest.mark.parametrize("sketch,compute_dtype", [("gaussian", "fp32"), ("gaussian", "bf16"),
                                                  ("sjlt", "int8"), ("srht", "fp32")])
def test_path_bitwise_looped_single_lambda_on_card(dev, sketch, compute_dtype):
    """On the card, a path with warm start off is bitwise a per-ν loop of
    single solves, handed the shared ladder or recomputing it inline: the
    kernels have no atomics, and nothing reduces over the batch."""
    from repro_torch.core import adaptive_padded as ap
    from repro_torch.core.quadratic import from_least_squares_batch

    B, n, d, m_max, P = 4, 2048, 128, 256, 4
    g = torch.Generator().manual_seed(2)
    A = (torch.randn((B, n, d), generator=g) / n ** 0.5).to(dev)
    q = from_least_squares_batch(A, torch.randn((B, n), generator=g).to(dev),
                                 torch.ones(B, device=dev))
    seeds = torch.tensor([3, 4, 5, 6], dtype=torch.int64, device=dev)
    nus = torch.tensor([1.0, 0.3, 0.1, 0.03], device=dev)
    lvl = torch.full((B,), 3, dtype=torch.int64, device=dev)
    kw = dict(m_max=m_max, method="pcg", sketch=sketch, max_iters=200,
              compute_dtype=compute_dtype, device=dev)
    xs, st = ap.padded_path_solve_batched(q, seeds, nus, init_level=lvl, warm_start=False, **kw)
    grams, gfull = ap.prepare_path_ladder(q, seeds, m_max=m_max, sketch=sketch,
                                          compute_dtype=compute_dtype, device=dev)
    for p in range(P):
        q_p = dataclasses.replace(q, nu=torch.full((B,), float(nus[p]), device=dev))
        x_sh, s_sh = ap.padded_adaptive_solve_batched(q_p, seeds, init_level=lvl, grams=grams,
                                                      gram_full=gfull, **kw)
        x_in, s_in = ap.padded_adaptive_solve_batched(q_p, seeds, init_level=lvl, **kw)
        assert torch.equal(xs[p], x_sh) and torch.equal(xs[p], x_in), p
        for k in ("dtilde", "m_final", "iters", "status"):
            assert torch.equal(st[k][p], s_sh[k]) and torch.equal(st[k][p], s_in[k]), (p, k)


@pytest.mark.parametrize("sketch", ["gaussian", "sjlt"])
def test_ladder_cache_repeat_bitwise_on_card(dev, sketch):
    """The service on the card under ``ladder_cache=True``: the same path
    traffic twice; the second round hits the cache (no sketch kernel
    launched, sketch_passes 0) and every answer is bitwise the first's."""
    from repro_torch.serve.solver_service import SolverService

    svc = SolverService(batch_size=4, sketch=sketch, ladder_cache=True, device=dev)
    g = torch.Generator().manual_seed(5)
    reqs = [(torch.randn((600 + 100 * i, 60), generator=g) / 30.0,
             torch.randn(600 + 100 * i, generator=g)) for i in range(4)]
    nus = (1.0, 0.3, 0.1, 0.03)
    rounds = []
    for _ in range(2):
        before = dict(ops.LAUNCHES)
        ids = [svc.submit_path(A, y, nus) for A, y in reqs]
        sols = svc.flush()
        torch.cuda.synchronize()
        rounds.append(([sols[i] for i in ids],
                       sum(ops.LAUNCHES[k] - before[k] for k in before)))
    (cold, l_cold), (warm, l_warm) = rounds
    assert l_cold > 0 and l_warm == 0
    assert svc.stats["sketch_passes_saved"] == 1
    for a, b in zip(cold, warm):
        assert not a.cache_hit and a.sketch_passes == 1
        assert b.cache_hit and b.sketch_passes == 0 and b.converged
        for pa, pb in zip(a.points, b.points):
            assert torch.equal(pa.x, pb.x)
            assert (pa.delta_tilde, pa.m_final, pa.iters, pa.status) == \
                (pb.delta_tilde, pb.m_final, pb.iters, pb.status)


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("family", ["gaussian", "sjlt", "fwht"])
@pytest.mark.parametrize("where", ["A", "scale"])
def test_kernel_nan_isolation(dev, family, compute_dtype, where):
    """Every kernel leg confines a NaN to its own problem: a NaN row of one
    problem's A, or a NaN in one problem's row weight (the Gaussian column
    scale, the SJLT signs) or FWHT row scale, makes that problem's output
    non-finite, and every other problem's output is bitwise the clean
    launch's. (An int8 NaN row has undefined codes; its NaN scale carries
    the poison.)"""
    B, n, d, m = 5, 1000, 40, 64
    g = torch.Generator().manual_seed(3)            # inputs built on the CPU
    A = torch.randn((B, n, d), generator=g).to(dev)
    w = (torch.rand((B, n), generator=g) + 0.5).to(dev)
    rows = torch.randint(0, m, (B, n), generator=g, dtype=torch.int32).to(dev)
    signs = torch.where(torch.rand((B, n), generator=g) < 0.5, -1.0, 1.0).to(dev)
    seeds = torch.randint(0, 2 ** 32, (B,), generator=g, dtype=torch.int64).to(dev)
    bad = 3

    def run(A, w):
        if family == "gaussian":
            return ops.gaussian_sa(A, seeds, m, row_weights=w, compute_dtype=compute_dtype)
        if family == "sjlt":
            return ops.sjlt_apply_batched(A, rows, signs, m, row_weights=w,
                                          compute_dtype=compute_dtype)
        return ops.fwht_cols(torch.nn.functional.pad(A, (0, 0, 0, 1024 - n)),
                             row_scale=torch.nn.functional.pad(signs * w, (0, 1024 - n)),
                             compute_dtype=compute_dtype)

    A_bad, w_bad = A.clone(), w.clone()
    if where == "A":
        A_bad[bad, 17, :] = float("nan")
    else:
        w_bad[bad, 17] = float("nan")
    before = dict(ops.LAUNCHES)
    clean, out = run(A, w), run(A_bad, w_bad)
    torch.cuda.synchronize()
    assert sum(ops.LAUNCHES[k] - before[k] for k in before) >= 2
    assert not bool(torch.isfinite(out[bad]).all())
    keep = [i for i in range(B) if i != bad]
    assert bool(torch.isfinite(clean).all())
    assert torch.equal(out[keep], clean[keep])


@pytest.mark.parametrize("sketch,compute_dtype", [("gaussian", "fp32"), ("srht", "fp32"),
                                                  ("sjlt", "int8")])
def test_preempt_resume_bitwise_on_card(dev, tmp_path, sketch, compute_dtype):
    """The segmented driver on the card, preempted at segment 2 with its
    state checkpointed, resumes from the checkpoint to answers bitwise an
    uninterrupted segmented run's, x and every certificate."""
    from repro_torch.core.quadratic import from_least_squares_batch
    from repro_torch.core.robust import PreemptedError, segmented_padded_solve_batched

    B, n, d = 4, 1024, 64
    g = torch.Generator().manual_seed(2)
    U, _ = torch.linalg.qr(torch.randn((B, n, d), generator=g))
    A = (U * (0.9 ** torch.arange(d))[None, None, :]).contiguous().to(dev)
    Y = torch.randn((B, n), generator=g).to(dev)
    q = from_least_squares_batch(A, Y, torch.tensor([0.1, 0.03, 0.01, 0.003], device=dev))
    seeds = torch.tensor([21, 22, 23, 24], dtype=torch.int64, device=dev)
    kw = dict(m_max=128, sketch=sketch, compute_dtype=compute_dtype, segment_trips=4,
              device=dev)
    x_ref, s_ref = segmented_padded_solve_batched(q, seeds, **kw)
    assert s_ref["segments"] >= 3

    class Stop:
        polls = 0

        @property
        def should_stop(self):
            self.polls += 1
            return self.polls > 2

    with pytest.raises(PreemptedError) as ei:
        segmented_padded_solve_batched(q, seeds, checkpoint=str(tmp_path), preempt=Stop(), **kw)
    assert ei.value.segment == 2
    x, s = segmented_padded_solve_batched(q, seeds, checkpoint=str(tmp_path), **kw)
    assert s["resumed"] and s["segments"] == s_ref["segments"] - 2
    assert torch.equal(x, x_ref)
    for k in ("status", "m_final", "iters", "dtilde", "level", "doublings", "trips"):
        assert torch.equal(s[k], s_ref[k]), k


@pytest.mark.parametrize("kind,body", [("gaussian", "_gauss_sa_kernel"),
                                       ("srht", "_fwht_kernel_scaled"),
                                       ("sjlt", "_sjlt_kernel")])
def test_paper_literal_sketch_legs_match_plain(dev, kind, body):
    """``core.sketches`` on the card launches the single-problem legs (the
    shared-A Gaussian, the SRHT's scaled FWHT in apply and unscaled in
    apply_t, the B = 1 SJLT) and agrees with the same sketch applied on the
    CPU by the plain versions: within 1e-4 of the scale for the Gaussian
    (fp32 sums of n products in two orders), 1e-5 for the SJLT (reordered
    sums), bitwise for the FWHT."""
    from repro_torch.core.sketches import Sketch, make_sketch

    n, d, m = 3000, 96, 256
    A = torch.randn((n, d), generator=torch.Generator().manual_seed(1))
    sk = make_sketch(kind, m, n, 12345, device=dev)
    sk_cpu = Sketch(kind, m, n, {k: v.cpu() for k, v in sk.data.items()})
    ops.reset_launches()
    got = sk.apply(A.to(dev))
    back = sk.apply_t(got)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES[body] == 1
    assert ops.BODY_LAUNCHES["_fwht_kernel"] == (1 if kind == "srht" else 0)
    want = sk_cpu.apply(A)
    tol = {"gaussian": 1e-4, "srht": 1e-6, "sjlt": 1e-5}[kind]
    assert float((got.cpu() - want).abs().max()) <= tol * float(want.abs().max())
    want_t = sk_cpu.apply_t(got.cpu())
    assert float((back.cpu() - want_t).abs().max()) <= 1e-5 * float(want_t.abs().max())


def test_adaptive_solve_on_card(dev):
    """The paper's adaptive PCG on the card, each family, against an fp64
    direct solve within 1e-3 in the H-norm."""
    from repro_torch.core import AdaptiveConfig, adaptive_solve
    from repro_torch.core.quadratic import from_least_squares

    n, d = 2048, 128
    g = torch.Generator().manual_seed(3)
    U, _ = torch.linalg.qr(torch.randn((n, d), generator=g))
    A = (U * 0.95 ** torch.arange(d)).contiguous()
    y = torch.randn(n, generator=g)
    H = A.double().T @ A.double() + 1e-4 * torch.eye(d, dtype=torch.float64)
    x64 = torch.linalg.solve(H, A.double().T @ y.double())
    q = from_least_squares(A.to(dev), y.to(dev), 1e-2)
    for kind in ("gaussian", "srht", "sjlt"):
        res = adaptive_solve(q, AdaptiveConfig(sketch=kind, tol=1e-8), seed=5, device=dev)
        e = res.x.cpu().double() - x64
        assert float(torch.sqrt(e @ H @ e / (x64 @ H @ x64))) < 1e-3
        assert res.m_final >= 8 and res.x.device.type == "cuda"


def test_sharded_pass_on_four_gloo_ranks_sharing_the_card(dev):
    """4 gloo ranks on the one card: the summed pass within 1e-6 of the
    one-process block emulation (the all-reduce adds in its own order), the
    per-shard form and ShardLadderCache.from_mesh bitwise."""
    from repro_torch.core.adaptive_padded import doubling_ladder
    from repro_torch.core.distributed import ShardLadderCache
    from repro_torch.core.level_grams import BlockEmulationProvider
    from repro_torch.core.quadratic import Quadratic
    from repro_torch.launch.mesh import run_ranks

    B, n, d, m_max, K = 4, 1024, 64, 64, 4
    g = torch.Generator().manual_seed(4)
    q = Quadratic(A=torch.randn((B, n, d), generator=g) / n ** 0.5, b=torch.zeros((B, d)),
                  nu=torch.ones(B), lam_diag=torch.ones((B, d)), batched=True)
    seeds = torch.tensor([1, 2, 3, 4], dtype=torch.int64)
    ladder = doubling_ladder(m_max)
    cases = [("gaussian", "fp32"), ("sjlt", "int8"), ("srht", "bf16")]
    res = run_ranks("repro_torch.launch.sharded:run_tasks", K, {"tasks": [
        (f"{f}/{c}", "pass", dict(q=q, seeds=seeds, ladder=ladder, sketch=f, compute_dtype=c))
        for f, c in cases]}, backend="gloo", device="cuda", timeout=600)
    qd = Quadratic(A=q.A.to(dev), b=q.b.to(dev), nu=q.nu.to(dev), lam_diag=q.lam_diag.to(dev),
                   batched=True)
    for f, c in cases:
        prov = BlockEmulationProvider(f, K)
        want = prov.level_grams(prov.sample(seeds.to(dev), m_max, n), qd, ladder,
                                compute_dtype=c).cpu()
        emu = ShardLadderCache.from_emulation(f, seeds.to(dev), qd, ladder, K, compute_dtype=c)
        got = res[0][f"{f}/{c}"]
        assert float((got["grams"] - want).abs().max()) <= 1e-6 * float(want.abs().max())
        assert torch.equal(got["per_shard"], emu.shard_grams.cpu())
        assert torch.equal(got["cache_total"], emu.total().cpu())


def test_gaussian_pass_peak_memory_at_top_class(dev):
    """At the top class (B, n, d, m_max) = (16, 4096, 256, 512) the one-touch
    Gaussian pass (sample, S·A in the kernel, the ladder Grams) allocates no
    more above its entry than the one-touch rule's budget, and its sketch
    (S·A with S generated on chip) less than a third of the dense S. The
    pass is measured after a warm call of itself: the first cuBLAS call of
    a process allocates a 32 MiB workspace that stays."""
    from repro_torch.analysis.audit.entrypoints import problem
    from repro_torch.analysis.audit.rules import gaussian_budget
    from repro_torch.analysis.memscan import peak_bytes_above_entry
    from repro_torch.core.adaptive_padded import doubling_ladder
    from repro_torch.core.level_grams import get_provider

    B, n, d, m = 16, 4096, 256, 512
    q, seeds = problem(dev, b=B, n=n, d=d)
    prov = get_provider("gaussian")

    def one_pass():
        return prov.level_grams(prov.sample(seeds, m, n), q, doubling_ladder(m))

    one_pass()          # the process's first cuBLAS call allocates its workspace
    peak, grams = peak_bytes_above_entry(one_pass, dev)
    assert bool(torch.isfinite(grams).all())
    assert peak <= gaussian_budget(B, n, d, m), peak
    sketch_peak, _ = peak_bytes_above_entry(lambda: ops.gaussian_sa(q.A, seeds, m), dev)
    assert sketch_peak < 4 * B * m * n / 3, sketch_peak


def test_quick_audit_passes_on_the_card(dev):
    """The quick registry on the card (the sharded entry points in a
    one-rank NCCL group): every rule passes, every negative control fails
    under its own rule, the state audit included."""
    from repro_torch.analysis.audit.runner import run_audit

    report = run_audit(quick=True, device=dev)
    assert report.passed, report.human_report()
    assert any(f.name == "fixture:cloned_pinvs" and f.fired for f in report.fixtures)
    assert report.launches and report.state_audit["peak_bytes"] < report.state_audit[
        "pinvs_bytes"]


@pytest.mark.parametrize("arch,reduced", [
    ("qwen2-0.5b", False), ("gemma2-27b", True), ("recurrentgemma-9b", True),
    ("rwkv6-3b", True), ("whisper-small", True), ("mixtral-8x22b", True),
    ("qwen2-moe-a2.7b", True)])
def test_lm_forward_on_card_matches_cpu(dev, arch, reduced):
    """One fp32 forward of a (2, 16) prompt on the card and on the CPU with
    the same seeded parameters: max |Δ| / max |logits| ≤ 1e-4 (matmuls
    summed in other orders; qwen2-0.5b at its full width)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, init_params

    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    g = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, generator=g, device=dev, max_seq=32)
    cpu = Transformer(cfg, max_seq=32, device="cpu")
    cpu.load_state_dict(model.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=g, device=dev)
    enc = (torch.randn((2, cfg.enc_seq, cfg.d_model), generator=g, device=dev)
           if cfg.n_enc_layers else None)
    on_card = model(tokens, enc_feats=enc, compute_dtype=torch.float32)[0].cpu()
    on_cpu = cpu(tokens.cpu(), enc_feats=None if enc is None else enc.cpu(),
                 compute_dtype=torch.float32)[0]
    assert bool(torch.isfinite(on_card).all())
    assert float((on_card - on_cpu).abs().max() / on_cpu.abs().max()) <= 1e-4


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-9b", "mixtral-8x22b",
                                  "whisper-small"])
def test_train_step_on_card_matches_cpu(dev, arch):
    """One fp32 train step of a reduced config (2 microbatches, remat) on
    the card and on the CPU from the same seeded parameters and batch: loss
    and grad norm within 1e-4, every grad within 1e-3 of max |g| (matmuls
    summed in other orders)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import device_batch
    from repro_torch.models import Transformer, init_params
    from repro_torch.train import AdamWConfig, TrainConfig, init_opt_state, make_train_step

    cfg = get_config(arch).reduced()
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                       num_microbatches=2, compute_dtype=torch.float32)
    card = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(3), device=dev,
                       max_seq=32)
    cpu = Transformer(cfg, max_seq=32, device="cpu")
    cpu.load_state_dict(card.state_dict())
    batch = next(SyntheticLM(vocab=cfg.vocab, batch=4, seq_len=16, seed=1))
    if cfg.n_enc_layers:
        batch["enc_feats"] = torch.randn((4, cfg.enc_seq, cfg.d_model),
                                         generator=torch.Generator().manual_seed(2)).numpy()
    out = []
    for model, d in ((card, dev), (cpu, torch.device("cpu"))):
        _, _, m = make_train_step(cfg, tcfg)(model, init_opt_state(model), device_batch(batch, d))
        grads = torch.cat([p.grad.reshape(-1) for p in model.parameters()]).cpu()
        out.append((float(m["loss"]), float(m["grad_norm"]), grads))
    (l1, n1, g1), (l2, n2, g2) = out
    assert abs(l1 - l2) <= 1e-4 * abs(l2) and abs(n1 - n2) <= 1e-4 * abs(n2)
    assert float((g1 - g2).abs().max()) <= 1e-3 * float(g2.abs().max())


def test_sharded_train_step_on_two_gloo_ranks_matches_cpu(dev):
    """One fp32 step of qwen2-0.5b reduced on 2 gloo ranks sharing the card
    (mesh (2, 1), fsdp, the batch split over the data ranks, 2
    microbatches, a ragged mask) against the single-device step on the CPU
    from the same parameters: loss and grad norm within 1e-4, every grad
    within 1e-3 of max |g| (matmuls summed in other orders)."""
    import numpy as np

    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.train import device_batch
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, TrainConfig, init_opt_state, make_train_step

    cfg = get_config("qwen2-0.5b").reduced()
    params = bridge.model_to_numpy(init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(3), device=dev, max_seq=32))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (4, 17))
    mask = np.ones((4, 16), np.float32)
    mask[0, :3], mask[3, 5:] = 0.0, 0.0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    res = run_ranks("repro_torch.launch.sharded_lm:run_tasks", 2, {"tasks": [(
        "step", "train", dict(arch="qwen2-0.5b", params=params, model=1, fsdp=True,
                              nmb=2, opt=opt, batch=batch, steps=1))]},
        backend="gloo", device="cuda", timeout=600)
    cpu = bridge.model_from_numpy(params, cfg, device="cpu")
    _, _, m = make_train_step(cfg, TrainConfig(opt=AdamWConfig(**opt), num_microbatches=2,
                                               compute_dtype=torch.float32))(
        cpu, init_opt_state(cpu), device_batch(batch, torch.device("cpu")))
    want = torch.cat([p.grad.reshape(-1) for p in cpu.parameters()])
    for r in res:
        got = r["step"]
        assert got["metrics"][0]["loss"] == pytest.approx(float(m["loss"]), rel=1e-4)
        assert got["metrics"][0]["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-4)
        g = torch.cat([got["grads"][k].reshape(-1) for k, _ in cpu.named_parameters()])
        assert float((g - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_quickstart_ridge_small_on_card_matches_cpu(dev):
    """``launch.quickstart``'s ridge leg at its small size on the card and
    on the CPU, inputs built on the CPU: the SJLT samples are the same
    counter hash on both, so the same m_final and doublings, iterations
    within ±2, x within 1e-4 of its scale; the B = 1 SJLT launched."""
    from repro_torch.kernels import ops
    from repro_torch.launch import quickstart as qs

    n, d, nu = qs.RIDGE["small"]
    A, y, sv = qs.ridge_problem(n, d, generator=torch.Generator().manual_seed(0))
    cpu = qs.ridge_solves(A, y, nu, sv, device="cpu")
    ops.reset_launches()
    card = qs.ridge_solves(A.to(dev), y.to(dev), nu, sv.to(dev), device=dev)
    assert ops.BODY_LAUNCHES["_sjlt_kernel"] > 0
    assert (card["m_final"], card["doublings"]) == (cpu["m_final"], cpu["doublings"])
    assert abs(card["iters"] - cpu["iters"]) <= 2
    x = cpu["x"].abs().max()
    assert float((card["x"].cpu() - cpu["x"]).abs().max()) <= 1e-4 * float(x)


def test_quickstart_logistic_small_on_card_matches_cpu(dev):
    """The sketched-Newton leg at its small size on the card and on the
    CPU: the Gaussian sketch is a function of the seed on both, so the same
    converged count, outer iterations and m trajectory, x within 1e-4
    relative; the weighted fp32 Gaussian leg launched."""
    import numpy as np

    from repro_torch.core.objectives import synthetic_logistic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import quickstart as qs

    B, n, d, m_max = qs.LOGISTIC["small"]
    A, Y = synthetic_logistic_batch(torch.Generator().manual_seed(2), B, n, d)
    cpu = qs.logistic_solve(A, Y, qs.LOGISTIC_NU, m_max, device="cpu")
    ops.reset_launches()
    card = qs.logistic_solve(A.to(dev), Y.to(dev), qs.LOGISTIC_NU, m_max, device=dev)
    assert ops.LAUNCHES[ops.leg("gaussian_sa", "fp32", weighted=True)] > 0
    assert card["converged"] == cpu["converged"] == B
    assert torch.equal(card["stats"]["newton_iters"].cpu(), cpu["stats"]["newton_iters"])
    assert np.array_equal(card["stats"]["m_trajectory"], cpu["stats"]["m_trajectory"])
    rel = (card["x"].cpu() - cpu["x"]).norm(dim=1) / cpu["x"].norm(dim=1)
    assert float(rel.max()) <= 1e-4


def test_model_dryrun_allocates_nothing_on_the_card(dev):
    """A dry-run cell traced in a process that has a card (qwen2-0.5b
    reduced, a fake 2×2 mesh, each step kind) leaves
    ``torch.cuda.memory_allocated`` where it was."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun

    full = get_config("qwen2-0.5b")
    reduced = {f.name: getattr(full.reduced(), f.name) for f in dataclasses.fields(full)}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for step in ("train", "prefill", "decode"):
        rec = dryrun.run_cell("qwen2-0.5b", ShapeSpec(f"{step}_small", 16, 8, step), "single",
                              None, mesh_shape=(2, 2), cfg_overrides=reduced, force_nmb=2)
        assert rec["status"] == "ok", rec.get("error")
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
