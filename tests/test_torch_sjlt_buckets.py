"""The CPU model of the SJLT kernel's bucket pass (``sjlt_buckets_ref``) and
its segment sum (``sjlt_bucketed_ref``): the layout the kernel writes, its
stability and its drops at the sizes of both forms of the bucket pass, and
the bucketed sum bitwise equal to the plain version and to the JAX
reference's oracle."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import sjlt as ts  # noqa: E402

torch.set_num_threads(1)


def _targets(seed, B, n, M, lo=-3, hi_extra=3):
    rng = np.random.default_rng(seed)
    rows = rng.integers(lo, M + hi_extra, (B, n)).astype(np.int32)
    signs = rng.standard_normal((B, n)).astype(np.float32)
    return torch.as_tensor(rows), torch.as_tensor(signs)


def _check_layout(rows, signs, M, offsets, order, order_s):
    """Grouped by target in increasing i, drops last, offsets the exclusive
    prefix of the in-range counts, signs gathered beside."""
    B, n = rows.shape
    assert offsets.shape == (B, M + 1) and offsets.dtype == torch.int32
    assert order.shape == (B, n) and order.dtype == torch.int32
    assert order_s.shape == (B, n) and order_s.dtype == torch.float32
    t = rows.long()
    t = torch.where((t >= 0) & (t < M), t, M)
    for b in range(B):
        o = order[b].long()
        assert torch.equal(torch.sort(o).values, torch.arange(n))     # a permutation
        grouped = t[b, o]
        assert bool((grouped[1:] >= grouped[:-1]).all())
        same = grouped[1:] == grouped[:-1]
        assert bool((o[1:][same] > o[:-1][same]).all())               # stable
        counts = torch.bincount(t[b], minlength=M + 1)
        assert torch.equal(offsets[b].long(), torch.cumsum(counts, 0) - counts)
        assert int(offsets[b, M]) == int((t[b] < M).sum())
    assert torch.equal(order_s, signs.gather(1, order.long()))


@pytest.mark.parametrize("B,n,M,multichunk", [
    (3, 300, 16, False), (2, 4096, 512, False), (1, 1, 5, False), (2, 31, 7, False),
    (2, 33, 64, False), (1, 1000, 3, False), (2, 4097, 100, False), (1, 16384, 512, False),
    (2, 20000, 64, True), (1, 40000, 512, True), (2, 3000, 5000, True)])
def test_buckets_stable_layout(B, n, M, multichunk):
    """n on and off every tile (one element, under and over a round of 32,
    a warp segment, the cluster form's capacity, and past it, where the
    kernel takes the multi-chunk form: n > 16384, or counts that do not fit
    a block's shared memory): the model's layout is the stable grouping."""
    rows, signs = _targets(n * 3 + M if multichunk else n + M, B, n, M)
    assert (ts.bucket_chunk(B, n, M) > 0) == multichunk
    _check_layout(rows, signs, M, *ts.sjlt_buckets_ref(rows, signs, M))


def test_buckets_drop_out_of_range():
    """Targets below 0 and at or past M take no bucket: they follow the
    buckets in increasing i, and offsets[M] counts only the rest."""
    M = 8
    rows = torch.tensor([[3, -1, 8, 3, -5, 0, 9, 3, 7, 100]], dtype=torch.int32)
    signs = torch.arange(10, dtype=torch.float32)[None]
    offsets, order, order_s = ts.sjlt_buckets_ref(rows, signs, M)
    assert offsets[0].tolist() == [0, 1, 1, 1, 4, 4, 4, 4, 5]
    assert order[0].tolist() == [5, 0, 3, 7, 8, 1, 2, 4, 6, 9]
    assert torch.equal(order_s[0], order[0].float())
    none = torch.full((2, 50), -1, dtype=torch.int32)
    offsets, order, _ = ts.sjlt_buckets_ref(none, torch.ones(2, 50), M)
    assert not bool(offsets.any())
    assert torch.equal(order.long(), torch.arange(50).expand(2, 50))


@pytest.mark.parametrize("n", [5, 2048, 16385, 20000])
def test_buckets_one_target(n):
    """M = 1: one bucket holds every in-range i, in order."""
    rows, signs = _targets(n, 2, n, 1, lo=-2)
    offsets, order, order_s = ts.sjlt_buckets_ref(rows, signs, 1)
    _check_layout(rows, signs, 1, offsets, order, order_s)
    for b in range(2):
        keep = torch.nonzero(rows[b] == 0)[:, 0]
        assert torch.equal(order[b, :len(keep)].long(), keep)


def test_bucket_plan_and_workspace():
    """The plan's forms and the workspace's layout: the counts of the
    multi-chunk form stay within CHUNK_COUNTS_MAX words by wider chunks, and
    ``split_workspace`` views the (index, sign) entries and the offsets
    after them."""
    assert ts.bucket_chunk(16, 4096, 512) == 0
    assert ts.bucket_chunk(1, 16385, 512) == ts.CHUNK
    assert ts.bucket_chunk(1, 16384, 2800) == 0
    assert ts.bucket_chunk(1, 16384, 2900) > 0                  # counts past shared memory
    big = ts.bucket_chunk(16, 1 << 22, 512)
    assert big > ts.CHUNK and 16 * 513 * -(-(1 << 22) // big) <= ts.CHUNK_COUNTS_MAX
    B, n, M = 2, 5, 3
    assert ts.workspace_ints(B, n, M, 0) == B * (M + 1) + 2 * B * n
    assert ts.workspace_ints(B, n, M, 32) == B * (M + 1) + 2 * B * n + B * (M + 1)
    rows, signs = _targets(0, B, n, M)
    want = ts.sjlt_buckets_ref(rows, signs, M)
    entries = torch.stack([want[1], want[2].view(torch.int32)], -1)
    ws = torch.cat([entries.reshape(-1), want[0].reshape(-1)])
    for x, y in zip(ts.split_workspace(ws, B, n, M), want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_bucketed_sum_bitwise_plain(compute_dtype, shared, weighted):
    """Summing each bucket in its order from +0.0 with rounded fp32 products
    and adds is the plain version's sequential index_add_, bitwise, in every
    mode, shared and per-problem A, with ±1 or weighted signs."""
    B, n, d, M = 3, 777, 13, 64
    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.standard_normal((n, d) if shared else (B, n, d))
                        .astype(np.float32))
    rows, _ = _targets(9, B, n, M)
    signs = torch.as_tensor(np.where(rng.random((B, n)) < 0.5, -1.0, 1.0)
                            .astype(np.float32))
    if weighted:
        signs = ts.fold_row_weights(signs, torch.as_tensor(
            rng.uniform(0.5, 2.0, (B, n)).astype(np.float32)))
    got = ts.sjlt_bucketed_ref(A, rows, signs, M, compute_dtype)
    assert torch.equal(got, ts.sjlt_ref_batched(A, rows, signs, M, compute_dtype))


@pytest.mark.parametrize("M", [1, 16])
def test_bucketed_sum_is_the_reference_oracle(M):
    """Against the JAX reference's batched segment-sum oracle on an
    unweighted fp32 stream (±1 signs: exact products), per problem and
    shared, with negative and past-M targets: bitwise."""
    B, n, d = 3, 200, 6
    rng = np.random.default_rng(M)
    rows = rng.integers(-2, M + 2, (B, n)).astype(np.int32)
    signs = np.where(rng.random((B, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    for shape in ((B, n, d), (n, d)):
        A = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(jref.sjlt_ref_batched(jnp.asarray(A), jnp.asarray(rows),
                                                jnp.asarray(signs), M))
        got = ts.sjlt_bucketed_ref(torch.as_tensor(A), torch.as_tensor(rows),
                                   torch.as_tensor(signs), M).numpy()
        np.testing.assert_array_equal(got, want)
