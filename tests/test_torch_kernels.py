"""The port's sketch kernels' plain versions against the JAX reference, on
the CPU: the Gaussian counter hash and sketch→SA, and the FWHT with its
radix-split pass plan. Inputs come from numpy and go to both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import gaussian_gram as jg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fwht import fwht_pallas  # noqa: E402
from repro_torch.kernels import fwht as tf  # noqa: E402
from repro_torch.kernels import gaussian_gram as tg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)

SEEDS = np.array([0, 1, 77, 123456789, 0xFFFFFFFF], np.uint32)


def _tseeds(s):
    return torch.as_tensor(np.asarray(s, np.uint32).astype(np.int64))


def _ref_words(seed, ctr):
    """h1, h2, u1, u2 of the reference's gaussian_tile, for uint32 counters."""
    k = jg._mix(jnp.uint32(seed) ^ jg._GOLD)
    h1 = jg._mix(jnp.asarray(ctr, jnp.uint32) ^ k)
    h2 = jg._mix(h1 + jg._SEQ2)
    u1 = (h1 >> 8).astype(jnp.float32) * (1.0 / 16777216.0) + (0.5 / 16777216.0)
    u2 = (h2 >> 8).astype(jnp.float32) * (1.0 / 16777216.0)
    return [np.asarray(v) for v in (h1, h2, u1, u2)]


@pytest.mark.parametrize("row0,col0,shape", [
    (0, 0, (8, 300)),
    (4094, (1 << 20) - 8, (2, 16)),        # counters run over 2^32 and wrap
    (4095, (1 << 20) - 300, (1, 300)),
])
def test_hash_words_and_uniforms_bitwise(row0, col0, shape):
    """h1, h2, u1 and u2 are bitwise the reference's, counters near 2^32
    included (exact integer and exactly rounded fp32 arithmetic)."""
    r = (row0 + np.arange(shape[0], dtype=np.uint64))[:, None]
    c = (col0 + np.arange(shape[1], dtype=np.uint64))[None, :]
    ctr = ((r << np.uint64(20)) + c) & np.uint64(0xFFFFFFFF)
    t_ctr = torch.as_tensor(ctr.astype(np.int64))
    h1, h2 = tg.hash_words(_tseeds(SEEDS), t_ctr)
    u1, u2 = tg.uniforms(h1, h2)
    for b, s in enumerate(SEEDS):
        want = _ref_words(s, ctr.astype(np.uint32))
        got = [h1[b].numpy(), h2[b].numpy(), u1[b].numpy(), u2[b].numpy()]
        np.testing.assert_array_equal(got[0].astype(np.uint32), want[0])
        np.testing.assert_array_equal(got[1].astype(np.uint32), want[1])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("row0,col0,shape", [(0, 0, (64, 512)),
                                             (4094, (1 << 20) - 8, (2, 16))])
def test_gaussian_entries_within_4_ulp(row0, col0, shape):
    """Box–Muller entries match to ≤ 4 ulp: log and cos are implemented
    differently by XLA's CPU backend and by torch."""
    got = tg.gaussian_tile(_tseeds(SEEDS), row0, col0, shape).numpy()
    want = np.stack([np.asarray(jg.gaussian_tile(s, row0, col0, shape))
                     for s in SEEDS])
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("n,d,m", [(300, 17, 24), (777, 5, 8)])
def test_gaussian_sa_matches_reference(shared, scaled, n, d, m):
    """The port's gaussian_sa_ref against the reference's scan oracle and its
    Pallas kernel in interpret mode, shared and per-problem A, with and
    without a column scale. rtol 1e-5: the sketch entries agree to a few
    ulp and the contractions sum in different orders."""
    B = 3
    rng = np.random.default_rng(n + d)
    A = rng.standard_normal((n, d) if shared else (B, n, d)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (B, n)).astype(np.float32) if scaled else None
    seeds = SEEDS[:B]
    want_ref = np.asarray(jg.gaussian_sa_ref(
        jnp.asarray(A), jnp.asarray(seeds), m,
        row_weights=None if w is None else jnp.asarray(w)))
    want_pallas = np.asarray(jg.gaussian_sa_pallas(
        jnp.asarray(A), jnp.asarray(seeds), m, chunk_cols=256, interpret=True,
        row_weights=None if w is None else jnp.asarray(w)))
    got = ops.gaussian_sa(torch.as_tensor(A), _tseeds(seeds), m,
                          row_weights=None if w is None else torch.as_tensor(w)).numpy()
    scale = np.abs(want_ref).max()
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-5 * scale)


def test_gaussian_sa_chunk_invariance_bitwise():
    """The plain version reduces n in fixed 256-column micro-tiles, so the
    chunk size never changes a bit of SA."""
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.standard_normal((2, 1500, 9)).astype(np.float32))
    seeds = _tseeds(SEEDS[:2])
    base = tg.gaussian_sa_ref(A, seeds, 40, chunk_cols=2048)
    for chunk in (256, 512, 768, 4096):
        assert torch.equal(tg.gaussian_sa_ref(A, seeds, 40, chunk_cols=chunk), base)


def test_gaussian_dense_sketch_matches_streamed():
    """The materialized sketch holds the streamed entries (dense baseline)."""
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.standard_normal((2, 300, 6)).astype(np.float32))
    seeds = _tseeds(SEEDS[:2])
    S = tg.gaussian_s_dense(seeds, 16, 300)
    torch.testing.assert_close(S @ A, tg.gaussian_sa_ref(A, seeds, 16),
                               rtol=1e-5, atol=1e-5)


def test_gaussian_caps():
    with pytest.raises(ValueError):
        tg.check_caps(tg.MAX_N + 1, 8)
    with pytest.raises(ValueError):
        tg.check_caps(16, tg.MAX_M + 1)


@pytest.mark.parametrize("n,d", [(8, 1), (64, 7), (512, 130)])
@pytest.mark.parametrize("scaled", [False, True])
def test_fwht_matches_reference(n, d, scaled):
    """fwht_ref, scaled and unscaled, against the reference's oracle
    (bitwise: the same butterfly stages in the same order), its Pallas
    kernel in interpret mode and the dense Hadamard matrix (fp32 sums in
    another order: rtol 1e-4, atol 1e-4·√n)."""
    rng = np.random.default_rng(n * 31 + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    s = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    xs = x * s[:, None] if scaled else x
    got = ops.fwht(torch.as_tensor(x),
                   row_scale=torch.as_tensor(s) if scaled else None).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.fwht_ref(jnp.asarray(xs))))
    pallas = fwht_pallas(jnp.asarray(x), interpret=True,
                         row_scale=jnp.asarray(s) if scaled else None)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4,
                               atol=1e-4 * np.sqrt(n))
    dense = np.asarray(jref.hadamard_dense(n)) @ xs
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4 * np.sqrt(n))
    np.testing.assert_array_equal(tf.hadamard_dense(n).numpy(),
                                  np.asarray(jref.hadamard_dense(n)))


@pytest.mark.parametrize("n", [1 << 15, 1 << 16])
@pytest.mark.parametrize("shared", [False, True])
def test_fwht_radix_split_equals_one_pass(n, shared):
    """The kernel's pass plan beyond one launch's 16384 rows (radix split,
    scale fused into the first pass), run with the plain axis transform, is
    bitwise the one-pass butterfly: each pass runs a contiguous block of its
    stages in order."""
    B, d = 2, 3
    assert len(tf.split_plan(n)) == 2
    rng = np.random.default_rng(n)
    X = torch.as_tensor(rng.standard_normal((n, d) if shared else (B, n, d))
                        .astype(np.float32))
    s = torch.as_tensor(np.where(rng.random((B, n)) < 0.5, -1.0, 1.0)
                        .astype(np.float32))
    got = tf.fwht_passes_ref(X, s, batch=B)
    want = tf.fwht_ref(X.expand(B, n, d) * s[:, :, None])
    assert torch.equal(got, want)
    assert torch.equal(ops.fwht_cols(X, row_scale=s, batch=B), want)


def test_fwht_split_plan_fits_shared_memory():
    """Every launch's axis fits one cluster: at most 8 blocks (the portable
    cluster size), each a slab of at most 2048 rows × 32 bytes (64 KB, two
    blocks to an SM's 227 KB). One launch up to n = 16384, two up to
    16384², none beyond."""
    for lg in range(0, 29):
        plan = tf.split_plan(1 << lg)
        assert len(plan) == (1 if lg <= 14 else 2)
        for L in plan:
            slab, cluster = tf.cluster_plan(L)
            assert slab * cluster == L and cluster <= tf.MAX_CLUSTER
            assert 2 * slab * tf.ROW_BYTES <= 232_448   # two blocks to an SM
    with pytest.raises(ValueError):
        tf.split_plan(1 << 29)
    with pytest.raises(ValueError):
        tf.split_plan(3000)


@pytest.mark.parametrize("n", [1, 2, 8, 64, 2048, 4096, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwht_kernel_schedule_bitwise_one_pass(n, dtype):
    """The plain model of one launch's schedule (register rounds of up to 3
    stages in each slab, then the stages across the cluster's slabs in the
    gather order) is bitwise the one-pass butterfly in fp32 and in bf16: the
    card's decomposition, checked on the CPU."""
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.standard_normal((2, n, 5)).astype(np.float32)).to(dtype)
    assert torch.equal(tf.fwht_schedule_ref(x), tf.fwht_ref(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwht_schedule_of_radix_passes_bitwise(dtype):
    """n = 2^15: both passes of the radix split, each run by the schedule
    model on its (a, L, c) view, compose to the one-pass butterfly."""
    n, d, B = 1 << 15, 2, 2
    rng = np.random.default_rng(7)
    X = torch.as_tensor(rng.standard_normal((B, n, d)).astype(np.float32)).to(dtype)
    y = X.reshape(B, n * d)
    for a, L, c in tf.pass_shapes(n, d):
        y = tf.fwht_schedule_ref(y.reshape(B, a, L, c)).reshape(B, n * d)
    assert torch.equal(y.reshape(B, n, d), tf.fwht_ref(X))


def test_reduced_precision_not_ported():
    """The bf16 and int8 legs, which raised NotImplementedError before they
    were ported, now run: fp32 SA from the Gaussian pass, a bf16 stack from
    the FWHT (their parity with the reference is in
    tests/test_torch_precision.py). A mode outside COMPUTE_DTYPES raises."""
    A = torch.ones((1, 256, 4))
    sa = ops.gaussian_sa(A, _tseeds([1]), 8, compute_dtype="bf16")
    assert sa.dtype == torch.float32 and bool(torch.isfinite(sa).all())
    hx = ops.fwht_cols(A, compute_dtype="int8")
    assert hx.dtype == torch.bfloat16 and float(hx[0, 0, 0]) == 256.0
    with pytest.raises(ValueError, match="compute_dtype"):
        ops.gaussian_sa(A, _tseeds([1]), 8, compute_dtype="fp16")
    with pytest.raises(ValueError, match="compute_dtype"):
        ops.fwht_cols(A, compute_dtype="int4")
