"""The port's bf16 and int8 sketch passes against the JAX reference on the
CPU: per-row int8 quantization, the Gaussian and FWHT legs, the providers'
Grams, and the engine and service certificates in the reduced modes. Inputs
come from numpy and go to both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive_padded as jap  # noqa: E402
from repro.core import level_grams as jlg  # noqa: E402
from repro.core.quadratic import from_least_squares_batch as j_flsb  # noqa: E402
from repro.dist import compress as jc  # noqa: E402
from repro.kernels import gaussian_gram as jg  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serve import solver_service as jsvc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import adaptive_padded as tap  # noqa: E402
from repro_torch.core import level_grams as tlg  # noqa: E402
from repro_torch.core.quadratic import from_least_squares_batch as t_flsb  # noqa: E402
from repro_torch.dist import compress as tc  # noqa: E402
from repro_torch.kernels import fwht as tf  # noqa: E402
from repro_torch.kernels import gaussian_gram as tg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import precision as tp  # noqa: E402
from repro_torch.serve import solver_service as tsvc  # noqa: E402

torch.set_num_threads(1)

REDUCED = ("bf16", "int8")
SEEDS = np.array([0, 1, 77], np.uint32)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("shape", [(7, 33), (3, 5, 16)])
def test_quantize_rows_bitwise(shape):
    """Codes and scales bitwise the reference's, with an all-zero row (scale
    0, codes 0), rows whose v/scale land exactly on .5 (round half to even)
    and rows of mixed magnitude; dequantization bitwise too."""
    rng = np.random.default_rng(len(shape))
    v = (rng.standard_normal(shape) * 10.0).astype(np.float32)
    v.reshape(-1, shape[-1])[0] = 0.0
    tie = v.reshape(-1, shape[-1])[1]         # scale 1: v/scale = k + .5 ties
    tie[:] = np.arange(shape[-1]) - 8.5
    tie[0] = 127.0
    v.reshape(-1, shape[-1])[2] *= 1e-30
    cj, sj = jc.quantize_rows(jnp.asarray(v))
    ct, st = tc.quantize_rows(_t(v))
    assert ct.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tc.dequantize_rows(ct, st).numpy(),
                                  np.asarray(jc.dequantize_rows(cj, sj)))
    assert int(ct.abs().max()) <= 127
    assert float((tc.dequantize_rows(ct, st) - _t(v)).abs().max(-1).values
                 .sub(st / 2).max()) <= 0.0


def test_quantize_rows_in_place_same_bits():
    """The codes are rounded and clamped in place: the same bits as the
    out-of-place round-then-clamp, the input left as it was, and no more
    than two new A-sized fp32 tensors (|A| and one code temporary)."""
    from repro_torch.analysis.audit import op_trace as ot

    rng = np.random.default_rng(5)
    v = _t((rng.standard_normal((3, 40, 16)) * 300.0).astype(np.float32))
    v0 = v.clone()
    trace = ot.record(lambda: tc.quantize_rows(v))
    codes, scales = trace.result
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    want = torch.clamp(torch.round(v0 / safe[..., None]), -127, 127).to(torch.int8)
    assert torch.equal(codes, want) and torch.equal(v, v0)
    a_sized = ot.find_new_tensors(
        trace, lambda shp, dt: shp == tuple(v.shape) and dt == torch.float32)
    assert len(a_sized) == 2, [s.op for s in a_sized]


def test_precision_names():
    assert tp.COMPUTE_DTYPES == ("fp32", "bf16", "int8")
    assert [tp.stream_itemsize(c) for c in tp.COMPUTE_DTYPES] == [4, 2, 1]
    assert tp.contract_dtype(None) == torch.float32
    assert tp.contract_dtype("int8") == torch.bfloat16
    with pytest.raises(ValueError):
        tp.canonical_compute_dtype("fp16")


@pytest.mark.parametrize("compute_dtype", REDUCED)
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_gaussian_reduced_leg_matches_reference(compute_dtype, shared, weighted):
    """ops.gaussian_sa in bf16 and int8 mode against the reference's scan
    oracle (``use_pallas=False``) and its Pallas kernel in interpret mode.
    The S entries agree to ≤ 4 fp32 ulp (torch's and XLA's log and cos), so
    their bf16 roundings agree except next to a rounding boundary, where they
    differ by one bf16 ulp; the products are exact and the sums are fp32 in
    another order. Tolerance: 1e-5 of max|SA| plus one such flip per output
    entry, 2^-8·max|S·scale|·max|A|."""
    n, d, m = 300, 17, 24
    rng = np.random.default_rng(n + d + len(compute_dtype))
    A = rng.standard_normal((n, d) if shared else (3, n, d)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (3, n)).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    want = np.asarray(jops.gaussian_sa(jnp.asarray(A), jnp.asarray(SEEDS), m,
                                       use_pallas=False, row_weights=jw,
                                       compute_dtype=compute_dtype))
    pallas = np.asarray(jg.gaussian_sa_pallas(
        jnp.asarray(A), jnp.asarray(SEEDS), m, chunk_cols=256, interpret=True,
        row_weights=jw, compute_dtype=compute_dtype))
    got = ops.gaussian_sa(_t(A), _t(SEEDS.astype(np.int64)), m,
                          row_weights=None if w is None else _t(w),
                          compute_dtype=compute_dtype).numpy()
    S = np.asarray(jg.gaussian_s_dense(jnp.asarray(SEEDS), m, n))
    s_max = np.abs(S).max() * (1.0 if w is None else np.sqrt(w.max()))
    if compute_dtype == "int8":
        s_max *= np.abs(A).max() / 127.0
        a_max = 127.0
    else:
        a_max = np.abs(A).max()
    atol = 1e-5 * np.abs(want).max() + 2.0 ** -8 * s_max * a_max
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=atol)


@pytest.mark.parametrize("compute_dtype", ("fp32",) + REDUCED)
def test_gaussian_chunk_invariance_bitwise_per_dtype(compute_dtype):
    """The plain version reduces n in fixed 256-column micro-tiles and
    rounds elementwise, so in every mode the chunk size never changes a bit
    of SA; the reduced modes differ from fp32 by about 2^-8·√n relative."""
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.standard_normal((2, 1500, 9)).astype(np.float32))
    seeds = _t(SEEDS[:2].astype(np.int64))
    As, scale = tg.resolve_stream(A, 2, None, compute_dtype)
    base = tg.gaussian_sa_ref(As, seeds, 40, chunk_cols=2048, scale=scale,
                              compute_dtype=compute_dtype)
    for chunk in (256, 512, 768, 4096):
        assert torch.equal(tg.gaussian_sa_ref(As, seeds, 40, chunk_cols=chunk,
                                              scale=scale, compute_dtype=compute_dtype),
                           base)
    fp32 = tg.gaussian_sa_ref(A, seeds, 40)
    assert float((base - fp32).abs().max()) <= 2.0 ** -8 * 4 * float(fp32.abs().max())


@pytest.mark.parametrize("compute_dtype", REDUCED)
@pytest.mark.parametrize("n,d", [(64, 7), (512, 130)])
@pytest.mark.parametrize("scaled", [False, True])
def test_fwht_reduced_leg_bitwise_reference(compute_dtype, n, d, scaled):
    """ops.fwht in bf16 and int8 mode (int8: the reference's codes as input)
    against the reference's butterfly (``use_pallas=False``) and its Pallas
    kernel in interpret mode: bitwise, a bf16 result. The same bf16 casts,
    the same bf16-rounded product and stage adds in the same order."""
    rng = np.random.default_rng(n * 3 + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    s = (np.where(rng.random(n) < 0.5, -1.0, 1.0)
         * rng.uniform(0.5, 2.0, n)).astype(np.float32) if scaled else None
    if compute_dtype == "int8":
        x = np.asarray(jc.quantize_rows(jnp.asarray(x))[0])
    js = None if s is None else jnp.asarray(s)
    want = np.asarray(jops.fwht(jnp.asarray(x), use_pallas=False, row_scale=js,
                                compute_dtype=compute_dtype).astype(jnp.float32))
    pallas = np.asarray(jops.fwht(jnp.asarray(x), use_pallas=True, interpret=True,
                                  row_scale=js, compute_dtype=compute_dtype
                                  ).astype(jnp.float32))
    got = ops.fwht(_t(x), row_scale=None if s is None else _t(s),
                   compute_dtype=compute_dtype)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(got.float().numpy(), pallas)


@pytest.mark.parametrize("n", [2048, 1 << 15])
@pytest.mark.parametrize("compute_dtype", REDUCED)
def test_fwht_bf16_pass_plan_bitwise_one_pass(n, compute_dtype):
    """The bf16 pass plan (one launch up to n = 16384, a radix split of two
    beyond), the scale fused into the first pass, is bitwise the one-pass
    bf16 butterfly of the bf16-rounded product."""
    B, d = 2, 3
    rng = np.random.default_rng(n)
    X = torch.as_tensor(rng.standard_normal((B, n, d)).astype(np.float32))
    if compute_dtype == "int8":
        X = tc.quantize_rows(X)[0]
    s = torch.as_tensor((np.where(rng.random((B, n)) < 0.5, -1.0, 1.0)
                         * rng.uniform(0.5, 2.0, (B, n))).astype(np.float32))
    got = tf.fwht_passes_ref(X, s, compute_dtype=compute_dtype)
    want = tf.fwht_ref(X.to(torch.bfloat16) * s.to(torch.bfloat16)[:, :, None])
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert len(tf.split_plan(n)) == (1 if n <= 16384 else 2)


def test_fwht_bf16_split_plan_fits_shared_memory():
    """A bf16 tile fills a block's 32-byte slab rows with 16 columns: the
    one-launch capacity, 8 blocks × 2048 rows, is the fp32 tile's, and
    n = 16384 (the SRHT class) is one launch of one 8-block cluster."""
    assert tf.MAX_AXIS == 16384 == tf.MAX_CLUSTER << tf.LG_MAX_SLAB
    assert tf.ROW_BYTES // 2 == 16 and tf.ROW_BYTES // 4 == 8
    for lg in range(0, 29):
        for L in tf.split_plan(1 << lg):
            assert tf.cluster_plan(L)[0] <= 1 << tf.LG_MAX_SLAB
    assert tf.split_plan(1 << 14) == [16384] and tf.cluster_plan(16384) == (2048, 8)


B, N, D, M_MAX = 4, 512, 32, 64
RATES = (0.6, 0.8, 0.9, 0.95)
NUS = (0.3, 0.1, 0.05, 0.02)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    As, Ys = [], []
    for rate in RATES:
        U, _ = np.linalg.qr(rng.standard_normal((N, D)))
        V, _ = np.linalg.qr(rng.standard_normal((D, D)))
        As.append((U * rate ** np.arange(1, D + 1)[None, :]) @ V.T)
        Ys.append(rng.standard_normal(N))
    A, Y = np.stack(As).astype(np.float32), np.stack(Ys).astype(np.float32)
    nus = np.asarray(NUS, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(42), B)
    return {"qj": j_flsb(jnp.asarray(A), jnp.asarray(Y), jnp.asarray(nus)),
            "qt": t_flsb(_t(A), _t(Y), _t(nus)), "keys": keys,
            "seeds": _t(np.asarray(jlg._uint32_seeds(keys)).astype(np.int64))}


def _assert_certificates_agree(xj, sj, xt, st):
    """Per problem: status and m_final equal; iters within ±2; x to rtol 1e-4
    (the packages sum in different orders)."""
    for k in ("status", "m_final"):
        np.testing.assert_array_equal(np.asarray(st[k]), np.asarray(sj[k]), err_msg=k)
    assert np.all(np.abs(np.asarray(st["iters"]) - np.asarray(sj["iters"])) <= 2)
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-4, atol=1e-4 * np.abs(xj).max())


@pytest.mark.parametrize("compute_dtype", REDUCED)
def test_gaussian_engine_reduced_matches_reference(batch, compute_dtype):
    """The whole PCG solve in bf16 and int8 mode, Gaussian family, on the
    reference's per-problem seeds: the same certificates. The Grams come
    back fp32, and so do x and δ̃."""
    xj, sj = jap.padded_adaptive_solve_batched(
        batch["qj"], batch["keys"], m_max=M_MAX, method="pcg", sketch="gaussian",
        max_iters=100, tol=1e-10, compute_dtype=compute_dtype)
    xt, st = tap.padded_adaptive_solve_batched(
        batch["qt"], batch["seeds"], m_max=M_MAX, method="pcg", sketch="gaussian",
        max_iters=100, tol=1e-10, compute_dtype=compute_dtype, device="cpu")
    assert xt.dtype == torch.float32 and st["dtilde"].dtype == torch.float32
    _assert_certificates_agree(xj, sj, xt, st)


@pytest.mark.parametrize("compute_dtype", REDUCED)
def test_dense_provider_reduced_matches_streamed(batch, compute_dtype):
    """The materialized-S baseline takes the same scale algebra and rounding
    as the streamed pass: the same Grams up to fp32 sum order."""
    ladder = tap.doubling_ladder(M_MAX)
    data = {"seeds": batch["seeds"]}
    g_s = tlg.get_provider("gaussian").level_grams(data, batch["qt"], ladder,
                                                   compute_dtype=compute_dtype)
    g_d = tlg.get_provider("gaussian_dense").level_grams(data, batch["qt"], ladder,
                                                         compute_dtype=compute_dtype)
    assert g_s.dtype == g_d.dtype == torch.float32
    torch.testing.assert_close(g_d, g_s, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("compute_dtype", REDUCED)
def test_srht_reduced_grams_and_engine_match_reference(batch, compute_dtype):
    """SRHT in bf16 and int8 mode (int8 quantizes before the pad): on the
    reference's signs and rows the port's fp32 level Grams match the
    reference's (rtol 1e-4 of each level's largest entry: a bitwise bf16
    FWHT, Gram sums in another order), and both engines give the same
    certificates, the reference's on its own pass, the port's on its Grams."""
    qj, qt = batch["qj"], batch["qt"]
    ladder = jap.doubling_ladder(M_MAX)
    prov = jlg.get_provider("srht")
    sample = prov.sample(batch["keys"], M_MAX, N, jnp.float32)
    gj = np.asarray(prov.level_grams(sample, qj, ladder, compute_dtype=compute_dtype))
    gt = tlg.get_provider("srht").level_grams(
        bridge.sample_from_numpy({k: np.asarray(v) for k, v in sample.items()},
                                 device="cpu"), qt, ladder, compute_dtype=compute_dtype)
    assert gt.dtype == torch.float32
    for lvl in range(len(ladder)):
        np.testing.assert_allclose(gt[lvl].numpy(), gj[lvl], rtol=0,
                                   atol=1e-4 * np.abs(gj[lvl]).max())
    xj, sj = jap.padded_adaptive_solve_batched(
        qj, batch["keys"], m_max=M_MAX, method="pcg", sketch="srht",
        max_iters=100, tol=1e-10, compute_dtype=compute_dtype)
    xt, st = tap.padded_adaptive_solve_batched(
        qt, batch["seeds"], m_max=M_MAX, method="pcg", sketch="srht", max_iters=100,
        tol=1e-10, compute_dtype=compute_dtype, grams=gt, device="cpu")
    _assert_certificates_agree(xj, sj, xt, st)


SEED = 7
CLASSES = [(256, 32, 64, None, "bf16"), (1024, 64, 128, None, "int8")]
REQUESTS = [(200, 20, 0.1, 0.8), (256, 32, 0.05, 0.9), (250, 30, 0.02, 0.85),
            (64, 12, 0.3, 0.6), (900, 50, 0.05, 0.9), (1024, 64, 0.1, 0.95),
            (600, 40, 0.02, 0.8)]


def test_service_reduced_certificates_match():
    """One request set through both services, a bf16 and an int8 Gaussian
    class, with the port's per-slot seeds swapped for the reference's: each
    solution records its mode, and status, m_final and doublings are equal
    with no retries, iters within ±2, x to rtol 1e-4."""
    base = jax.random.PRNGKey(SEED)

    def reference_slot_seeds(slot_ids):
        keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
            jnp.asarray(slot_ids, jnp.uint32))
        return _t(np.asarray(jlg._uint32_seeds(keys)).astype(np.int64))

    rng = np.random.default_rng(0)
    data = []
    for n, d, nu, decay in REQUESTS:
        U, _ = np.linalg.qr(rng.standard_normal((n, d)))
        V, _ = np.linalg.qr(rng.standard_normal((d, d)))
        A = ((U * decay ** np.arange(1, d + 1)[None, :]) @ V.T).astype(np.float32)
        data.append((A, rng.standard_normal(n).astype(np.float32), nu))
    ref = jsvc.SolverService([jsvc.ShapeClass(*c) for c in CLASSES], batch_size=4,
                             seed=SEED)
    port = tsvc.SolverService([tsvc.ShapeClass(*c) for c in CLASSES], batch_size=4,
                              seed=SEED, device="cpu")
    port._slot_seeds = reference_slot_seeds
    ids = []
    for A, y, nu in data:
        rid = ref.submit(jnp.asarray(A), jnp.asarray(y), nu)
        assert port.submit(torch.as_tensor(A), torch.as_tensor(y), nu) == rid
        ids.append(rid)
    out_j, out_t = ref.flush(), port.flush()
    for rid in ids:
        sj, st = out_j[rid], out_t[rid]
        assert (st.sketch, st.compute_dtype) == (sj.sketch, sj.compute_dtype)
        assert st.compute_dtype in REDUCED
        assert (st.status, st.m_final, st.doublings) == (sj.status, sj.m_final,
                                                         sj.doublings), rid
        assert st.retries == 0 and sj.retries == 0
        assert abs(st.iters - sj.iters) <= 2
        xj, xt = np.asarray(sj.x), st.x.numpy()
        np.testing.assert_allclose(xt, xj, rtol=1e-4, atol=1e-4 * np.abs(xj).max())

