"""The port's SJLT family against the JAX reference on the CPU: the
segment-sum sketch in every compute dtype, the provider's ladder Grams on
handed-over samples, and the engine and service certificates under
``sketch="sjlt"``. Inputs come from numpy and go to both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive_padded as jap  # noqa: E402
from repro.core import level_grams as jlg  # noqa: E402
from repro.core.quadratic import from_least_squares_batch as j_flsb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.sjlt import sjlt_pallas, sjlt_pallas_batched  # noqa: E402
from repro.serve import solver_service as jsvc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import adaptive_padded as tap  # noqa: E402
from repro_torch.core import level_grams as tlg  # noqa: E402
from repro_torch.core.quadratic import from_least_squares_batch as t_flsb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sjlt as tsj  # noqa: E402
from repro_torch.serve import solver_service as tsvc  # noqa: E402

torch.set_num_threads(1)

DTYPES = ("fp32", "bf16", "int8")
B, N, D = 4, 512, 32
RATES = (0.6, 0.8, 0.9, 0.95)
NUS = (0.3, 0.1, 0.05, 0.02)


def _t(a):
    return torch.as_tensor(np.array(a))


def _sjlt_inputs(rng, shared, n=300, d=9, m=16, b=3):
    """A, rows with some targets at or past m (they drop out), ±1 signs and
    row weights."""
    A = rng.standard_normal((n, d) if shared else (b, n, d)).astype(np.float32)
    rows = rng.integers(0, m + 4, (b, n)).astype(np.int32)
    signs = np.where(rng.random((b, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (b, n)).astype(np.float32)
    return A, rows, signs, w


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_sjlt_batched_matches_reference(compute_dtype, shared, weighted):
    """ops.sjlt_apply_batched (the plain version on the CPU) against the
    reference's segment-sum oracle and its Pallas kernel in interpret mode,
    with out-of-range targets. bf16 and int8: bitwise against the oracle
    (bf16-rounded operands, exact fp32 products, sums of at most a few terms
    in the same order). fp32: within 4·2^-24 of max|SA|, since the weighted
    sign fold and the products round in fp32 in both and XLA may fuse them
    differently. Against the Pallas kernel (its one-hot matmul sums in
    another order): 1e-6 of max|SA|."""
    m = 16
    A, rows, signs, w = _sjlt_inputs(np.random.default_rng(7), shared, m=m)
    w = w if weighted else None
    want = np.asarray(jops.sjlt_apply_batched(
        jnp.asarray(A), jnp.asarray(rows), jnp.asarray(signs), m, use_pallas=False,
        row_weights=None if w is None else jnp.asarray(w), compute_dtype=compute_dtype))
    pallas = np.asarray(sjlt_pallas_batched(
        jnp.asarray(A), jnp.asarray(rows), jnp.asarray(signs), m, interpret=True,
        row_weights=None if w is None else jnp.asarray(w), compute_dtype=compute_dtype))
    got = ops.sjlt_apply_batched(_t(A), _t(rows), _t(signs), m,
                                 row_weights=None if w is None else _t(w),
                                 compute_dtype=compute_dtype).numpy()
    scale = np.abs(want).max()
    if compute_dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0 ** -24 * scale)
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_sjlt_single_matches_reference(compute_dtype):
    """The single-problem form (Pallas row 5) against ``ref.sjlt_ref`` and
    the interpret-mode ``sjlt_pallas``, with targets past m; tolerances as
    in the batched test."""
    m = 12
    A, rows, signs, _ = _sjlt_inputs(np.random.default_rng(3), True, n=200, d=5,
                                     m=m, b=1)
    rows, signs = rows[0], signs[0]
    want = np.asarray(jref.sjlt_ref(jnp.asarray(A), jnp.asarray(rows),
                                    jnp.asarray(signs), m, compute_dtype=compute_dtype))
    pallas = np.asarray(sjlt_pallas(jnp.asarray(A), jnp.asarray(rows),
                                    jnp.asarray(signs), m, interpret=True,
                                    compute_dtype=compute_dtype))
    got = ops.sjlt_apply(_t(A), _t(rows), _t(signs), m,
                         compute_dtype=compute_dtype).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0 ** -24 * np.abs(want).max())
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6 * np.abs(want).max())
    torch.testing.assert_close(tsj.sjlt_ref(_t(A), _t(rows), _t(signs), m, compute_dtype),
                               torch.as_tensor(got), rtol=0, atol=0)


def test_sjlt_ref_batched_is_the_oracle_per_problem():
    """The port's batched plain version equals the reference's batched
    oracle bitwise on an unweighted fp32 stream (±1 signs: exact products),
    shared and per problem, and out-of-range targets, negative ones
    included, contribute nothing."""
    rng = np.random.default_rng(11)
    m = 8
    for shared in (False, True):
        A, rows, signs, _ = _sjlt_inputs(rng, shared, n=64, d=3, m=m)
        rows[0, :5] = -1
        want = np.asarray(jref.sjlt_ref_batched(jnp.asarray(A), jnp.asarray(rows),
                                                jnp.asarray(signs), m))
        got = tsj.sjlt_ref_batched(_t(A), _t(rows), _t(signs), m).numpy()
        np.testing.assert_array_equal(got, want)
    dropped = tsj.sjlt_ref_batched(_t(A), torch.full(rows.shape, m), _t(signs), m)
    assert not bool(dropped.any())


def test_sjlt_fold_stream_int8_is_exact():
    """int8 mode: quantizing A and folding the scales into the signs sketches
    the dequantized Â exactly as the bf16 mode sketches Â (the same bf16
    rounding of each folded sign, exact products)."""
    from repro_torch.dist.compress import dequantize_rows, quantize_rows

    rng = np.random.default_rng(5)
    A, rows, signs, _ = _sjlt_inputs(rng, False, n=128, d=6, m=16)
    codes, scales = quantize_rows(_t(A))
    got = tsj.sjlt_ref_batched(_t(A), _t(rows), _t(signs), 16, "int8")
    want = tsj.sjlt_ref_batched(codes.float(), _t(rows), _t(signs) * scales, 16, "bf16")
    assert torch.equal(got, want)
    # and against the dense Â: the sign·scale rounds to bf16, so within 2^-8
    A_hat = dequantize_rows(codes, scales)
    dense = tsj.sjlt_ref_batched(A_hat, _t(rows), _t(signs), 16, "fp32")
    assert float((got - dense).abs().max()) <= 2.0 ** -8 * float(dense.abs().max())


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


class HandOver:
    """The port's provider of a family that draws the reference's
    ``jax.random`` sample for the keys whose uint32 seeds it is handed, so
    both packages sketch with the same randomness."""

    def __init__(self, family, keys=None):
        self.name = family
        self.inner = tlg.get_provider(family)
        self.ref = jlg.get_provider(family)
        self.keys = {}
        if keys is not None:
            self.add(keys)

    def add(self, keys):
        seeds = np.asarray(jlg._uint32_seeds(keys))
        self.keys.update({int(s): k for s, k in zip(seeds, keys)})

    def sample(self, seeds, m_max, n):
        keys = jnp.stack([self.keys[int(s)] for s in seeds.tolist()])
        s = self.ref.sample(keys, m_max, n, jnp.float32)
        return bridge.sample_from_numpy({k: np.asarray(v) for k, v in s.items()},
                                        device=seeds.device)

    def level_grams(self, data, q, ladder, compute_dtype=None):
        return self.inner.level_grams(data, q, ladder, compute_dtype=compute_dtype)


@pytest.mark.parametrize("m_max", [64, 48])
@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_sjlt_provider_grams_match_reference(batch, m_max, compute_dtype):
    """On the reference's u and signs, the port's ladder Grams (one pass at
    M = 64, pairwise folds, and at m_max = 48 the tail fold) match the
    reference's at every level: rtol 1e-5 of the level's largest entry (the
    same sketch, Gram products summed in another order)."""
    ladder = jap.doubling_ladder(m_max)
    prov = jlg.get_provider("sjlt")
    sample = prov.sample(batch["keys"], m_max, N, jnp.float32)
    gj = np.asarray(prov.level_grams(sample, batch["qj"], ladder,
                                     compute_dtype=compute_dtype))
    gt = tlg.get_provider("sjlt").level_grams(
        bridge.sample_from_numpy({k: np.asarray(v) for k, v in sample.items()},
                                 device="cpu"),
        batch["qt"], ladder, compute_dtype=compute_dtype)
    assert gt.dtype == torch.float32 and gt.shape == gj.shape
    for lvl in range(len(ladder)):
        np.testing.assert_allclose(gt[lvl].numpy(), gj[lvl], rtol=0,
                                   atol=1e-5 * np.abs(gj[lvl]).max())


def test_sjlt_sample_law():
    """The port's own SJLT sample: u on the 2^-24 grid of [0, 1), ±1 signs,
    problem b a function of seed b alone; the level-M targets ⌊u·M⌋ are
    about uniform."""
    seeds = torch.as_tensor([5, 6, 5], dtype=torch.int64)
    s = tlg.get_provider("sjlt").sample(seeds, 48, 4096)
    u = s["u"]
    assert u.dtype == torch.float32 and float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(u * 2.0 ** 24, torch.floor(u * 2.0 ** 24))
    assert set(s["signs"].unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(u[0], u[2]) and not torch.equal(u[0], u[1])
    counts = torch.bincount(torch.floor(u[1] * 64).long(), minlength=64).float()
    assert abs(float(counts.mean()) - 64.0) < 1e-6 and float(counts.max()) < 120
    assert abs(float(s["signs"].mean())) < 0.1


def _assert_certificates_agree(xj, sj, xt, st):
    """Per problem: status and m_final equal; iters within ±2; x to rtol 1e-4
    (the packages sum in different orders)."""
    for k in ("status", "m_final"):
        np.testing.assert_array_equal(np.asarray(st[k]), np.asarray(sj[k]), err_msg=k)
    assert np.all(np.abs(np.asarray(st["iters"]) - np.asarray(sj["iters"])) <= 2)
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-4, atol=1e-4 * np.abs(xj).max())


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("m_max", [64, 48])
def test_sjlt_engine_matches_reference(batch, compute_dtype, m_max):
    """The whole PCG solve under sketch="sjlt": the reference draws its
    sample from its keys, the port is handed that sample and computes its own
    ladder; the certificates agree."""
    xj, sj = jap.padded_adaptive_solve_batched(
        batch["qj"], batch["keys"], m_max=m_max, method="pcg", sketch="sjlt",
        max_iters=100, tol=1e-10, compute_dtype=compute_dtype)
    xt, st = tap.padded_adaptive_solve_batched(
        batch["qt"], batch["seeds"], m_max=m_max, method="pcg",
        sketch=HandOver("sjlt", batch["keys"]), max_iters=100, tol=1e-10,
        compute_dtype=compute_dtype, device="cpu")
    _assert_certificates_agree(xj, sj, xt, st)


SEED = 7
CLASSES = [(256, 32, 64, "sjlt", "fp32"), (512, 32, 48, "sjlt", "bf16"),
           (1024, 64, 128, "sjlt", "int8")]
REQUESTS = [(200, 20, 0.1, 0.8), (256, 32, 0.05, 0.9), (250, 30, 0.02, 0.85),
            (400, 24, 0.1, 0.9), (512, 32, 0.05, 0.8), (300, 28, 0.02, 0.85),
            (900, 50, 0.05, 0.9), (1024, 64, 0.1, 0.95), (600, 40, 0.02, 0.8)]


def _request(rng, n, d, decay):
    U, _ = np.linalg.qr(rng.standard_normal((n, d)))
    V, _ = np.linalg.qr(rng.standard_normal((d, d)))
    A = (U * decay ** np.arange(1, d + 1)[None, :]) @ V.T
    return A.astype(np.float32), rng.standard_normal(n).astype(np.float32)


def test_sjlt_service_certificates_match(monkeypatch):
    """One request set through both services, every class under the SJLT in
    one of the three modes. The port's slots get the reference's keys (its
    per-slot seeds, and the reference's sample handed over for them). Field
    by field: family and mode recorded, status, m_final, doublings equal and
    no retries, iters within ±2, x to rtol 1e-4."""
    base = jax.random.PRNGKey(SEED)

    def reference_slot_seeds(slot_ids):
        keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
            jnp.asarray(slot_ids, jnp.uint32))
        handover.add(keys)
        return _t(np.asarray(jlg._uint32_seeds(keys)).astype(np.int64))

    handover = HandOver("sjlt")
    monkeypatch.setitem(tlg._PROVIDERS, "sjlt", handover)
    rng = np.random.default_rng(0)
    data = [(*_request(rng, n, d, decay), nu) for n, d, nu, decay in REQUESTS]
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
    modes = set()
    for rid in ids:
        sj, st = out_j[rid], out_t[rid]
        assert (st.sketch, st.compute_dtype) == (sj.sketch, sj.compute_dtype)
        modes.add(st.compute_dtype)
        assert (st.status, st.m_final, st.doublings) == (sj.status, sj.m_final,
                                                         sj.doublings), rid
        assert st.retries == 0 and sj.retries == 0
        assert abs(st.iters - sj.iters) <= 2
        xj, xt = np.asarray(sj.x), st.x.numpy()
        np.testing.assert_allclose(xt, xj, rtol=1e-4, atol=1e-4 * np.abs(xj).max())
    assert modes == set(DTYPES)


def test_service_family_and_mode_per_class():
    """A service-wide sketch and dtype apply to every class without its own,
    and a class's own family and mode win (as the SRHT class keeps ``srht``
    under ``sketch="sjlt"``); each solution records what produced it."""
    classes = [tsvc.ShapeClass(64, 8, 16), tsvc.ShapeClass(128, 8, 16, "srht", "int8")]
    svc = tsvc.SolverService(classes, batch_size=2, sketch="sjlt", compute_dtype="bf16",
                             device="cpu")
    rng = np.random.default_rng(1)
    for n in (60, 120):
        A, y = _request(rng, n, 8, 0.8)
        svc.submit(torch.as_tensor(A), torch.as_tensor(y), 0.1)
    sols = svc.flush()
    assert [(s.sketch, s.compute_dtype, s.status) for s in sols.values()] == [
        ("sjlt", "bf16", "OK"), ("srht", "int8", "OK")]
