"""The port's padded adaptive engine against the JAX reference on the CPU:
the shifted ladder factorization and its guards, the valid-level remap, and
whole solves of the Gaussian and SRHT families on the same inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive_padded as jap  # noqa: E402
from repro.core import level_grams as jlg  # noqa: E402
from repro.core.precond import shifted_ladder_inverses as j_shifted  # noqa: E402
from repro.core.quadratic import Quadratic as JQuadratic  # noqa: E402
from repro.core.quadratic import from_least_squares_batch as j_flsb  # noqa: E402
from repro.core.status import SolveStatus as JStatus  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import adaptive_padded as tap  # noqa: E402
from repro_torch.core import level_grams as tlg  # noqa: E402
from repro_torch.core.precond import shifted_ladder_inverses as t_shifted  # noqa: E402
from repro_torch.core.quadratic import from_least_squares_batch as t_flsb  # noqa: E402
from repro_torch.core.status import SolveStatus  # noqa: E402

torch.set_num_threads(1)

B, N, D, M_MAX = 4, 512, 32, 64
RATES = (0.6, 0.8, 0.9, 0.95)
NUS = (0.3, 0.1, 0.05, 0.02)


def _exp_decay_batch(rng, B, n, d, rates):
    """A_b = U_b·diag(rate_b^j)·V_bᵀ (the conftest.py spectrum), y_b ~ N(0, I)."""
    As, Ys = [], []
    for rate in rates:
        U, _ = np.linalg.qr(rng.standard_normal((n, d)))
        V, _ = np.linalg.qr(rng.standard_normal((d, d)))
        sv = rate ** np.arange(1, d + 1)
        As.append((U * sv[None, :]) @ V.T)
        Ys.append(rng.standard_normal(n))
    return np.stack(As).astype(np.float32), np.stack(Ys).astype(np.float32)


@pytest.fixture(scope="module")
def batch():
    A, Y = _exp_decay_batch(np.random.default_rng(0), B, N, D, RATES)
    nus = np.asarray(NUS, np.float32)
    qj = j_flsb(jnp.asarray(A), jnp.asarray(Y), jnp.asarray(nus))
    qt = t_flsb(torch.as_tensor(A), torch.as_tensor(Y), torch.as_tensor(nus))
    keys = jax.random.split(jax.random.PRNGKey(42), B)
    return {"qj": qj, "qt": qt, "keys": keys,
            "seeds": np.asarray(jlg._uint32_seeds(keys))}


def _assert_certificates_agree(xj, sj, xt, st):
    """Per problem: status, m_final and level equal; iters within ±2; x to
    rtol 1e-4 (the two packages sum in different orders, so iterates differ
    at fp32 rounding level, well inside the solve tolerance)."""
    for k in ("status", "m_final", "level"):
        np.testing.assert_array_equal(np.asarray(st[k]), np.asarray(sj[k]), err_msg=k)
    assert np.all(np.abs(np.asarray(st["iters"]) - np.asarray(sj["iters"])) <= 2)
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-4,
                               atol=1e-4 * np.abs(xj).max())


def test_shifted_ladder_inverses_match_with_nan_levels():
    """Level Grams built from rank-deficient factors, with ν = 0 on one
    problem: its singular levels come back NaN in both packages (the port
    NaNs cholesky_ex's failed factors), the rest agree to rtol 1e-4."""
    rng = np.random.default_rng(1)
    L, Bq, d = 3, 2, 8
    grams = np.zeros((L, Bq, d, d), np.float32)
    for l, r in enumerate((2, 5, d)):       # level l has rank r
        for b in range(Bq):
            C = np.zeros((16, d), np.float32)
            C[:, :r] = rng.standard_normal((16, r))
            grams[l, b] = C.T @ C
    nu = np.asarray([1e-2, 0.0], np.float32)
    lam = np.ones((Bq, d), np.float32)
    want = np.asarray(j_shifted(jnp.asarray(grams), jnp.asarray(nu), jnp.asarray(lam)))
    got = t_shifted(torch.as_tensor(grams), torch.as_tensor(nu),
                    torch.as_tensor(lam)).numpy()
    fin_w = np.isfinite(want).all(axis=(-1, -2))
    fin_g = np.isfinite(got).all(axis=(-1, -2))
    np.testing.assert_array_equal(fin_g, fin_w)
    assert not fin_g[:2, 1].any() and fin_g[2, 1] and fin_g[:, 0].all()
    np.testing.assert_allclose(got[fin_g], want[fin_w], rtol=1e-4,
                               atol=1e-4 * np.abs(want[fin_w]).max())


def test_valid_level_remap_matches_on_random_masks():
    rng = np.random.default_rng(2)
    for L in (1, 4, 10):
        ok = rng.random((L, 7)) < 0.4
        ok[:, 0] = False                  # a problem with no valid level
        rj, aj = jap._valid_level_remap(jnp.asarray(ok))
        rt, at = tap._valid_level_remap(torch.as_tensor(ok))
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_gaussian_engine_matches_reference(batch):
    """The whole PCG solve, Gaussian family: the port on the reference's
    per-problem seeds gives the same certificates."""
    xj, sj = jap.padded_adaptive_solve_batched(
        batch["qj"], batch["keys"], m_max=M_MAX, method="pcg", sketch="gaussian",
        max_iters=100, tol=1e-10)
    xt, st = tap.padded_adaptive_solve_batched(
        batch["qt"], torch.as_tensor(batch["seeds"].astype(np.int64)),
        m_max=M_MAX, method="pcg", sketch="gaussian", max_iters=100, tol=1e-10,
        device="cpu")
    assert np.all(np.asarray(sj["status"]) == int(JStatus.OK))
    assert len(set(np.asarray(sj["m_final"]).tolist())) >= 2   # ladders differ
    _assert_certificates_agree(xj, sj, xt, st)


def test_gaussian_dense_provider_matches_streamed(batch):
    """The materialized-S baseline gives the streamed Grams (same entries)."""
    ladder = tap.doubling_ladder(M_MAX)
    seeds = torch.as_tensor(batch["seeds"].astype(np.int64))
    g_s = tlg.get_provider("gaussian").level_grams({"seeds": seeds}, batch["qt"], ladder)
    g_d = tlg.get_provider("gaussian_dense").level_grams({"seeds": seeds}, batch["qt"],
                                                        ladder)
    torch.testing.assert_close(g_d, g_s, rtol=1e-4, atol=1e-6)


def test_srht_grams_and_engine_match_reference(batch):
    """SRHT family: on the reference's signs/rows the port's level Grams
    match the reference's (rtol 1e-4: the same FWHT, contractions in another
    order); both engines then solve on those same Grams."""
    qj, qt = batch["qj"], batch["qt"]
    ladder = jap.doubling_ladder(M_MAX)
    prov = jlg.get_provider("srht")
    sample = prov.sample(batch["keys"], M_MAX, N, jnp.float32)
    gj = np.asarray(prov.level_grams(sample, qj, ladder))
    gt = tlg.get_provider("srht").level_grams(
        bridge.sample_from_numpy({k: np.asarray(v) for k, v in sample.items()},
                                 device="cpu"), qt, ladder).numpy()
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5 * np.abs(gj).max())

    xj, sj = jap.padded_adaptive_solve_batched(
        qj, batch["keys"], m_max=M_MAX, method="pcg", sketch="srht",
        max_iters=100, tol=1e-10, grams=jnp.asarray(gj))
    xt, st = tap.padded_adaptive_solve_batched(
        qt, torch.as_tensor(batch["seeds"].astype(np.int64)), m_max=M_MAX,
        method="pcg", sketch="srht", max_iters=100, tol=1e-10,
        grams=torch.as_tensor(gj.copy()), device="cpu")
    _assert_certificates_agree(xj, sj, xt, st)


def test_srht_sample_law():
    """The port's SRHT sample: ±1 signs, rows uniform on the padded index
    space, a function of the seed alone, problem b from seed b only."""
    seeds = torch.as_tensor([5, 6, 5], dtype=torch.int64)
    s = tlg.get_provider("srht").sample(seeds, 4096, 1000)
    assert set(s["signs"].unique().tolist()) == {-1.0, 1.0}
    assert int(s["rows"].min()) >= 0 and int(s["rows"].max()) < 1024
    assert torch.equal(s["rows"][0], s["rows"][2])
    assert not torch.equal(s["rows"][0], s["rows"][1])
    # i.i.d. uniform: each of the 1024 rows drawn about 4 times
    counts = torch.bincount(s["rows"][1], minlength=1024).float()
    assert abs(float(counts.mean()) - 4.0) < 1e-6 and float(counts.max()) < 20
    assert abs(float(s["signs"].mean())) < 0.1


def test_whole_ladder_invalid_reported_by_both():
    """A = 0, ν = 0, b ≠ 0: no ladder level factorizes, so both engines
    report LEVEL_INVALID with the x₀ = 0 iterate."""
    Bq, n, d, m = 2, 64, 8, 16
    args = dict(A=np.zeros((Bq, n, d), np.float32), b=np.ones((Bq, d), np.float32),
                nu=np.zeros(Bq, np.float32), lam_diag=np.ones((Bq, d), np.float32))
    qj = JQuadratic(**{k: jnp.asarray(v) for k, v in args.items()}, batched=True)
    qt = bridge.quadratic_from_numpy(**args, device="cpu")
    xj, sj = jap.padded_adaptive_solve_batched(
        qj, jax.random.PRNGKey(0), m_max=m, method="pcg")
    xt, st = tap.padded_adaptive_solve_batched(qt, 0, m_max=m, method="pcg",
                                               device="cpu")
    assert np.all(np.asarray(sj["status"]) == int(JStatus.LEVEL_INVALID))
    assert np.all(st["status"].numpy() == int(SolveStatus.LEVEL_INVALID))
    assert bool((xt == 0).all()) and bool(jnp.all(xj == 0))


def test_fp32_matmul_precision_required(batch):
    """The engine refuses to run with TF32 matmuls switched on globally."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            tap.padded_adaptive_solve_batched(batch["qt"], 0, m_max=M_MAX,
                                              device="cpu")
    finally:
        torch.set_float32_matmul_precision(old)
