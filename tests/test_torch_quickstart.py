"""The port's quickstart leg (``launch.quickstart``) against
``examples/quickstart.py`` at its ``--small`` sizes, on the CPU.

Both legs are handed the reference's arrays, built as the example builds
them. The ridge leg's adaptive PCG replays the reference's sketches (phase
i's SJLT from the i-th ``jax.random.split`` of its key, handed to
``adaptive_solve(sampler=)`` by patching the quickstart's
``adaptive_solve``); the sketched-Newton leg gets the reference's per-step
Gaussian seeds (``_uint32_seeds`` of ``fold_in(key_b, t)``, by patching
``core.newton.fold_seeds``), the Gaussian sketch being a function of that
seed in both packages. Given the same sketches, the host loops must take
the same decisions: m_final and the doublings equal, the iterations within
±2 (the relative stop, tol = 1e-10, sits near fp32's floor of δ̃, where the
last iterations are noise in either package), and x within 1e-4 of its
scale of the reference's (fp32 solves and matvecs summed in another order
than XLA's; about 1e-6 here). CG's ‖r‖² trace follows the reference's
within 1e-4 until the port's CG stops, and its x at 300 iterations is
within 1e-4 of the reference's (2.6e-5 measured: the reference's drifts
after fp32's floor, the port's does not move). The GLM leg's converged
count, outer iterations and m trajectory must be the reference's, and its
x within 1e-4 of the reference's."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import AdaptiveConfig as JAdaptiveConfig  # noqa: E402
from repro.core import adaptive_newton_solve_batched as jnewton_batched  # noqa: E402
from repro.core import adaptive_solve as jadaptive_solve  # noqa: E402
from repro.core import cg_solve as jcg_solve  # noqa: E402
from repro.core import direct_solve as jdirect_solve  # noqa: E402
from repro.core import from_least_squares as jfrom_least_squares  # noqa: E402
from repro.core import level_grams as jlg  # noqa: E402
from repro.core import sketches as js  # noqa: E402
from repro.core.effective_dim import exp_decay_singular_values as jsv  # noqa: E402
from repro.core.objectives import synthetic_logistic_batch as jlogistic_batch  # noqa: E402
from repro_torch.core import cg_solve, from_least_squares, from_least_squares_batch, newton  # noqa: E402,E501
from repro_torch.core import sketches as ts  # noqa: E402
from repro_torch.launch import quickstart as qs  # noqa: E402

torch.set_num_threads(1)


def _reference_ridge():
    """examples/quickstart.py ``main(small=True)``'s problem and answers."""
    n, d, nu = qs.RIDGE["small"]
    key = jax.random.PRNGKey(0)
    sv = jsv(d, 0.99)
    kU, kV, ky = jax.random.split(key, 3)
    U, _ = jnp.linalg.qr(jax.random.normal(kU, (n, d)))
    V, _ = jnp.linalg.qr(jax.random.normal(kV, (d, d)))
    A = (U * sv[None, :]) @ V.T
    y = jax.random.normal(ky, (n,))
    q = jfrom_least_squares(A, y, nu)
    x_star = jdirect_solve(q)
    x_cg = jcg_solve(q, jnp.zeros((d,)), iters=qs.CG_ITERS)          # (x, ‖r‖² trace)
    res = jadaptive_solve(q, JAdaptiveConfig(method="pcg", sketch="sjlt", max_iters=100,
                                             tol=1e-10), key=jax.random.PRNGKey(1))
    return (np.asarray(A), np.asarray(y), np.asarray(sv), nu), x_star, x_cg, res


def _replay(n, key):
    def sampler(phase, m):
        k = key
        for _ in range(phase + 1):
            k, sub = jax.random.split(k)
        jsk = js.make_sketch("sjlt", m, n, sub)
        return ts.Sketch.from_numpy("sjlt", m, n, {k: np.asarray(v) for k, v in jsk.data.items()},
                                    device="cpu")
    return sampler


def test_ridge_leg_replays_the_reference(monkeypatch):
    (A, y, sv, nu), x_star, x_cg, res = _reference_ridge()
    assert qs.ADAPTIVE == qs.AdaptiveConfig(method="pcg", sketch="sjlt", max_iters=100,
                                            tol=1e-10)
    monkeypatch.setattr(qs, "adaptive_solve", functools.partial(
        qs.adaptive_solve, sampler=_replay(A.shape[0], jax.random.PRNGKey(1))))
    r = qs.ridge_solves(torch.as_tensor(A), torch.as_tensor(y), nu, torch.as_tensor(sv),
                        device="cpu")
    assert r["m_final"] == res.m_final and r["doublings"] == res.n_doublings
    assert abs(r["iters"] - res.iters) <= 2
    x_ref = np.asarray(res.x)
    assert np.abs(r["x"].numpy() - x_ref).max() <= 1e-4 * np.abs(x_ref).max()
    xs = np.asarray(x_star)
    assert np.abs(r["x_star"].numpy() - xs).max() <= 1e-4 * np.abs(xs).max()
    # CG: the port's stops where ‖r‖² reaches eps²·‖r₀‖² (iteration 27
    # here); until then its trace is the reference's
    trace, ref_trace = r["cg_trace"].numpy(), np.asarray(x_cg[1])
    stop = int(np.argmax(trace == trace[-1]))
    assert 0 < stop < 60 and np.all(trace[stop:] == trace[stop])
    np.testing.assert_allclose(trace[:stop], ref_trace[:stop], rtol=1e-4)
    x_cg_ref = np.asarray(x_cg[0])
    assert np.abs(r["x_cg"].numpy() - x_cg_ref).max() <= 1e-4 * np.abs(x_cg_ref).max()
    assert r["cg_rel_err"] <= 1e-5
    ref_err = float(np.linalg.norm(x_ref - xs) / np.linalg.norm(xs))
    assert r["rel_err"] <= max(2 * ref_err, 1e-4)
    assert r["d_e"] == pytest.approx(float(np.sum(sv ** 2 / (sv ** 2 + nu ** 2))
                                           / np.max(sv ** 2 / (sv ** 2 + nu ** 2))), rel=1e-5)


def test_logistic_leg_matches_the_reference_with_its_seeds(monkeypatch):
    B, n, d, m_max = qs.LOGISTIC["small"]
    nu = qs.LOGISTIC_NU
    A, Y = jlogistic_batch(jax.random.PRNGKey(0), B, n, d)
    x_j, st_j = jnewton_batched("logistic", A, Y, nu, m_max=m_max, keys=jax.random.PRNGKey(1))
    keys = jax.random.split(jax.random.PRNGKey(1), B)

    def step_seeds(seeds, t):
        return torch.as_tensor(np.asarray(jlg._uint32_seeds(
            jax.vmap(lambda k: jax.random.fold_in(k, t))(keys))).astype(np.int64))

    monkeypatch.setattr(newton, "fold_seeds", step_seeds)
    r = qs.logistic_solve(torch.as_tensor(np.asarray(A)), torch.as_tensor(np.asarray(Y)), nu,
                          m_max, device="cpu")
    st = r["stats"]
    assert r["converged"] == int(np.sum(np.asarray(st_j["converged"]))) == B
    np.testing.assert_array_equal(st["newton_iters"].numpy(), np.asarray(st_j["newton_iters"]))
    np.testing.assert_array_equal(st["m_trajectory"], np.asarray(st_j["m_trajectory"]))
    xj = np.asarray(x_j)
    rel = np.linalg.norm(r["x"].numpy() - xj, axis=1) / np.linalg.norm(xj, axis=1)
    assert rel.max() <= 1e-4
    assert r["max_rel_err"] <= 1e-4 and r["max_decrement"] <= 1e-10


@pytest.mark.parametrize("logistic", [False, True])
def test_cli_small_on_the_cpu(logistic, capsys):
    assert qs.cli((["--logistic"] if logistic else []) + ["--small", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    if logistic:
        assert "converged 4/4" in out and "m trajectory (problem 0)" in out
    else:
        assert "adaptive PCG (paper)" in out and "final sketch m=" in out


def test_entry_points_mean_the_card():
    """Without ``--device cpu`` the quickstart runs on cuda, and raises
    where there is none rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        qs.main(small=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cg_stops_each_problem_at_its_dtypes_resolution(dtype):
    """Batched CG: each problem stops where its own ‖r‖² reaches
    eps²·‖r₀‖², and moves as the same problem alone. Problem 0 (κ ≈ 2)
    stops early; problem 1 (κ ≈ 1e4) is still moving at the end."""
    rng = np.random.default_rng(0)
    n, d, iters = 256, 64, 60
    A = np.stack([np.linalg.qr(rng.standard_normal((n, d)))[0] * s
                  for s in (np.linspace(1.0, 0.7, d), np.geomspace(1.0, 1e-2, d))])
    y = rng.standard_normal((2, n))
    At, yt = torch.as_tensor(A, dtype=dtype), torch.as_tensor(y, dtype=dtype)
    q = from_least_squares_batch(At, yt, 1e-3)
    x, trace = cg_solve(q, torch.zeros_like(q.b), iters=iters)
    floor = torch.finfo(dtype).eps ** 2 * torch.sum(q.b * q.b, dim=1)
    assert trace.shape == (iters, 2)
    stop = int(torch.argmax((trace[:, 0] <= floor[0]).to(torch.int32)))
    assert 0 < stop < 40 and bool(torch.all(trace[stop:, 0] == trace[stop, 0]))
    assert bool(torch.all(trace[:, 1] > floor[1]))
    # alone: problem 0 to the end, problem 1 (whose fp32 rounding grows
    # with κ, so that another summation order drifts) until problem 0 stops
    x0, t0 = cg_solve(from_least_squares(At[0], yt[0], 1e-3), torch.zeros(d, dtype=dtype),
                      iters=iters)
    torch.testing.assert_close(trace[:, 0], t0, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(x[0], x0, rtol=1e-4, atol=1e-4 * float(x0.abs().max()))
    _, t1 = cg_solve(from_least_squares(At[1], yt[1], 1e-3), torch.zeros(d, dtype=dtype),
                     iters=stop)
    torch.testing.assert_close(trace[:stop, 1], t1, rtol=1e-4, atol=0.0)
