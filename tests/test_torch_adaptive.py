"""The paper's adaptive solvers (``core.adaptive``, Alg. 4.1/4.2) and
``solvers.newton_solve`` against the JAX reference on the CPU.

The port replays the reference's sketches: phase i of the reference draws
its sketch from the i-th ``jax.random.split`` of its key, and the port's
``sampler=`` hook is handed exactly that sketch (``Sketch.from_numpy``).
Given the same sketches, the host loop must take the same decisions:
``m_trace``, ``iters`` and ``n_doublings`` are required equal, and x within
1e-4 of its scale (fp32 solves and matvecs summed in another order than
XLA's; 2e-5 is typical). The tolerance of the relative stop, 1e-8, keeps
the last decision away from the fp32 floor of δ̃, where iteration counts
are noise in either package."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive as ja  # noqa: E402
from repro.core import quadratic as jq  # noqa: E402
from repro.core import sketches as js  # noqa: E402
from repro.core import solvers as jsv  # noqa: E402
from repro_torch.core import adaptive as ta  # noqa: E402
from repro_torch.core import quadratic as tq  # noqa: E402
from repro_torch.core import sketches as ts  # noqa: E402
from repro_torch.core import solvers as tsv  # noqa: E402

torch.set_num_threads(1)
N, D, TOL = 512, 20, 1e-8


def _problem(seed=0, weighted=False, lam=False):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((N, D)))
    V, _ = np.linalg.qr(rng.standard_normal((D, D)))
    A = ((U * 0.8 ** np.arange(D)) @ V.T).astype(np.float32)
    y = rng.standard_normal(N).astype(np.float32)
    w = rng.uniform(0.5, 2.0, N).astype(np.float32) if weighted else None
    lam_d = rng.uniform(1.0, 2.0, D).astype(np.float32) if lam else np.ones(D, np.float32)
    qj = jq.Quadratic(A=jnp.asarray(A), b=jnp.asarray(A.T @ y), nu=jnp.float32(1e-2),
                      lam_diag=jnp.asarray(lam_d),
                      row_weights=None if w is None else jnp.asarray(w))
    qt = tq.Quadratic(A=torch.as_tensor(A), b=torch.as_tensor(A.T @ y),
                      nu=torch.tensor(1e-2), lam_diag=torch.as_tensor(lam_d),
                      row_weights=None if w is None else torch.as_tensor(w))
    return qj, qt


def _replay(kind, n, key=None, s=1):
    """The port's sampler handing over the reference's phase-i sketch."""
    key = jax.random.PRNGKey(0) if key is None else key
    subs = []

    def sampler(phase, m):
        k = key
        for _ in range(phase + 1):
            k, sub = jax.random.split(k)
        subs.append(phase)
        jsk = js.make_sketch(kind, m, n, sub, s=s)
        return ts.Sketch.from_numpy(kind, m, n, {k: np.asarray(v) for k, v in jsk.data.items()},
                                    device="cpu")
    sampler.phases = subs
    return sampler


def _same_run(rj, rt):
    assert rt.m_trace == rj.m_trace
    assert rt.iters == rj.iters
    assert rt.n_doublings == rj.n_doublings
    assert rt.m_final == rj.m_final
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() <= 1e-4 * np.abs(xj).max()
    np.testing.assert_allclose(rt.delta_tilde_trace[0], rj.delta_tilde_trace[0], rtol=1e-5)
    assert len(rt.resketch_times) == rt.n_doublings + 1
    assert len(rt.iter_times) >= rt.iters + rt.n_doublings


@pytest.mark.parametrize("kind", ["gaussian", "srht", "sjlt"])
@pytest.mark.parametrize("method", ["ihs", "pcg", "polyak"])
def test_adaptive_solve_replays_reference(method, kind):
    qj, qt = _problem()
    cfg = dict(method=method, sketch=kind, tol=TOL, max_iters=200)
    rj = ja.adaptive_solve(qj, ja.AdaptiveConfig(**cfg), key=jax.random.PRNGKey(0))
    rt = ta.adaptive_solve(qt, ta.AdaptiveConfig(**cfg), sampler=_replay(kind, N), device="cpu")
    _same_run(rj, rt)
    assert rt.n_doublings >= 3        # the ladder really climbed


@pytest.mark.parametrize("kind", ["gaussian", "srht", "sjlt"])
def test_weighted_problem_sketches_sqrt_w_A(kind):
    qj, qt = _problem(seed=1, weighted=True, lam=True)
    cfg = dict(method="pcg", sketch=kind, tol=TOL, max_iters=200)
    rj = ja.adaptive_solve(qj, ja.AdaptiveConfig(**cfg), key=jax.random.PRNGKey(3))
    rt = ta.adaptive_solve(qt, ta.AdaptiveConfig(**cfg),
                           sampler=_replay(kind, N, jax.random.PRNGKey(3)), device="cpu")
    _same_run(rj, rt)


def test_sjlt_with_three_nonzeros_replays_reference():
    qj, qt = _problem(seed=2)
    cfg = dict(method="pcg", sketch="sjlt", tol=TOL, max_iters=200, sjlt_s=3)
    rj = ja.adaptive_solve(qj, ja.AdaptiveConfig(**cfg), key=jax.random.PRNGKey(0))
    rt = ta.adaptive_solve(qt, ta.AdaptiveConfig(**cfg), sampler=_replay("sjlt", N, s=3),
                           device="cpu")
    _same_run(rj, rt)


@pytest.mark.parametrize("m_init", [N, 2 * N])
def test_m_at_least_n_factorizes_A_itself(m_init):
    """The ceiling: m ≥ n draws no sketch, H_S = H, a one-step PCG solve."""
    qj, qt = _problem(seed=3)
    cfg = dict(method="pcg", sketch="gaussian", tol=TOL, m_init=m_init, max_iters=50)
    rj = ja.adaptive_solve(qj, ja.AdaptiveConfig(**cfg))

    def never(phase, m):
        raise AssertionError("no sketch is drawn at m ≥ n")
    rt = ta.adaptive_solve(qt, ta.AdaptiveConfig(**cfg), sampler=never, device="cpu")
    _same_run(rj, rt)
    assert rt.iters <= 2 and rt.n_doublings == 0


def test_cap_stops_doubling():
    """m_max below the doubling the problem asks for: rejections at the cap
    are accepted, the reference's way. (With m_max = 8 PCG needs 60-odd
    iterations and the packages stop one apart: a long fp32 run's last
    decision lands at the δ̃ floor; m_max = 16 takes 34.)"""
    qj, qt = _problem(seed=4)
    cfg = dict(method="pcg", sketch="sjlt", tol=TOL, m_max=16, max_iters=120)
    rj = ja.adaptive_solve(qj, ja.AdaptiveConfig(**cfg), key=jax.random.PRNGKey(0))
    rt = ta.adaptive_solve(qt, ta.AdaptiveConfig(**cfg), sampler=_replay("sjlt", N), device="cpu")
    _same_run(rj, rt)
    assert rt.m_final == 16


def _nan_sketch(m, n):
    return ts.Sketch(kind="gaussian", m=m, n=n, data={"S": torch.full((m, n), float("nan"))})


def test_non_finite_at_the_cap_resamples_then_stops():
    """A non-finite δ̃⁺ at the cap resamples the sketch (a new phase) and
    restarts at x; after the fourth resample the loop stops with the last
    finite iterate."""
    _, qt = _problem(seed=5)
    calls = []

    def sampler(phase, m):
        calls.append((phase, m))
        return _nan_sketch(m, N)
    cfg = ta.AdaptiveConfig(method="pcg", sketch="gaussian", m_init=16, m_max=16, tol=TOL)
    rt = ta.adaptive_solve(qt, cfg, sampler=sampler, device="cpu")
    assert calls == [(p, 16) for p in range(5)]
    assert rt.iters == 0 and rt.n_doublings == 0 and rt.m_trace == [16]
    assert torch.equal(rt.x, torch.zeros(D))


def test_non_finite_at_the_cap_recovers_on_a_finite_resample():
    _, qt = _problem(seed=5)
    good = _replay("gaussian", N)

    def sampler(phase, m):
        return _nan_sketch(m, N) if phase < 2 else good(phase, m)
    cfg = ta.AdaptiveConfig(method="pcg", sketch="gaussian", m_init=64, m_max=64, tol=TOL)
    rt = ta.adaptive_solve(qt, cfg, sampler=sampler, device="cpu")
    x_star = tq.direct_solve(qt)
    assert rt.iters > 0 and math.isfinite(rt.delta_tilde_trace[-1])
    assert float((rt.x - x_star).norm() / x_star.norm()) < 1e-3


def test_non_finite_below_the_cap_doubles():
    """Below the cap a non-finite δ̃⁺ is a rejection: the sketch doubles."""
    _, qt = _problem(seed=6)
    good = _replay("sjlt", N)

    def sampler(phase, m):
        return _nan_sketch(m, N) if phase == 0 else good(phase, m)
    cfg = ta.AdaptiveConfig(method="pcg", sketch="sjlt", m_init=4, tol=TOL, max_iters=200)
    rt = ta.adaptive_solve(qt, cfg, sampler=sampler, device="cpu")
    assert rt.m_trace[0] == 4 and rt.m_trace[1] == 8 and rt.n_doublings >= 1


def test_port_samplers_solve_each_family():
    """The port's own hash-seeded sketches (no hand-over) solve to the
    direct solution, each phase seeded fold_seeds(seed, phase)."""
    _, qt = _problem(seed=7)
    x_star = tq.direct_solve(qt)
    for kind in ("gaussian", "srht", "sjlt"):
        rt = ta.adaptive_solve(qt, ta.AdaptiveConfig(sketch=kind, tol=TOL), seed=9, device="cpu")
        assert float((rt.x - x_star).norm() / x_star.norm()) < 1e-3
        assert rt.m_final >= 4 and rt.iters < 100
        again = ta.adaptive_solve(qt, ta.AdaptiveConfig(sketch=kind, tol=TOL), seed=9,
                                  device="cpu")
        assert torch.equal(again.x, rt.x) and again.m_trace == rt.m_trace


def test_adaptive_solve_refuses_batches():
    _, qt = _problem()
    qb = tq.stack_quadratics([qt, qt])
    with pytest.raises(ValueError, match="one problem"):
        ta.adaptive_solve(qb, device="cpu")


@pytest.mark.parametrize("m_delta,rho,m_init", [(100.0, 0.5, 1), (3.0, 0.25, 4),
                                                 (0.1, 0.5, 1), (5000.0, 0.1, 2)])
def test_k_max_matches_reference(m_delta, rho, m_init):
    assert ta.k_max(m_delta, rho, m_init) == ja.k_max(m_delta, rho, m_init)


@pytest.mark.parametrize("method", ["ihs", "pcg"])
def test_newton_solve_replays_reference(method):
    rng = np.random.default_rng(8)
    J = (rng.standard_normal((N, D)) * 0.7 ** np.arange(D)).astype(np.float32)
    grad = rng.standard_normal(D).astype(np.float32)
    xj, rj = jsv.newton_solve(jnp.asarray(J), jnp.asarray(grad), 0.05, method=method,
                              tol=TOL, key=jax.random.PRNGKey(4))
    xt, rt = tsv.newton_solve(torch.as_tensor(J), torch.as_tensor(grad), 0.05,
                              method=method, tol=TOL,
                              sampler=_replay("sjlt", N, jax.random.PRNGKey(4)), device="cpu")
    _same_run(rj, rt)
    assert torch.equal(xt, rt.x)
    H = J.T.astype(np.float64) @ J + 0.05 ** 2 * np.eye(D)
    step = np.linalg.solve(H, -grad.astype(np.float64))
    assert np.abs(xt.numpy() - step).max() <= 1e-3 * np.abs(step).max()
