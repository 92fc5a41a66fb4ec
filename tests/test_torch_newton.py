"""The GLM objectives and the sketched-Newton driver against the JAX
reference on the CPU, and the service's GLM traffic.

Objectives and single Newton systems are compared directly (the systems
with the reference's sketch seeds handed over). Whole Newton runs draw
their per-step sketches from ``fold_seeds(seeds, t)``, which the reference
cannot reproduce, so they are compared by their answers: x against the
reference's exact-Newton (IRLS) solution."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive_padded as jap  # noqa: E402
from repro.core import level_grams as jlg  # noqa: E402
from repro.core import newton as jnewton  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core.quadratic import Quadratic as JQuadratic  # noqa: E402
from repro_torch.core import adaptive_padded as tap  # noqa: E402
from repro_torch.core import newton as tnewton  # noqa: E402
from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.core.quadratic import Quadratic, _as_batched_reg  # noqa: E402
from repro_torch.core.status import SolveStatus  # noqa: E402
from repro_torch.serve import solver_service as tsvc  # noqa: E402

torch.set_num_threads(1)

FAMILIES = ("logistic", "poisson", "huber", "huber:0.5", "quadratic")


def _glm_data(family, B, n, d, seed, shared=False):
    """(A, y) in numpy for a family: A/√d Gaussian, labels from planted
    coefficients (Bernoulli, Poisson counts, or a noisy linear response)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d) if shared else (B, n, d)) / np.sqrt(d)
    coef = 0.5 * rng.standard_normal((B, d))
    t = np.einsum("nd,bd->bn", A, coef) if shared else np.einsum("bnd,bd->bn", A, coef)
    if family == "logistic":
        y = (rng.random((B, n)) < 1.0 / (1.0 + np.exp(-t))).astype(np.float64)
    elif family == "poisson":
        y = rng.poisson(np.exp(t)).astype(np.float64)
    else:
        y = t + 0.3 * rng.standard_normal((B, n))
    return A.astype(np.float32), y.astype(np.float32)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.as_tensor(a) for a in arrays]


def _rel_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.linalg.norm(a - b, axis=-1)
                        / (np.linalg.norm(b, axis=-1) + 1e-30)))


# --- objectives ---------------------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_objectives_match_reference(family, shared):
    """glm_value (relative to x = 0), ∇F and the Newton weights of both
    packages on the same inputs, within 1e-6 of each quantity's scale,
    with margins large enough to reach POISSON_CLIP and huber's kink."""
    B, n, d = 3, 40, 6
    A, y = _glm_data(family.split(":")[0], B, n, d, seed=1, shared=shared)
    rng = np.random.default_rng(2)
    x = (0.4 * rng.standard_normal((B, d))).astype(np.float32)
    x[0] *= 40.0                          # saturated logistic, clipped Poisson
    nu = np.asarray([0.2, 0.5, 1.0], np.float32)
    lam = rng.uniform(1.0, 2.0, (B, d)).astype(np.float32)
    (Aj, yj, nuj, lamj, xj), (At, yt, nut, lamt, xt) = _both(A, y, nu, lam, x)
    oj, ot = jobj.get_objective(family), tobj.get_objective(family)
    assert ot.name == oj.name
    pairs = [(jobj.margins(Aj, xj), tobj.margins(At, xt)),
             (jobj.glm_value(oj, Aj, yj, nuj, lamj, xj),
              tobj.glm_value(ot, At, yt, nut, lamt, xt)),
             *zip(jobj.glm_grad_and_weights(oj, Aj, yj, nuj, lamj, xj),
                  tobj.glm_grad_and_weights(ot, At, yt, nut, lamt, xt))]
    for want, got in pairs:
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("family", FAMILIES)
def test_objective_grad_and_weights_match_autograd(family):
    """∇F and ℓ'' agree with torch autograd of the objective (fp64)."""
    obj = tobj.get_objective(family)
    A, y = _glm_data(family.split(":")[0], 3, 40, 6, seed=3)
    A, y = torch.as_tensor(A, dtype=torch.float64), torch.as_tensor(y, dtype=torch.float64)
    x = 0.3 * torch.randn((3, 6), generator=torch.Generator().manual_seed(0),
                          dtype=torch.float64)
    nu, lam = _as_batched_reg(0.2, None, 3, 6, torch.float64, "cpu")
    g, w = tobj.glm_grad_and_weights(obj, A, y, nu, lam, x)
    xr = x.clone().requires_grad_(True)
    tobj.glm_value(obj, A, y, nu, lam, xr).sum().backward()
    torch.testing.assert_close(g, xr.grad, rtol=1e-10, atol=1e-10)
    t = tobj.margins(A, x).requires_grad_(True)
    obj.dloss(t, y).sum().backward()
    torch.testing.assert_close(w, t.grad, rtol=1e-10, atol=1e-10)
    assert bool((w >= 0).all())


def test_get_objective_spellings():
    assert tobj.get_objective("huber:0.5").name == "huber[0.5]"
    obj = tobj.get_objective("logistic")
    assert tobj.get_objective(obj) is obj
    assert tobj.GLM_FAMILIES == jobj.GLM_FAMILIES
    with pytest.raises(ValueError, match="probit"):
        tobj.get_objective("probit")


def test_synthetic_logistic_problem_from_a_generator():
    """The port's own data law: the same generator seed draws the same
    problem; labels are 0/1 and roughly balanced; the batch stacks B draws."""
    A1, y1 = tobj.synthetic_logistic_problem(torch.Generator().manual_seed(4), 500, 10)
    A2, y2 = tobj.synthetic_logistic_problem(torch.Generator().manual_seed(4), 500, 10)
    assert torch.equal(A1, A2) and torch.equal(y1, y2)
    assert A1.shape == (500, 10) and set(y1.unique().tolist()) <= {0.0, 1.0}
    assert 0.2 < float(y1.mean()) < 0.8
    A, Y = tobj.synthetic_logistic_batch(torch.Generator().manual_seed(4), 3, 50, 10)
    assert A.shape == (3, 50, 10) and Y.shape == (3, 50)
    assert not torch.equal(A[0], A[1])


def test_line_search_matches_reference():
    """The Armijo line search of both packages on the same (x, Δ): the same
    step per problem (longer directions backtrack further; a non-descent Δ
    makes no progress) and the same x⁺ within fp32 rounding."""
    B, n, d = 4, 60, 5
    A, y = _glm_data("logistic", B, n, d, seed=5)
    rng = np.random.default_rng(6)
    x = (0.2 * rng.standard_normal((B, d))).astype(np.float32)
    nu = np.full(B, 0.3, np.float32)
    lam = np.ones((B, d), np.float32)
    oj, ot = jobj.get_objective("logistic"), tobj.get_objective("logistic")
    (Aj, yj, nuj, lamj, xj), (At, yt, nut, lamt, xt) = _both(A, y, nu, lam, x)
    g = np.asarray(jobj.glm_grad_and_weights(oj, Aj, yj, nuj, lamj, xj)[0])
    delta = -g * np.asarray([[1.0], [30.0], [200.0], [-1.0]], np.float32)
    dec = -np.sum(g * delta, axis=1).astype(np.float32)
    active = np.asarray([True, True, True, False])
    xj2, sj, okj = jnewton._line_search(oj, Aj, yj, nuj, lamj, xj, jnp.asarray(delta),
                                        jnp.asarray(dec), jnp.asarray(active),
                                        backtracks=12, c1=1e-4)
    xt2, st, okt = tnewton._line_search(ot, At, yt, nut, lamt, xt, torch.as_tensor(delta),
                                        torch.as_tensor(dec), torch.as_tensor(active),
                                        backtracks=12, c1=1e-4)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert 0 < float(st[2]) < float(st[1]) <= float(st[0]) and not bool(okt[3])
    np.testing.assert_allclose(xt2.numpy(), np.asarray(xj2), rtol=1e-6, atol=1e-7)
    assert torch.equal(xt2[3], xt[3])


# --- one Newton system --------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_one_newton_system_matches_reference(family):
    """One weighted Newton system (at x ≠ 0, so the weights vary) through
    both engines with the reference's seeds: the same status, m_final,
    doublings and level, iters within ±2, and Δ within 1e-4 relative."""
    B, n, d, m_max = 4, 300, 12, 32
    A, y = _glm_data(family.split(":")[0], B, n, d, seed=7)
    x = (0.3 * np.random.default_rng(8).standard_normal((B, d))).astype(np.float32)
    nu = np.asarray([0.3, 0.1, 0.05, 0.2], np.float32)
    lam = np.ones((B, d), np.float32)
    (Aj, yj, nuj, lamj, xj), (At, yt, nut, lamt, xt) = _both(A, y, nu, lam, x)
    gj, wj = jobj.glm_grad_and_weights(jobj.get_objective(family), Aj, yj, nuj, lamj, xj)
    gt, wt = tobj.glm_grad_and_weights(tobj.get_objective(family), At, yt, nut, lamt, xt)
    qj = JQuadratic(A=Aj, b=-gj, nu=nuj, lam_diag=lamj, batched=True, row_weights=wj)
    qt = Quadratic(A=At, b=-gt, nu=nut, lam_diag=lamt, batched=True, row_weights=wt)
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    kw = dict(m_max=m_max, method="pcg", max_iters=100, tol=1e-10)
    dj, sj = jap.padded_adaptive_solve_batched(qj, keys, **kw)
    dt, st = tap.padded_adaptive_solve_batched(
        qt, torch.as_tensor(np.asarray(jlg._uint32_seeds(keys)).astype(np.int64)),
        device="cpu", **kw)
    for k in ("status", "m_final", "doublings", "level"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]), err_msg=k)
    assert np.all(np.abs(st["iters"].numpy() - np.asarray(sj["iters"])) <= 2)
    assert _rel_rows(dt.numpy(), dj) <= 1e-4


# --- whole Newton runs --------------------------------------------------------------

@pytest.mark.parametrize("sketch,compute_dtype", [
    ("gaussian", "fp32"), ("gaussian", "bf16"), ("gaussian", "int8"),
    ("gaussian_dense", "fp32"), ("sjlt", "fp32"), ("sjlt", "int8"), ("srht", "fp32"),
    ("srht", "bf16")])
def test_logistic_batch_matches_reference_irls(sketch, compute_dtype):
    """The acceptance case: a B = 8 logistic batch through the port's
    adaptive sketched Newton is within 1e-4 of the reference's IRLS answer,
    in every family and sketch-pass dtype, every decrement below tolerance,
    every inner m on the ladder."""
    B, n, d = 8, 400, 24
    A, y = _glm_data("logistic", B, n, d, seed=0)
    x, stats = tnewton.adaptive_newton_solve_batched(
        "logistic", torch.as_tensor(A), torch.as_tensor(y), 0.3, m_max=64,
        seeds=torch.arange(B, dtype=torch.int64) + 5, sketch=sketch,
        compute_dtype=compute_dtype, device="cpu")
    x_ref = jnewton.irls_reference("logistic", jnp.asarray(A), jnp.asarray(y), 0.3)
    assert _rel_rows(x.numpy(), x_ref) < 1e-4
    assert bool(stats["converged"].all()) and float(stats["decrement"].max()) <= 1e-10
    assert bool((stats["status"] == int(SolveStatus.OK)).all())
    traj = stats["m_trajectory"]
    assert traj.shape[1] == B and set(traj.ravel().tolist()) <= set(
        tap.doubling_ladder(64)) | {0}
    assert np.array_equal(stats["m_final"].numpy(), np.asarray(
        [[m for m in traj[:, b] if m > 0][-1] for b in range(B)]))


@pytest.mark.parametrize("family,nu", [("poisson", 0.3), ("huber", 0.3),
                                       ("huber:0.5", 0.2), ("quadratic", 0.2)])
def test_other_families_match_reference_irls(family, nu):
    """Poisson, huber and the quadratic family: the port's sketched Newton
    within 1e-4 of the reference's IRLS answer, all converged."""
    B, n, d = 4, 300, 12
    A, y = _glm_data(family.split(":")[0], B, n, d, seed=21)
    x, stats = tnewton.adaptive_newton_solve_batched(
        family, torch.as_tensor(A), torch.as_tensor(y), nu, m_max=32, seeds=6,
        device="cpu")
    x_ref = jnewton.irls_reference(family, jnp.asarray(A), jnp.asarray(y), nu)
    assert _rel_rows(x.numpy(), x_ref) < 1e-4, family
    assert bool(stats["converged"].all())
    if family == "quadratic":        # W ≡ 1: the first full step is the answer
        assert int(stats["newton_iters"].max()) <= 3


@pytest.mark.parametrize("family", ["logistic", "poisson", "huber"])
def test_irls_and_newton_cg_references_match(family):
    """The port's IRLS equals the reference's within 1e-5 (fp32 both), its
    fp64 IRLS lies within 1e-4 of both, and Newton-CG agrees to 1e-4."""
    A, y = _glm_data(family, 2, 200, 8, seed=13, shared=family == "huber")
    xj = jnewton.irls_reference(family, jnp.asarray(A), jnp.asarray(y), 0.3)
    At, yt = torch.as_tensor(A), torch.as_tensor(y)
    xt = tnewton.irls_reference(family, At, yt, 0.3, device="cpu")
    x64 = tnewton.irls_reference(family, At.double(), yt.double(), 0.3, device="cpu")
    assert x64.dtype == torch.float64
    assert _rel_rows(xt.numpy(), xj) < 1e-5
    assert _rel_rows(x64.numpy(), xj) < 1e-4
    x_cg = tnewton.newton_cg_reference(family, At, yt, 0.3, device="cpu")
    assert _rel_rows(x_cg.numpy(), x64.numpy()) < 1e-4


def test_single_problem_wrapper():
    A, y = _glm_data("logistic", 1, 200, 8, seed=4)
    At, yt = torch.as_tensor(A[0]), torch.as_tensor(y[0])
    x, stats = tnewton.adaptive_newton_solve("logistic", At, yt, 0.3, m_max=32, seed=2,
                                             device="cpu")
    assert x.shape == (8,) and stats["m_trajectory"].ndim == 1
    assert float(stats["decrement"]) <= 1e-9 and stats["status"].dim() == 0
    xb, _ = tnewton.adaptive_newton_solve_batched("logistic", At[None], yt[None], 0.3,
                                                  m_max=32, seeds=torch.tensor([2]),
                                                  device="cpu")
    assert float(torch.linalg.norm(x - xb[0])) < 1e-3


def test_warm_started_ladder_levels_carry_across_steps():
    """An ill-conditioned logistic batch whose first Newton step climbs the
    ladder: later steps start from the level found, so each problem's m
    trajectory never decreases; the answer is within 1e-3 of fp64 IRLS."""
    B, n, d = 3, 512, 48
    rng = np.random.default_rng(11)
    As, Ys = [], []
    for _ in range(B):
        U, _ = np.linalg.qr(rng.standard_normal((n, d)))
        V, _ = np.linalg.qr(rng.standard_normal((d, d)))
        A = (U * 0.9 ** np.arange(d)[None, :]) @ V.T
        p = 1.0 / (1.0 + np.exp(-4.0 * A @ rng.standard_normal(d)))
        As.append(A)
        Ys.append((rng.random(n) < p).astype(np.float64))
    A = torch.as_tensor(np.stack(As), dtype=torch.float32)
    Y = torch.as_tensor(np.stack(Ys), dtype=torch.float32)
    x, stats = tnewton.adaptive_newton_solve_batched("logistic", A, Y, 0.05, m_max=128,
                                                     seeds=3, device="cpu")
    traj = stats["m_trajectory"]
    for b in range(B):
        ms = [m for m in traj[:, b] if m > 0]
        assert ms == sorted(ms) and len(ms) >= 2, (b, ms)
    assert int(traj[0].max()) < 128 or int(traj[0].min()) > 1
    x_ref = tnewton.irls_reference("logistic", A.double(), Y.double(), 0.05, device="cpu")
    assert _rel_rows(x.numpy(), x_ref.numpy()) < 1e-3


def test_newton_runs_on_cuda_by_default():
    """The driver's default device is CUDA: without a card it raises, with
    one it refuses CPU tensors instead of copying them."""
    A, y = (torch.as_tensor(a) for a in _glm_data("logistic", 2, 50, 4, seed=1))
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="expected cuda"):
            tnewton.adaptive_newton_solve_batched("logistic", A, y, 0.3, m_max=8)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnewton.adaptive_newton_solve_batched("logistic", A, y, 0.3, m_max=8)


# --- the service --------------------------------------------------------------------

def _service(**kw):
    return tsvc.SolverService((tsvc.ShapeClass(256, 32, 64), tsvc.ShapeClass(1024, 64, 128)),
                              batch_size=4, device="cpu", **kw)


def _glm_requests(k=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        n, d = int(rng.integers(80, 900)), int(rng.integers(8, 50))
        A = rng.standard_normal((n, d)) / np.sqrt(d)
        p = 1.0 / (1.0 + np.exp(-A @ rng.standard_normal(d)))
        y = (rng.random(n) < p).astype(np.float32)
        out.append((A.astype(np.float32), y, float(rng.uniform(0.2, 0.5))))
    return out


def test_solver_service_glm_certificates():
    """GLM and ridge traffic in one flush: every GLM answer converged, its
    decrement within ``newton_tol``, its m trajectory ending at m_final, its
    x within 1e-3 of the port's fp64 IRLS (itself held to the reference's
    IRLS by ``test_irls_and_newton_cg_references_match``)."""
    svc = _service()
    reqs = [(svc.submit_glm(A, y, nu, family="logistic"), A, y, nu)
            for A, y, nu in _glm_requests()]
    rid_ridge = svc.submit(np.ones((100, 8), np.float32) / 10.0,
                           np.ones(100, np.float32), 0.3)
    sols = svc.flush()
    assert len(sols) == 6 and not isinstance(sols[rid_ridge], tsvc.GLMSolution)
    for rid, A, y, nu in reqs:
        s = sols[rid]
        assert isinstance(s, tsvc.GLMSolution) and s.x.shape == (A.shape[1],)
        assert s.family == "logistic" and s.converged and s.status == "OK"
        assert s.newton_iters >= 1 and len(s.m_trajectory) >= 1
        assert s.m_final == s.m_trajectory[-1] and s.inner_iters >= s.newton_iters
        assert s.decrement <= svc.newton_tol
        x64 = tnewton.irls_reference("logistic", torch.as_tensor(A, dtype=torch.float64),
                                     torch.as_tensor(y, dtype=torch.float64)[None], nu,
                                     device="cpu")[0].numpy()
        assert np.linalg.norm(s.x.numpy() - x64) / np.linalg.norm(x64) < 1e-3, rid
    assert all(not v for v in svc._glm_queues.values())
    assert svc.stats["batches"] == 3


@pytest.mark.parametrize("family", ["poisson", "huber:0.5"])
def test_solver_service_glm_other_families(family):
    """Poisson and huber:δ requests pack by family and converge to the
    port's fp64 IRLS answer within 1e-3."""
    svc = _service()
    data = []
    for i in range(3):
        A, y = _glm_data(family.split(":")[0], 1, 150 + 40 * i, 10 + i, seed=30 + i)
        data.append((svc.submit_glm(A[0], y[0], 0.3, family=family), A[0], y[0]))
    sols = svc.flush()
    for rid, A, y in data:
        s = sols[rid]
        assert s.family == family and s.converged
        x64 = tnewton.irls_reference(family, torch.as_tensor(A, dtype=torch.float64),
                                     torch.as_tensor(y, dtype=torch.float64)[None], 0.3,
                                     device="cpu")[0].numpy()
        assert np.linalg.norm(s.x.numpy() - x64) / np.linalg.norm(x64) < 1e-3
    assert svc.stats["batches"] == 1


def test_solver_service_glm_validates_and_quarantines():
    svc = _service()
    A, y = np.ones((64, 8), np.float32) / 8.0, np.ones(64, np.float32)
    with pytest.raises(ValueError):
        svc.submit_glm(A, y, 0.0, family="logistic")       # ν = 0 rejected
    with pytest.raises(ValueError):
        svc.submit_glm(A, y, 0.3, family="probit")         # unknown family
    lenient = _service(strict=False)
    bad = A.copy()
    bad[3, 2] = np.nan
    rid = lenient.submit_glm(bad, y, 0.3)
    late = lenient.submit_glm(A, y, 0.3, deadline_s=0.0)
    sols = lenient.flush()
    assert sols[rid].status == SolveStatus.REJECTED.name and not sols[rid].converged
    assert "A" in lenient.rejection_reasons[rid]
    e = sols[late]
    assert isinstance(e, tsvc.GLMSolution) and e.status == "DEADLINE_EXCEEDED"
    assert e.newton_iters == 0 and bool((e.x == 0).all())
    assert lenient.stats["batches"] == 0 and lenient.stats["deadline_exceeded"] == 1


def test_glm_deadline_binds_between_newton_steps(monkeypatch):
    """A deadline of 2 s on a clock that advances one second per Newton
    step: the chunk runs two outer steps, then stops. Each request not
    converged by then comes back DEADLINE_EXCEEDED with the iterate of a
    two-step run (bitwise) and a finite decrement; the others keep OK."""
    reqs = _glm_requests(4, seed=3)
    capped = _service()
    capped.newton_iters = 2
    ids = [capped.submit_glm(A, y, nu) for A, y, nu in reqs]
    want = capped.flush()
    expected = ["OK" if want[i].converged else "DEADLINE_EXCEEDED" for i in ids]
    assert "DEADLINE_EXCEEDED" in expected

    clock = types.SimpleNamespace(now=0.0)
    fake = types.SimpleNamespace(perf_counter=lambda: clock.now)
    monkeypatch.setattr(tnewton, "time", fake)
    monkeypatch.setattr(tsvc, "time", fake)
    solve = tnewton.padded_adaptive_solve_batched

    def ticking(*a, **k):
        clock.now += 1.0
        return solve(*a, **k)

    monkeypatch.setattr(tnewton, "padded_adaptive_solve_batched", ticking)
    svc = _service()
    ids2 = [svc.submit_glm(A, y, nu, deadline_s=2.0) for A, y, nu in reqs]
    sols = svc.flush()
    assert clock.now == 2.0
    assert [sols[i].status for i in ids2] == expected
    for i, j in zip(ids, ids2):
        assert torch.equal(sols[j].x, want[i].x) and np.isfinite(sols[j].decrement)
        assert sols[j].newton_iters == want[i].newton_iters
    assert svc.stats["deadline_exceeded"] == expected.count("DEADLINE_EXCEEDED")
