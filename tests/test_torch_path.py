"""The regularization-path engine and the λ-free ladder cache: the whole ν
grid off one sketch pass, within the port and against the JAX reference on
the CPU.

Within the port, bitwise: a path with ``warm_start=False`` is a per-ν loop
of single solves, handed the shared ladder or recomputing it inline; a
ladder-cache repeat is the cold round. Against the reference: the robust
path's per-point certificates, on its own pass and on the reference's
Grams handed over (the knife edge of ROADMAP queue 3 can move a point's
m_final by an ulp of its Grams; handed the Grams, every certificate is the
reference's)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive_padded as jap  # noqa: E402
from repro.core import level_grams as jlg  # noqa: E402
from repro.core.quadratic import from_least_squares_batch as j_flsb  # noqa: E402
from repro.core.robust import robust_padded_solve_batched as j_robust  # noqa: E402
from repro.core.robust import robust_path_solve_batched as j_robust_path  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import adaptive_padded as tap  # noqa: E402
from repro_torch.core import level_grams as tlg  # noqa: E402
from repro_torch.core import robust as trb  # noqa: E402
from repro_torch.core.quadratic import direct_solve  # noqa: E402
from repro_torch.core.quadratic import from_least_squares_batch as t_flsb  # noqa: E402
from repro_torch.core.status import SolveStatus  # noqa: E402
from repro_torch.serve import solver_service as tsvc  # noqa: E402

torch.set_num_threads(1)

B = 3


def _problem(B, n, d, seed=0):
    """Port-only problems: A/√n Gaussian, y Gaussian, from a numpy seed."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, n, d)) / np.sqrt(n)).astype(np.float32)
    Y = rng.standard_normal((B, n)).astype(np.float32)
    q = t_flsb(torch.as_tensor(A), torch.as_tensor(Y), torch.ones(B))
    return q, torch.as_tensor([101, 202, 303], dtype=torch.int64)[:B]


def _rel(a, b):
    return float(torch.max(torch.linalg.norm(a - b, dim=-1)
                           / (torch.linalg.norm(b, dim=-1) + 1e-30)))


def _q_at(q, nu):
    return dataclasses.replace(q, nu=torch.full((q.batch,), float(nu)))


# --- the engine, within the port -------------------------------------------------

@pytest.mark.parametrize("family,m_max", [("gaussian", 64), ("gaussian_dense", 64),
                                          ("sjlt", 64), ("srht", 64), ("sjlt", 48)])
def test_path_matches_independent_single_lambda(family, m_max):
    """Each point of the path matches an independent single-ν solve within
    1e-5 and a dense direct solve within 1e-3, with finite converged δ̃,
    and the whole grid paid one sketch pass. Both sides start at level 4
    (m = 16 = d), so both are deeply converged solves."""
    n, d, P = 512, 16, 6
    q, seeds = _problem(B, n, d)
    nus = torch.as_tensor(np.geomspace(1.0, 1e-2, P), dtype=torch.float32)
    lvl = torch.full((B,), 4, dtype=torch.int64)
    kw = dict(m_max=m_max, method="pcg", sketch=family, max_iters=200, tol=1e-12,
              device="cpu")
    xs, stats = tap.padded_path_solve_batched(q, seeds, nus, init_level=lvl, **kw)
    assert stats["sketch_passes"] == 1 and xs.shape == (P, B, d)
    assert stats["dtilde"].shape == (P, B) and stats["trips"].shape == (P,)
    assert bool(torch.isfinite(stats["dtilde"]).all()) and float(stats["dtilde"].max()) <= 1e-9
    for p in range(P):
        q_p = _q_at(q, nus[p])
        x_ref, _ = tap.padded_adaptive_solve_batched(q_p, seeds, init_level=lvl, **kw)
        assert _rel(xs[p], x_ref) <= 1e-5, p
        assert _rel(xs[p], direct_solve(q_p)) <= 1e-3, p


def test_warm_start_level_trajectories_monotone():
    """Walked from strong to weak regularization, a warm-started grid never
    re-climbs the ladder: the levels never decrease along the path."""
    q, seeds = _problem(B, 512, 16)
    nus = np.geomspace(1.0, 1e-2, 8)
    _, stats = tap.padded_path_solve_batched(q, seeds, nus, m_max=64, method="pcg",
                                             max_iters=200, tol=1e-12, device="cpu")
    lv = stats["level"]
    assert lv.shape == (8, B)
    assert bool((lv[1:] >= lv[:-1]).all()), lv
    assert int(lv[-1].min()) > int(lv[0].max())         # it did climb


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("family", ["gaussian", "gaussian_dense", "sjlt", "srht"])
def test_path_bitwise_matches_looped_single_lambda(family, compute_dtype):
    """With warm start off, the path is bitwise a per-ν loop of single
    solves at the same init level: handed the shared λ-free ladder, and
    recomputing it inline (the same seeds draw the same sketch)."""
    P, m_max = 4, 32
    q, seeds = _problem(B, 256, 16, seed=10)
    nus = torch.as_tensor(np.geomspace(1.0, 1e-2, P), dtype=torch.float32)
    lvl = torch.full((B,), 3, dtype=torch.int64)
    kw = dict(m_max=m_max, method="pcg", sketch=family, max_iters=200, tol=1e-12,
              compute_dtype=compute_dtype, device="cpu")
    xs, st = tap.padded_path_solve_batched(q, seeds, nus, init_level=lvl,
                                           warm_start=False, **kw)
    grams, gfull = tap.prepare_path_ladder(q, seeds, m_max=m_max, sketch=family,
                                           compute_dtype=compute_dtype, device="cpu")
    for p in range(P):
        q_p = _q_at(q, nus[p])
        x_sh, s_sh = tap.padded_adaptive_solve_batched(q_p, seeds, init_level=lvl,
                                                       grams=grams, gram_full=gfull, **kw)
        x_in, s_in = tap.padded_adaptive_solve_batched(q_p, seeds, init_level=lvl, **kw)
        assert torch.equal(xs[p], x_sh) and torch.equal(xs[p], x_in), p
        for k in ("dtilde", "m_final", "iters", "status"):
            assert torch.equal(st[k][p], s_sh[k]) and torch.equal(st[k][p], s_in[k]), (p, k)


def test_prepare_path_ladder_is_lambda_free():
    """The ladder and the true Gram read neither ν nor Λ, and the engine's
    own pass equals them: the Grams it would compute inline."""
    q, seeds = _problem(B, 256, 16)
    g1, f1 = tap.prepare_path_ladder(q, seeds, m_max=32, device="cpu")
    q2 = dataclasses.replace(q, nu=torch.full((B,), 7.0), lam_diag=q.lam_diag * 3.0)
    g2, f2 = tap.prepare_path_ladder(q2, seeds, m_max=32, device="cpu")
    assert torch.equal(g1, g2) and torch.equal(f1, f2)
    assert g1.shape == (len(tap.doubling_ladder(32)), B, 16, 16) and f1.shape == (B, 16, 16)
    assert tap.prepare_path_ladder(q, seeds, m_max=32, gram_hvp=False,
                                   device="cpu")[1] is None


def test_path_nus_per_problem_grid():
    """A (P, B) grid gives each problem its own ν at each point."""
    q, seeds = _problem(B, 256, 16)
    grid = torch.tensor([[1.0, 0.5, 0.2], [0.1, 0.05, 0.02]])
    xs, stats = tap.padded_path_solve_batched(q, seeds, grid, m_max=32, method="pcg",
                                              max_iters=200, tol=1e-12, device="cpu")
    for p in range(2):
        q_p = dataclasses.replace(q, nu=grid[p])
        assert _rel(xs[p], direct_solve(q_p)) <= 1e-3
    with pytest.raises(ValueError, match="nus"):
        tap.padded_path_solve_batched(q, seeds, torch.ones(2, B + 1), m_max=32, device="cpu")


def test_robust_path_clean_traffic():
    """On clean data every point is OK and converged with no retry and no
    fallback, and the grid paid one sketch pass."""
    P = 4
    q, seeds = _problem(B, 256, 16, seed=5)
    nus = np.geomspace(1.0, 0.05, P)
    xs, stats = trb.robust_path_solve_batched(q, seeds, nus, m_max=32, method="pcg",
                                              max_iters=200, tol=1e-10, device="cpu")
    assert stats["sketch_passes"] == 1 and xs.shape == (P, B, 16)
    assert bool((stats["status"] == int(SolveStatus.OK)).all())
    assert bool(stats["converged"].all()) and int(stats["retries"].max()) == 0
    assert not bool(stats["fell_back"].any())
    assert stats["trips"] > 0 and stats["segments"] == 0


def test_robust_path_counts_retry_passes():
    """A point whose slots stall (max_iters = 3) retries them with a redrawn
    sketch: each retry attempt is one more sketch pass, and the fallback
    answers what the retries do not."""
    P = 3
    q, seeds = _problem(B, 256, 16, seed=6)
    xs, stats = trb.robust_path_solve_batched(q, seeds, np.geomspace(0.3, 0.01, P),
                                              m_max=32, method="pcg", max_iters=3,
                                              tol=1e-12, device="cpu")
    per_point = stats["retries"].max(dim=1).values
    assert int(per_point.sum()) >= 1
    assert stats["sketch_passes"] == 1 + int(per_point.sum())
    assert bool(torch.isfinite(xs).all())


# --- against the reference ------------------------------------------------------------

class _Handed:
    """A port provider that draws the reference's sample of ``keys``."""

    def __init__(self, family, keys, m_max, n):
        s = jlg.get_provider(family).sample(keys, m_max, n, jnp.float32)
        self.data = bridge.sample_from_numpy({k: np.asarray(v) for k, v in s.items()},
                                             device="cpu")
        self.inner = tlg.get_provider(family)

    def sample(self, seeds, m_max, n):
        return self.data

    def level_grams(self, *args, **kwargs):
        return self.inner.level_grams(*args, **kwargs)


def _flips_under_one_ulp(solve, q, slot, target):
    """Whether moving one entry of the reference's b_slot by one ulp moves
    the reference's own m_final of that slot to ``target``: the knife edge
    (ROADMAP queue 3), where another summation order decides a doubling."""
    b = np.asarray(q.b)
    for k in range(b.shape[1]):
        for to in (np.inf, -np.inf):
            bb = b.copy()
            bb[slot, k] = np.nextafter(bb[slot, k], np.float32(to))
            _, s = solve(dataclasses.replace(q, b=jnp.asarray(bb)))
            if int(np.asarray(s["m_final"])[slot]) == target:
                return True
    return False


@pytest.mark.parametrize("family,compute_dtype", [
    ("gaussian", "fp32"), ("gaussian", "bf16"), ("sjlt", "fp32"), ("srht", "fp32")])
def test_robust_path_certificates_match_reference(family, compute_dtype):
    """The robust path in both packages on the same problems and randomness.

    The port's whole path, on its own pass: the reference's statuses, one
    sketch pass, and x within max(1e-4, 2^-24·κ) per problem and point.

    Each point alone, handed the reference's ladder, true Gram and warm
    start (the previous point's x and level): the reference's status, and
    its m_final, level and doublings, iters within ±2, on every slot but a
    knife-edge one. On such a slot the PCG loop's own rounding decides a
    doubling: there the reference, its b moved by one ulp in one entry,
    gives the port's m_final itself."""
    n, d, m_max, P = 512, 16, 32, 5
    rng = np.random.default_rng(21)
    As = []
    for rate in (0.7, 0.85, 0.9):
        U, _ = np.linalg.qr(rng.standard_normal((n, d)))
        V, _ = np.linalg.qr(rng.standard_normal((d, d)))
        As.append((U * rate ** np.arange(1, d + 1)[None, :]) @ V.T)
    A = np.stack(As).astype(np.float32)
    Y = rng.standard_normal((B, n)).astype(np.float32)
    nus = np.geomspace(0.3, 3e-3, P).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    seeds = torch.as_tensor(np.asarray(jlg._uint32_seeds(keys)).astype(np.int64))
    qj = j_flsb(jnp.asarray(A), jnp.asarray(Y), jnp.ones(B))
    qt = t_flsb(torch.as_tensor(A), torch.as_tensor(Y), torch.ones(B))
    kw = dict(m_max=m_max, method="pcg", sketch=family, max_iters=200, tol=1e-10,
              compute_dtype=compute_dtype)
    xj, sj = j_robust_path(qj, keys, jnp.asarray(nus), **kw)
    xj = np.array(xj)
    sj = {k: np.array(v) for k, v in sj.items()}
    assert len(set(sj["m_final"].ravel().tolist())) >= 3
    own = {} if family == "gaussian" else {"sketch": _Handed(family, keys, m_max, n)}
    xt, st = trb.robust_path_solve_batched(qt, seeds, nus, device="cpu", **{**kw, **own})
    assert st["sketch_passes"] == sj["sketch_passes"] == 1
    np.testing.assert_array_equal(st["status"].numpy(), sj["status"])
    G64 = torch.bmm(qt.A.double().transpose(1, 2), qt.A.double())
    for p in range(P):
        ev = torch.linalg.eigvalsh(G64 + float(nus[p]) ** 2 * torch.eye(d, dtype=torch.float64))
        tol = np.maximum(1e-4, 2.0 ** -24 * (ev[:, -1] / ev[:, 0]).numpy())
        rel = np.linalg.norm(xt[p].numpy() - xj[p], axis=1) / np.linalg.norm(xj[p], axis=1)
        assert np.all(rel <= tol), (p, rel, tol)

    gj, fj = jap.prepare_path_ladder(qj, keys, m_max=m_max, sketch=family,
                                     compute_dtype=compute_dtype)
    gt, ft = torch.as_tensor(np.array(gj)), torch.as_tensor(np.array(fj))
    agree = 0
    for p in range(P):
        warm_t = {} if p == 0 else dict(x0=torch.as_tensor(xj[p - 1]),
                                        init_level=torch.as_tensor(sj["level"][p - 1]))
        warm_j = {} if p == 0 else dict(x0=jnp.asarray(xj[p - 1]),
                                        init_level=jnp.asarray(sj["level"][p - 1]))
        qj_p = dataclasses.replace(qj, nu=jnp.full((B,), nus[p]))
        _, s = trb.robust_padded_solve_batched(
            _q_at(qt, nus[p]), seeds, grams=gt, gram_full=ft, device="cpu", **kw, **warm_t)
        np.testing.assert_array_equal(s["status"].numpy(), sj["status"][p])

        def solve(q):
            return j_robust(q, keys, grams=gj, gram_full=fj, **kw, **warm_j)

        for b in range(B):
            same = all(int(s[k][b]) == int(sj[k][p, b])
                       for k in ("m_final", "level", "doublings"))
            if same:
                agree += 1
                assert abs(int(s["iters"][b]) - int(sj["iters"][p, b])) <= 2
            else:
                assert _flips_under_one_ulp(solve, qj_p, b, int(s["m_final"][b])), (p, b)
    assert agree >= P * B - 2, agree


# --- the service --------------------------------------------------------------------

def _ridge_data(n, d, seed):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, d)) / np.sqrt(n)).astype(np.float32)
    return A, rng.standard_normal(n).astype(np.float32)


def _service(**kw):
    return tsvc.SolverService([tsvc.ShapeClass(256, 32, 64)], batch_size=4, tol=1e-10,
                              device="cpu", **kw)


def test_service_path_certificates():
    """submit_path → flush: per-ν PathPoints with the whole certificate,
    answers within 1e-4 of a direct solve, one sketch pass per chunk."""
    svc = _service()
    nus = tuple(np.geomspace(1.0, 0.05, 6))
    rids = [svc.submit_path(*_ridge_data(256, 32, 100 + i), nus) for i in range(3)]
    sols = svc.flush()
    assert svc.stats["path_requests"] == 3 and svc.stats["batches"] == 1
    for i, rid in enumerate(rids):
        sol = sols[rid]
        assert isinstance(sol, tsvc.PathSolution) and sol.batch_index == i
        assert sol.status == "OK" and sol.converged
        assert sol.sketch_passes == 1 and not sol.cache_hit and len(sol.points) == 6
        A, y = _ridge_data(256, 32, 100 + i)
        for pt, nu in zip(sol.points, nus):
            assert pt.nu == nu and pt.converged and np.isfinite(pt.delta_tilde)
            x_ref = np.linalg.solve(A.T.astype(np.float64) @ A + nu ** 2 * np.eye(32),
                                    A.T.astype(np.float64) @ y)
            rel = np.linalg.norm(pt.x.numpy() - x_ref) / np.linalg.norm(x_ref)
            assert rel <= 1e-4, (rid, nu, rel)


def test_service_ladder_cache_repeat_path():
    """The same (A, y, grid) again under ``ladder_cache=True``: the ladder
    comes from the cache (cache_hit, sketch_passes 0, no sketch pass run),
    and the answers are bitwise the cold round's."""
    svc = _service(ladder_cache=True)
    A, y = _ridge_data(256, 32, 7)
    nus = tuple(np.geomspace(1.0, 0.05, 5))
    rid1 = svc.submit_path(A, y, nus)
    cold = svc.flush()[rid1]
    assert not cold.cache_hit and cold.sketch_passes == 1
    calls = []
    ladder = tsvc.prepare_path_ladder
    try:
        tsvc.prepare_path_ladder = lambda *a, **k: calls.append(1) or ladder(*a, **k)
        rid2 = svc.submit_path(A, y, nus)
        warm = svc.flush()[rid2]
    finally:
        tsvc.prepare_path_ladder = ladder
    assert warm.cache_hit and warm.sketch_passes == 0 and warm.converged and not calls
    assert svc.stats["sketch_passes_saved"] == 1
    assert (svc.stats["ladder_cache_hits"], svc.stats["ladder_cache_misses"]) == (1, 1)
    for a, b in zip(cold.points, warm.points):
        assert torch.equal(a.x, b.x)
        assert (a.delta_tilde, a.m_final, a.iters, a.doublings, a.status) == \
            (b.delta_tilde, b.m_final, b.iters, b.doublings, b.status)


def test_service_ladder_cache_shared_with_ridge():
    """The fingerprint is λ-free: a ridge request on data a path request
    already sketched skips its sketch pass, and records cache_hit."""
    svc = _service(ladder_cache=True)
    A, y = _ridge_data(256, 32, 11)
    assert svc.flush() == {}
    rid_path = svc.submit_path(A, y, tuple(np.geomspace(1.0, 0.1, 4)))
    assert svc.flush()[rid_path].sketch_passes == 1
    rid = svc.submit(A, y, nu=0.3)
    sol = svc.flush()[rid]
    assert sol.cache_hit and sol.converged
    x_ref = np.linalg.solve(A.T.astype(np.float64) @ A + 0.09 * np.eye(32),
                            A.T.astype(np.float64) @ y)
    assert np.linalg.norm(sol.x.numpy() - x_ref) / np.linalg.norm(x_ref) <= 1e-4


def test_ladder_fingerprint_reads_every_byte_and_lru():
    """The fingerprint changes with any one entry of A or Λ, with the class,
    the family and the dtype, but not with y or ν; the store keeps the
    ``ladder_cache_size`` most recently used slices."""
    svc = _service(ladder_cache=True, ladder_cache_size=1)
    cls = svc.shape_classes[0]
    A = torch.as_tensor(_ridge_data(256, 32, 3)[0])
    fp = svc._ladder_fingerprint(A, None, cls, "gaussian", "fp32")
    A2 = A.clone()
    A2[-1, -1] = torch.nextafter(A2[-1, -1], torch.tensor(1.0))
    others = [svc._ladder_fingerprint(A2, None, cls, "gaussian", "fp32"),
              svc._ladder_fingerprint(A, torch.full((32,), 2.0), cls, "gaussian", "fp32"),
              svc._ladder_fingerprint(A, None, cls, "sjlt", "fp32"),
              svc._ladder_fingerprint(A, None, cls, "gaussian", "bf16")]
    assert len({fp, *others}) == 5
    assert 0 <= svc._fp_slot_id(fp) < 2 ** 31
    for seed in (3, 4, 3):
        Ai, yi = _ridge_data(256, 32, seed)
        svc.submit_path(Ai, yi, (1.0, 0.1))
        svc.flush()
    assert len(svc._ladder_store) == 1
    assert svc.stats["ladder_cache_misses"] == 3 and svc.stats["ladder_cache_hits"] == 0


def test_service_path_grid_validation_and_expiry():
    """Every ν of the grid is checked: strict raises on a ν = 0 anywhere,
    lenient quarantines the request into a REJECTED PathSolution; an empty
    grid raises; a spent deadline expires the chunk without a solve."""
    A, y = _ridge_data(256, 32, 13)
    strict = _service()
    with pytest.raises(ValueError):
        strict.submit_path(A, y, (1.0, 0.0, 0.1))
    with pytest.raises(ValueError):
        strict.submit_path(A, y, ())
    lenient = _service(strict=False)
    rid = lenient.submit_path(A, y, (1.0, 0.0, 0.1))
    late = lenient.submit_path(A, y, (1.0, 0.1), deadline_s=0.0)
    sols = lenient.flush()
    sol = sols[rid]
    assert sol.status == SolveStatus.REJECTED.name and not sol.converged
    assert sol.sketch_passes == 0 and len(sol.points) == 3
    assert all(p.status == SolveStatus.REJECTED.name for p in sol.points)
    e = sols[late]
    assert e.status == "DEADLINE_EXCEEDED" and e.sketch_passes == 0
    assert all(p.iters == 0 and bool((p.x == 0).all()) for p in e.points)
    assert lenient.stats["deadline_exceeded"] == 1 and lenient.stats["batches"] == 0
