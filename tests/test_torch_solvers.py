"""The port's problem container, sketched preconditioner and fixed-sketch
methods against the JAX reference on the CPU, on the same numpy inputs:
``core.quadratic`` (hvp, value, error, λ sweeps, stacking, the chunked
weighted Gram, the direct solve), ``core.precond`` (primal and dual
factorizations, single, batched and shared) and ``core.solvers`` (the IHS,
Polyak and PCG steps through ``run_fixed``, and plain CG)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precond as jpc  # noqa: E402
from repro.core import quadratic as jq  # noqa: E402
from repro.core import solvers as jsv  # noqa: E402
from repro_torch.core import precond as tpc  # noqa: E402
from repro_torch.core import quadratic as tq  # noqa: E402
from repro_torch.core import solvers as tsv  # noqa: E402

torch.set_num_threads(1)

B, N, D, C = 4, 256, 16, 3


def _close(got, want, rtol, atol_scale=None):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    atol = 0.0 if atol_scale is None else atol_scale * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "A": f(N, D) / np.float32(np.sqrt(N)), "Ab": f(B, N, D) / np.float32(np.sqrt(N)),
        "b": f(D), "bm": f(D, C), "bb": f(B, D), "v": f(D), "vm": f(D, C), "vb": f(B, D),
        "y": f(N), "Y": f(B, N),
        "w": rng.uniform(0.5, 2.0, N).astype(np.float32),
        "wb": rng.uniform(0.5, 2.0, (B, N)).astype(np.float32),
        "lam": rng.uniform(1.0, 2.0, D).astype(np.float32),
        "lamb": rng.uniform(1.0, 2.0, (B, D)).astype(np.float32),
        "nus": np.asarray([0.5, 0.3, 0.2, 0.1], np.float32),
    }


def _pair(**kw):
    """The same problem in both packages, from numpy arrays."""
    qj = jq.Quadratic(**{k: (v if k == "batched" or v is None else jnp.asarray(v))
                         for k, v in kw.items()})
    qt = tq.Quadratic(**{k: (v if k == "batched" or v is None else torch.as_tensor(v))
                         for k, v in kw.items()})
    return qj, qt


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_single_problem_hvp_value_error(data, rhs, weighted):
    b, v = (data["b"], data["v"]) if rhs == "vector" else (data["bm"], data["vm"])
    qj, qt = _pair(A=data["A"], b=b, nu=np.float32(0.3), lam_diag=data["lam"],
                   row_weights=data["w"] if weighted else None)
    vj, vt = jnp.asarray(v), torch.as_tensor(v)
    _close(qt.hvp(vt), qj.hvp(vj), 1e-5, 1e-6)
    _close(qt.grad(vt), qj.grad(vj), 1e-5, 1e-6)
    _close(qt.value(vt), qj.value(vj), 1e-5)
    _close(qt.error(vt, 2 * vt), qj.error(vj, 2 * vj), 1e-5)
    with pytest.raises(ValueError, match="not a batched"):
        qt.batch


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_batched_hvp_value_error(data, shared, weighted):
    qj, qt = _pair(A=data["A"] if shared else data["Ab"], b=data["bb"], nu=data["nus"],
                   lam_diag=data["lamb"], batched=True,
                   row_weights=data["wb"] if weighted else None)
    assert qt.shared_A == shared and qt.batch == B
    vj, vt = jnp.asarray(data["vb"]), torch.as_tensor(data["vb"])
    _close(qt.hvp(vt), qj.hvp(vj), 1e-5, 1e-6)
    _close(qt.value(vt), qj.value(vj), 1e-5)
    _close(qt.error(vt, -vt), qj.error(vj, -vj), 1e-5)
    # problem i alone, and the weighted twin of the unweighted problem
    p_j, p_t = qj.problem(2), qt.problem(2)
    assert not p_t.batched
    _close(p_t.hvp(vt[2]), p_j.hvp(vj[2]), 1e-5, 1e-6)
    if not weighted:
        w_j = qj.with_row_weights(jnp.asarray(data["wb"]))
        w_t = qt.with_row_weights(torch.as_tensor(data["wb"]))
        _close(w_t.hvp(vt), w_j.hvp(vj), 1e-5, 1e-6)
        with pytest.raises(ValueError, match="row_weights shape"):
            qt.with_row_weights(torch.ones(N))


def test_unbatched_shared_shape_is_not_shared(data):
    """``shared_A`` means a batch over one A: a single (n, d) problem is not
    shared, as in the reference."""
    qj, qt = _pair(A=data["A"], b=data["b"], nu=np.float32(0.3), lam_diag=data["lam"])
    assert qt.shared_A is False and qj.shared_A is False


def test_from_least_squares_and_lambda_sweep(data):
    A, y = data["A"], data["y"]
    qj = jq.from_least_squares(jnp.asarray(A), jnp.asarray(y), 0.2)
    qt = tq.from_least_squares(torch.as_tensor(A), torch.as_tensor(y), 0.2)
    _close(qt.b, qj.b, 1e-5, 1e-6)
    _close(tq.direct_solve(qt), jq.direct_solve(qj), 1e-5, 1e-6)
    sj = jq.lambda_sweep(jnp.asarray(A), jnp.asarray(y), jnp.asarray(data["nus"]),
                         jnp.asarray(data["lam"]))
    st = tq.lambda_sweep(torch.as_tensor(A), torch.as_tensor(y),
                         torch.as_tensor(data["nus"]), torch.as_tensor(data["lam"]))
    assert st.batched and st.shared_A and st.batch == B
    for k in ("b", "nu", "lam_diag"):
        _close(getattr(st, k), getattr(sj, k), 1e-5, 1e-6)
    _close(st.hvp(torch.as_tensor(data["vb"])), sj.hvp(jnp.asarray(data["vb"])), 1e-5, 1e-6)
    _close(tq.direct_solve(st), jq.direct_solve(sj), 1e-5, 1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_stack_quadratics(data, weighted):
    singles = [dict(A=data["Ab"][i], b=data["bb"][i], nu=data["nus"][i],
                    lam_diag=data["lamb"][i], row_weights=data["wb"][i] if weighted else None)
               for i in range(3)]
    pairs = [_pair(**s) for s in singles]
    sj = jq.stack_quadratics([p[0] for p in pairs])
    st = tq.stack_quadratics([p[1] for p in pairs])
    assert st.batched and not st.shared_A and st.batch == 3
    assert (st.row_weights is None) == (not weighted)
    v = data["vb"][:3]
    _close(st.hvp(torch.as_tensor(v)), sj.hvp(jnp.asarray(v)), 1e-5, 1e-6)
    with pytest.raises(ValueError, match="takes single problems"):
        tq.stack_quadratics([st])


def test_stack_quadratics_refuses_mixed_weights(data):
    mixed = [dict(A=data["Ab"][i], b=data["bb"][i], nu=data["nus"][i],
                  lam_diag=data["lamb"][i], row_weights=data["wb"][i] if i else None)
             for i in range(2)]
    pairs = [_pair(**s) for s in mixed]
    with pytest.raises(ValueError, match="cannot stack 1 weighted"):
        jq.stack_quadratics([p[0] for p in pairs])
    with pytest.raises(ValueError, match="cannot stack 1 weighted"):
        tq.stack_quadratics([p[1] for p in pairs])


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("chunk", [100, 1024])
def test_weighted_gram(data, shared, chunk):
    """Chunks that do not divide n included; the reference pads, the port
    takes a short last chunk."""
    A = data["A"] if shared else data["Ab"]
    want = jq.weighted_gram(jnp.asarray(A), jnp.asarray(data["wb"]), chunk=chunk)
    got = tq.weighted_gram(torch.as_tensor(A), torch.as_tensor(data["wb"]), chunk=chunk)
    _close(got, want, 1e-5, 1e-6)


@pytest.mark.parametrize("layout", ["per_problem", "shared", "shared_weighted",
                                    "per_problem_weighted"])
def test_direct_solve_batched(data, layout):
    shared, weighted = layout.startswith("shared"), layout.endswith("weighted")
    qj, qt = _pair(A=data["A"] if shared else data["Ab"], b=data["bb"], nu=data["nus"],
                   lam_diag=data["lamb"], batched=True,
                   row_weights=data["wb"] if weighted else None)
    _close(tq.direct_solve(qt), jq.direct_solve(qj), 1e-5, 1e-6)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_direct_solve_single(data, rhs, weighted):
    qj, qt = _pair(A=data["A"], b=data["b"] if rhs == "vector" else data["bm"],
                   nu=np.float32(0.3), lam_diag=data["lam"],
                   row_weights=data["w"] if weighted else None)
    _close(tq.direct_solve(qt), jq.direct_solve(qj), 1e-5, 1e-6)


@pytest.mark.parametrize("m", [64, 8])          # primal (m ≥ d) and dual (m < d)
def test_factorize_single_solves(data, m):
    rng = np.random.default_rng(m)
    SA = (rng.standard_normal((m, D)) @ data["A"].T @ data["A"]).astype(np.float32)
    Pj = jpc.factorize(jnp.asarray(SA), 0.3, jnp.asarray(data["lam"]))
    Pt = tpc.factorize(torch.as_tensor(SA), 0.3, torch.as_tensor(data["lam"]))
    assert Pt.mode == Pj.mode == ("primal" if m >= D else "dual") and not Pt.batched
    for z in (data["v"], data["vm"]):
        _close(Pt.solve(torch.as_tensor(z)), Pj.solve(jnp.asarray(z)), 1e-4, 1e-6)


@pytest.mark.parametrize("m", [64, 8])
def test_factorize_batched_solves(data, m):
    rng = np.random.default_rng(m + 1)
    SA = rng.standard_normal((B, m, D)).astype(np.float32)
    Pj = jpc.factorize(jnp.asarray(SA), jnp.asarray(data["nus"]), jnp.asarray(data["lamb"]))
    Pt = tpc.factorize(torch.as_tensor(SA), torch.as_tensor(data["nus"]),
                       torch.as_tensor(data["lamb"]))
    assert Pt.batched and Pt.mode == Pj.mode
    _close(Pt.solve(torch.as_tensor(data["vb"])), Pj.solve(jnp.asarray(data["vb"])),
           1e-4, 1e-6)


@pytest.mark.parametrize("lam_shared", [True, False])
@pytest.mark.parametrize("m", [64, 8])
def test_factorize_shared_solves(data, m, lam_shared):
    rng = np.random.default_rng(m + 2)
    SA = rng.standard_normal((m, D)).astype(np.float32)
    lam = data["lam"] if lam_shared else data["lamb"]
    Pj = jpc.factorize_shared(jnp.asarray(SA), jnp.asarray(data["nus"]), jnp.asarray(lam))
    Pt = tpc.factorize_shared(torch.as_tensor(SA), torch.as_tensor(data["nus"]),
                              torch.as_tensor(lam))
    assert Pt.batched and Pt.mode == Pj.mode
    _close(Pt.solve(torch.as_tensor(data["vb"])), Pj.solve(jnp.asarray(data["vb"])),
           1e-4, 1e-6)


def test_non_spd_factor_is_nan_in_both(data):
    """Λ < 0 makes W_S = SAΛ⁻¹SAᵀ + ν²I negative definite: the reference's
    Cholesky gives NaN, and so does the port's (``cholesky_ex`` failures
    are NaN'd rather than raised)."""
    rng = np.random.default_rng(9)
    SA = rng.standard_normal((8, D)).astype(np.float32)
    lam = -np.ones(D, np.float32)
    for m_SA in (SA, np.concatenate([SA] * 4)):        # dual, then primal (m ≥ d)
        Pj = jpc.factorize(jnp.asarray(m_SA), 0.1, jnp.asarray(lam))
        Pt = tpc.factorize(torch.as_tensor(m_SA), 0.1, torch.as_tensor(lam))
        assert not np.isfinite(np.asarray(Pj.solve(jnp.asarray(data["v"])))).any()
        assert not torch.isfinite(Pt.solve(torch.as_tensor(data["v"]))).any()


def test_factorization_cost_flops():
    for m, n, d in ((64, 1000, 16), (8, 1000, 16)):
        assert tpc.factorization_cost_flops(m, n, d) == jpc.factorization_cost_flops(m, n, d)


@pytest.fixture(scope="module")
def fixed_sketch(data):
    """A batch with a handed-over sketch SA = S·A (m = 8d) in both packages."""
    rng = np.random.default_rng(5)
    S = (rng.standard_normal((B, 8 * D, N)) / np.sqrt(8 * D)).astype(np.float32)
    SA = np.einsum("bmn,bnd->bmd", S, data["Ab"]).astype(np.float32)
    qj, qt = _pair(A=data["Ab"], b=data["bb"], nu=data["nus"], lam_diag=data["lamb"],
                   batched=True)
    Pj = jpc.factorize(jnp.asarray(SA), qj.nu, qj.lam_diag)
    Pt = tpc.factorize(torch.as_tensor(SA), qt.nu, qt.lam_diag)
    return qj, qt, Pj, Pt


@pytest.mark.parametrize("method", ["ihs", "pcg", "polyak"])
def test_run_fixed_traces_match(fixed_sketch, method):
    """δ̃ traces (iters, B) to rtol 1e-4, atol 1e-6·trace[0]."""
    qj, qt, Pj, Pt = fixed_sketch
    xj, tj = jsv.run_fixed(qj, Pj, jnp.zeros((B, D)), method=method, iters=12, rho=0.25)
    xt, tt = tsv.run_fixed(qt, Pt, torch.zeros((B, D)), method=method, iters=12, rho=0.25)
    assert tt.shape == (12, B)
    tj = np.asarray(tj)
    np.testing.assert_allclose(tt.numpy(), tj, rtol=1e-4, atol=1e-6 * np.abs(tj[0]).max())
    _close(xt, xj, 1e-4, 1e-5)


@pytest.mark.parametrize("method", ["ihs", "pcg", "polyak"])
def test_run_fixed_single_problem(fixed_sketch, method):
    """An unbatched problem: scalar δ̃, trace (iters,)."""
    qj, qt, Pj, Pt = fixed_sketch
    pj, pt = qj.problem(1), qt.problem(1)
    rng = np.random.default_rng(6)
    S = (rng.standard_normal((8 * D, N)) / np.sqrt(8 * D)).astype(np.float32)
    SA = (S @ np.asarray(pj.A)).astype(np.float32)
    Psj = jpc.factorize(jnp.asarray(SA), pj.nu, pj.lam_diag)
    Pst = tpc.factorize(torch.as_tensor(SA), pt.nu, pt.lam_diag)
    xj, tj = jsv.run_fixed(pj, Psj, jnp.zeros(D), method=method, iters=8, rho=0.25)
    xt, tt = tsv.run_fixed(pt, Pst, torch.zeros(D), method=method, iters=8, rho=0.25)
    assert tt.shape == (8,)
    tj = np.asarray(tj)
    np.testing.assert_allclose(tt.numpy(), tj, rtol=1e-4, atol=1e-6 * abs(tj[0]))


@pytest.mark.parametrize("batched", [True, False])
def test_cg_solve_traces_match(fixed_sketch, batched):
    qj, qt, _, _ = fixed_sketch
    if not batched:
        qj, qt = qj.problem(0), qt.problem(0)
    shape = (B, D) if batched else (D,)
    xj, tj = jsv.cg_solve(qj, jnp.zeros(shape), 8)
    xt, tt = tsv.cg_solve(qt, torch.zeros(shape), 8)
    assert tuple(tt.shape) == tj.shape
    tj = np.asarray(tj)
    np.testing.assert_allclose(tt.numpy(), tj, rtol=1e-4, atol=1e-6 * np.abs(tj[0]).max())
    _close(xt, xj, 1e-4, 1e-5)
