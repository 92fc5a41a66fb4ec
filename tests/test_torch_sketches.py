"""The port's paper-literal sketches (``core.sketches``) and effective
dimension (``core.effective_dim``) against the JAX reference on the CPU.

Each family's ``apply``, ``apply_t`` and ``dense`` run on the reference's
own samples, handed over with ``Sketch.from_numpy`` (SJLT with s = 1 and
s = 3); the port's hash-generated Gaussian is checked the other way, its
dense S handed to the reference's ``Sketch``. Tolerances: the SJLT is
exact (±1/√s products, the same sums in the same order); the Gaussian and
the SRHT are fp32 sums of n terms in another order than XLA's, within
1e-5 of the result's scale. The port's own samplers are checked for
E[SᵀS] ≈ I over 400 seeds."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import effective_dim as jed  # noqa: E402
from repro.core import sketches as js  # noqa: E402
from repro_torch.core import effective_dim as ted  # noqa: E402
from repro_torch.core import sketches as ts  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.gaussian_gram import MAX_M, fold_seeds, gaussian_s_dense  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


def _handover(jsk) -> ts.Sketch:
    return ts.Sketch.from_numpy(jsk.kind, jsk.m, jsk.n,
                                {k: np.asarray(v) for k, v in jsk.data.items()},
                                device="cpu")


@pytest.mark.parametrize("shape,axis", [((8,), -1), ((64, 5), 0), ((3, 32), -1),
                                        ((4, 16, 3), 1), ((1,), 0)])
def test_fwht_matches_reference(shape, axis):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    _close(ts.fwht(torch.as_tensor(x), axis=axis), js.fwht(jnp.asarray(x), axis=axis))


def test_fwht_refuses_non_pow2():
    with pytest.raises(ValueError, match="power of 2"):
        ts.fwht(torch.zeros(6))


CASES = [("gaussian", 300, 40, 1), ("srht", 300, 40, 1), ("srht", 256, 64, 1),
         ("sjlt", 300, 40, 1), ("sjlt", 300, 40, 3), ("sjlt", 64, 100, 1)]


@pytest.mark.parametrize("kind,n,m,s", CASES)
def test_apply_apply_t_dense_on_handed_over_samples(kind, n, m, s):
    rng = np.random.default_rng(n + m + s)
    A = rng.standard_normal((n, 7)).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    Y = rng.standard_normal((m, 3)).astype(np.float32)
    jsk = js.make_sketch(kind, m, n, jax.random.PRNGKey(m + s), s=s)
    tsk = _handover(jsk)
    exact = kind == "sjlt"
    rtol = 0.0 if exact else RTOL
    _close(tsk.apply(torch.as_tensor(A)), jsk.apply(jnp.asarray(A)), rtol)
    _close(tsk.apply(torch.as_tensor(v)), jsk.apply(jnp.asarray(v)), rtol)
    _close(tsk.apply_t(torch.as_tensor(Y)), jsk.apply_t(jnp.asarray(Y)), rtol)
    _close(tsk.apply_t(torch.as_tensor(Y[:, 0])), jsk.apply_t(jnp.asarray(Y[:, 0])), rtol)
    _close(tsk.dense(), jsk.dense(), rtol)


@pytest.mark.parametrize("n,m", [(300, 40), (64, 100)])
def test_hash_gaussian_matches_reference_on_its_dense_sketch(n, m):
    """The port's Gaussian applies S through ``ops.gaussian_sa`` (B = 1,
    shared A); the reference's formulas on the same S agree."""
    tsk = ts.make_sketch("gaussian", m, n, 11, device="cpu")
    S = tsk.dense()
    jsk = js.Sketch(kind="gaussian", m=m, n=n, data={"S": jnp.asarray(S.numpy())})
    rng = np.random.default_rng(1)
    A = rng.standard_normal((n, 5)).astype(np.float32)
    Y = rng.standard_normal((m, 2)).astype(np.float32)
    _close(tsk.apply(torch.as_tensor(A)), jsk.apply(jnp.asarray(A)))
    _close(tsk.apply_t(torch.as_tensor(Y)), jsk.apply_t(jnp.asarray(Y)))
    _close(S * math.sqrt(m), gaussian_s_dense(torch.tensor([11]), m, n)[0], 1e-6)


def test_gaussian_taller_than_the_counter_packing_goes_in_row_blocks():
    """m > MAX_M: block 0 from the seed, block j from fold_seeds(seed, j),
    every row scaled by 1/√m of the whole sketch."""
    n, m = 16, MAX_M + 5
    seed = torch.tensor(7)
    tsk = ts.make_sketch("gaussian", m, n, seed, device="cpu")
    S = tsk.dense()
    want = torch.cat([gaussian_s_dense(seed.reshape(1), MAX_M, n)[0],
                      gaussian_s_dense(fold_seeds(seed, 1).reshape(1), 5, n)[0]])
    _close(S, want / math.sqrt(m), 1e-6)
    Y = torch.randn(m, 2, generator=torch.Generator().manual_seed(0))
    _close(tsk.apply_t(Y), S.T @ Y, 1e-6)


@pytest.mark.parametrize("kind,s", [("gaussian", 1), ("srht", 1), ("sjlt", 1), ("sjlt", 3)])
def test_port_samplers_are_isometries_in_expectation(kind, s):
    """E[SᵀS] = I: the mean of SᵀS over 400 seeds is within 0.12 of I
    entrywise (the Monte Carlo spread is about 0.02 here)."""
    n, m = 12, 8
    acc = torch.zeros(n, n)
    for seed in range(400):
        S = ts.make_sketch(kind, m, n, seed, s=s, device="cpu").dense()
        acc += S.T @ S
    assert float((acc / 400 - torch.eye(n)).abs().max()) < 0.12


def test_port_samplers_draw_valid_samples():
    n, m = 300, 40
    sr = ts.make_sketch("srht", m, n, 3, device="cpu").data
    assert sr["rows"].unique().numel() == m and int(sr["rows"].max()) < 512
    assert set(sr["signs"].unique().tolist()) <= {-1.0, 1.0}
    sj = ts.make_sketch("sjlt", m, n, 3, s=3, device="cpu").data
    assert sj["rows"].shape == (3, n) and int(sj["rows"].max()) < m
    assert all(len(set(col)) == 3 for col in sj["rows"].T.tolist())
    assert torch.allclose(sj["signs"].abs(), torch.full((3, n), 1 / math.sqrt(3)))
    one = ts.make_sketch("sjlt", m, n, 3, device="cpu").data["rows"]
    assert one.shape == (1, n) and 0 <= int(one.min()) and int(one.max()) < m
    # the same seed draws the same sketch
    again = ts.make_sketch("sjlt", m, n, 3, s=3, device="cpu").data
    assert torch.equal(again["rows"], sj["rows"])


def test_paper_literal_apply_launch_legs_are_the_single_problem_ones():
    """On the CPU no kernel launches: the wrappers take the plain versions
    and count nothing (the card's counts are chip_smoke.py phase 8's)."""
    ops.reset_launches()
    A = torch.randn(64, 4)
    for kind in ts.KINDS:
        sk = ts.make_sketch(kind, 8, 64, 1, device="cpu")
        sk.apply_t(sk.apply(A))
    assert not any(ops.LAUNCHES.values()) and not any(ops.BODY_LAUNCHES.values())


@pytest.mark.parametrize("kind", ["gaussian", "srht", "sjlt"])
@pytest.mark.parametrize("m,n,d,s", [(64, 1000, 32, 1), (100, 1024, 7, 4)])
def test_sketch_cost_flops_matches_reference(kind, m, n, d, s):
    assert ts.sketch_cost_flops(kind, m, n, d, s) == js.sketch_cost_flops(kind, m, n, d, s)


def test_make_sketch_refusals():
    with pytest.raises(ValueError, match="unknown sketch kind"):
        ts.make_sketch("fourier", 4, 8, 0, device="cpu")
    with pytest.raises(ValueError, match="fp32"):
        ts.make_sketch("sjlt", 4, 8, 0, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("nu", [1e-1, 1e-2, 1e-3])
def test_effective_dimension_matches_reference(nu):
    sv = ted.exp_decay_singular_values(64, 0.95, device="cpu")
    # rate^j by two libraries' fp32 pow: within an ulp or two
    np.testing.assert_allclose(sv.numpy(), np.asarray(jed.exp_decay_singular_values(64, 0.95)),
                               rtol=3e-7)
    np.testing.assert_allclose(float(ted.effective_dimension(sv, nu)),
                               float(jed.effective_dimension(jnp.asarray(sv.numpy()), nu)),
                               rtol=1e-6)


def test_effective_dimension_exact_and_weighted_match_reference():
    rng = np.random.default_rng(5)
    A = (rng.standard_normal((200, 12)) * 0.8 ** np.arange(12)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 200).astype(np.float32)
    lam = rng.uniform(1.0, 2.0, 12).astype(np.float32)
    for nu in (0.3, 0.03):
        np.testing.assert_allclose(
            ted.effective_dimension_exact(torch.as_tensor(A), nu),
            jed.effective_dimension_exact(jnp.asarray(A), nu), rtol=1e-4)
        np.testing.assert_allclose(
            ted.effective_dimension_exact(torch.as_tensor(A), nu, torch.as_tensor(lam)),
            jed.effective_dimension_exact(jnp.asarray(A), nu, jnp.asarray(lam)), rtol=1e-4)
        np.testing.assert_allclose(
            ted.effective_dimension_weighted_exact(torch.as_tensor(A), torch.as_tensor(w), nu),
            jed.effective_dimension_weighted_exact(jnp.asarray(A), jnp.asarray(w), nu),
            rtol=1e-4)


@pytest.mark.parametrize("d_e", [0.5, 3.0, 40.0])
def test_critical_sketch_sizes_match_reference(d_e):
    assert ted.m_delta_srht(d_e, 4096) == jed.m_delta_srht(d_e, 4096)
    assert ted.m_delta_gaussian(d_e) == jed.m_delta_gaussian(d_e)
    assert ted.m_delta_sjlt(d_e, 0.2) == jed.m_delta_sjlt(d_e, 0.2)
    for kind in ("srht", "gaussian", "sjlt"):
        assert ted.M_DELTA[kind](d_e, 1000, 0.1) == jed.M_DELTA[kind](d_e, 1000, 0.1)
