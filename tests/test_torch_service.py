"""One request set through both ridge services on the CPU: the JAX
reference's ``SolverService`` and the port's, with the port's per-slot
seeds swapped for the reference's so both draw the same Gaussian sketches."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.level_grams import _uint32_seeds  # noqa: E402
from repro.serve import solver_service as jsvc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.serve import solver_service as tsvc  # noqa: E402

torch.set_num_threads(1)

SEED = 7
CLASSES = [(256, 32, 64, None), (1024, 64, 128, None), (2048, 16, 32, "srht")]
# (n, d, ν, spectrum decay) per request; the last two land in the SRHT class
REQUESTS = [(200, 20, 0.1, 0.8), (256, 32, 0.05, 0.9), (180, 24, 0.1, 0.9),
            (250, 30, 0.02, 0.85), (64, 12, 0.3, 0.6),
            (900, 50, 0.05, 0.9), (1024, 64, 0.1, 0.95), (600, 40, 0.02, 0.8),
            (2000, 16, 0.05, 0.8), (1500, 12, 0.1, 0.7)]


def _request(rng, n, d, decay):
    U, _ = np.linalg.qr(rng.standard_normal((n, d)))
    V, _ = np.linalg.qr(rng.standard_normal((d, d)))
    A = (U * decay ** np.arange(1, d + 1)[None, :]) @ V.T
    return A.astype(np.float32), rng.standard_normal(n).astype(np.float32)


def _reference_slot_seeds(slot_ids):
    """The reference's per-slot Gaussian seeds: bits(fold_in(PRNGKey(seed), id))."""
    base = jax.random.PRNGKey(SEED)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
        jnp.asarray(slot_ids, jnp.uint32))
    return torch.as_tensor(np.asarray(_uint32_seeds(keys)).astype(np.int64))


@pytest.fixture(scope="module")
def solved():
    rng = np.random.default_rng(0)
    data = [(*_request(rng, n, d, decay), nu) for n, d, nu, decay in REQUESTS]
    ref = jsvc.SolverService([jsvc.ShapeClass(*c) for c in CLASSES], batch_size=4,
                             seed=SEED, strict=False)
    port = tsvc.SolverService([tsvc.ShapeClass(*c) for c in CLASSES], batch_size=4,
                              seed=SEED, strict=False, device="cpu")
    port._slot_seeds = _reference_slot_seeds
    ids = []
    for A, y, nu in data:
        rid_j = ref.submit(jnp.asarray(A), jnp.asarray(y), nu)
        rid_t = port.submit(torch.as_tensor(A), torch.as_tensor(y), nu)
        assert rid_j == rid_t
        ids.append(rid_t)
    bad = np.full((32, 4), np.nan, np.float32)
    bad_ids = (ref.submit(jnp.asarray(bad), jnp.zeros(32), 0.1),
               port.submit(torch.as_tensor(bad), torch.zeros(32), 0.1))
    return {"data": data, "ids": ids, "bad": bad_ids,
            "ref": ref.flush(), "port": port.flush()}


def test_gaussian_class_certificates_match(solved):
    """Field by field on the Gaussian classes: status, m_final, doublings
    equal and no retries on either side, iters within ±2, x to rtol 1e-4."""
    n_gauss = 0
    for rid, (A, _, _) in zip(solved["ids"], solved["data"]):
        sj, st = solved["ref"][rid], solved["port"][rid]
        assert st.shape_class.sketch == sj.shape_class.sketch
        if sj.sketch != "gaussian":
            continue
        n_gauss += 1
        assert (st.status, st.m_final, st.doublings) == (sj.status, sj.m_final,
                                                         sj.doublings), rid
        assert st.retries == 0 and sj.retries == 0
        assert abs(st.iters - sj.iters) <= 2
        xj, xt = np.asarray(sj.x), bridge.to_numpy(st)["x"]
        np.testing.assert_allclose(xt, xj, rtol=1e-4, atol=1e-4 * np.abs(xj).max())
    assert n_gauss == 8


def test_knife_edge_slot_matches_on_reference_packing():
    """Slot 2's level-0 (m = 1) PCG run sits on a knife edge: packed by the
    port, whose b = Aᵀy differs from XLA's by a few ulp (another summation
    order), it ends at m_final 4 where the reference ends at 1. Handed the
    reference's packed batch, the port's engine gives its certificates."""
    from repro.core.adaptive_padded import padded_adaptive_solve_batched as j_solve
    from repro_torch.core.adaptive_padded import padded_adaptive_solve_batched as t_solve

    rng = np.random.default_rng(0)
    data = [_request(rng, n, d, decay) + (nu,) for n, d, nu, decay in
            [(200, 20, 0.1, 0.8), (256, 32, 0.05, 0.9), (120, 9, 0.2, 0.7),
             (250, 30, 0.02, 0.85)]]
    ref = jsvc.SolverService([jsvc.ShapeClass(*CLASSES[0])], batch_size=4, seed=SEED)
    reqs = [jsvc.RidgeRequest(i, jnp.asarray(A), jnp.asarray(y), nu)
            for i, (A, y, nu) in enumerate(data)]
    qj, keys = ref._pack(ref.shape_classes[0], reqs)
    xj, sj = j_solve(qj, keys, m_max=64, method="pcg", max_iters=200, tol=1e-10)
    qt = bridge.quadratic_from_numpy(qj.A, qj.b, qj.nu, qj.lam_diag, device="cpu")
    xt, st = t_solve(qt, _reference_slot_seeds([0, 1, 2, 3]), m_max=64, method="pcg",
                     max_iters=200, tol=1e-10, device="cpu")
    assert int(np.asarray(sj["m_final"])[2]) == 1
    for k in ("status", "m_final", "doublings"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]), err_msg=k)
    assert np.all(np.abs(st["iters"].numpy() - np.asarray(sj["iters"])) <= 2)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(xj)).max())


def test_srht_class_solves(solved):
    """The SRHT class (the port draws its own signs and rows) converges, and
    its x agrees with an fp64 direct solve to 1e-3."""
    n_srht = 0
    for rid, (A, y, nu) in zip(solved["ids"], solved["data"]):
        st = solved["port"][rid]
        if st.sketch != "srht":
            continue
        n_srht += 1
        assert st.status == "OK" and st.converged
        A64 = A.astype(np.float64)
        x = np.linalg.solve(A64.T @ A64 + nu ** 2 * np.eye(A.shape[1]),
                            A64.T @ y.astype(np.float64))
        assert np.linalg.norm(st.x.numpy() - x) <= 1e-3 * np.linalg.norm(x)
    assert n_srht == 2


def test_nan_request_rejected_by_both(solved):
    rid_j, rid_t = solved["bad"]
    assert solved["ref"][rid_j].status == solved["port"][rid_t].status == "REJECTED"
    assert bool(torch.all(solved["port"][rid_t].x == 0))


def test_service_stats_and_validation():
    svc = tsvc.SolverService(batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="nu must be"):
        svc.submit(torch.ones(8, 2), torch.ones(8), 0.0)
    with pytest.raises(ValueError, match="no shape class"):
        svc.bucket_for(10**6, 2)
    sol = svc.solve_one(torch.eye(8, 2), torch.ones(8), 0.5)
    assert sol.status == "OK" and svc.stats["batches"] == 1
    assert svc.stats["padded_slots"] == 3 and svc.slot_utilization() == 0.25
    # a request whose deadline is spent before dispatch expires unsolved
    rid = svc.submit(torch.ones(8, 2), torch.ones(8), 0.1, deadline_s=-1.0)
    late = svc.flush()[rid]
    assert late.status == "DEADLINE_EXCEEDED" and late.iters == 0
    assert svc.stats["deadline_exceeded"] == 1 and svc.stats["batches"] == 1
