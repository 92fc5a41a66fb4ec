"""The engine's public split, the segmented deadline driver and
deadline-bound serving, on the CPU: within the port, a segmented solve is
bitwise the monolithic one; against the JAX reference on the same inputs
(the reference's seeds and, where noted, its level Grams handed over), the
split, the mid-solve reprecondition, the single-problem entry and the
paused deadline certificates agree; the service dispatches in the
reference's EDF order and a deadline binds mid-solve under a clock the test
controls."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive_padded as jap  # noqa: E402
from repro.core import robust as jrb  # noqa: E402
from repro.core.level_grams import _uint32_seeds  # noqa: E402
from repro.core.quadratic import Quadratic as JQuadratic  # noqa: E402
from repro.core.quadratic import from_least_squares_batch as j_flsb  # noqa: E402
from repro.serve import solver_service as jsvc  # noqa: E402
from repro_torch.core import adaptive_padded as tap  # noqa: E402
from repro_torch.core import robust as trb  # noqa: E402
from repro_torch.core.quadratic import Quadratic  # noqa: E402
from repro_torch.core.quadratic import from_least_squares_batch as t_flsb  # noqa: E402
from repro_torch.core.status import SolveStatus  # noqa: E402
from repro_torch.serve import solver_service as tsvc  # noqa: E402

torch.set_num_threads(1)

B, N, D, M_MAX = 4, 512, 32, 64
RATES = (0.6, 0.8, 0.9, 0.95)
NUS = (0.3, 0.1, 0.05, 0.02)
DEADLINE = int(SolveStatus.DEADLINE_EXCEEDED)
CERT_KEYS = ("status", "m_final", "iters", "dtilde", "level", "doublings", "trips")


def _exp_decay_batch(rng, B, n, d, rates):
    """A_b = U_b·diag(rate_b^j)·V_bᵀ, y_b ~ N(0, I)."""
    As, Ys = [], []
    for rate in rates:
        U, _ = np.linalg.qr(rng.standard_normal((n, d)))
        V, _ = np.linalg.qr(rng.standard_normal((d, d)))
        As.append((U * rate ** np.arange(1, d + 1)[None, :]) @ V.T)
        Ys.append(rng.standard_normal(n))
    return np.stack(As).astype(np.float32), np.stack(Ys).astype(np.float32)


@pytest.fixture(scope="module")
def batch():
    A, Y = _exp_decay_batch(np.random.default_rng(0), B, N, D, RATES)
    nus = np.asarray(NUS, np.float32)
    qj = j_flsb(jnp.asarray(A), jnp.asarray(Y), jnp.asarray(nus))
    qt = t_flsb(torch.as_tensor(A), torch.as_tensor(Y), torch.as_tensor(nus))
    keys = jax.random.split(jax.random.PRNGKey(42), B)
    grams = jap._compute_ladder_grams(qj, keys, m_max=M_MAX, sketch="gaussian", mesh=None,
                                      compute_dtype="fp32")
    return {"qj": qj, "qt": qt, "keys": keys, "A": A, "Y": Y, "nus": nus,
            "seeds": torch.as_tensor(np.asarray(_uint32_seeds(keys)).astype(np.int64)),
            "grams_j": grams, "grams_t": torch.as_tensor(np.asarray(grams).copy())}


def _assert_certificates_agree(xj, sj, xt, st, keys=("status", "m_final", "level")):
    """The parity rule of ``test_torch_engine.py``: status, m_final and
    level equal; iters within ±2; x to rtol 1e-4."""
    for k in keys:
        np.testing.assert_array_equal(np.asarray(st[k]), np.asarray(sj[k]), err_msg=k)
    assert np.all(np.abs(np.asarray(st["iters"]) - np.asarray(sj["iters"])) <= 2)
    xj = np.asarray(xj)
    np.testing.assert_allclose(np.asarray(xt), xj, rtol=1e-4, atol=1e-4 * np.abs(xj).max())


def _assert_bitwise(x, s, x_ref, s_ref):
    assert torch.equal(x, x_ref)
    for k in CERT_KEYS:
        assert torch.equal(torch.as_tensor(s[k]), torch.as_tensor(s_ref[k])), k


@pytest.fixture(scope="module")
def monolithic(batch):
    """The port's monolithic solves, per (method, guards)."""
    return {(m, g): tap.padded_adaptive_solve_batched(
                batch["qt"], batch["seeds"], m_max=M_MAX, method=m, guards=g,
                tol=1e-10, device="cpu")
            for m in ("ihs", "pcg", "polyak") for g in (True, False)}


@pytest.mark.parametrize("segment_trips", [1, 7, 32])
@pytest.mark.parametrize("guards", [True, False])
@pytest.mark.parametrize("method", ["ihs", "pcg", "polyak"])
def test_segmented_bitwise_matches_monolithic(batch, monolithic, method, guards,
                                              segment_trips):
    """Segments of k trips back to back, every boundary included at k = 1,
    are bitwise the one monolithic loop."""
    x_ref, s_ref = monolithic[(method, guards)]
    x, s = trb.segmented_padded_solve_batched(
        batch["qt"], batch["seeds"], m_max=M_MAX, method=method, guards=guards,
        tol=1e-10, segment_trips=segment_trips, device="cpu")
    _assert_bitwise(x, s, x_ref, s_ref)
    assert s["segments"] == -(-int(s_ref["trips"]) // segment_trips)
    assert not s["resumed"] and not s["deadline_hit"]


@pytest.mark.parametrize("guards", [True, False])
def test_split_matches_reference(batch, guards):
    """The port's prepare → 7-trip segments → finalize against the
    reference's monolithic solve: the certificates agree."""
    xj, sj = jap.padded_adaptive_solve_batched(
        batch["qj"], batch["keys"], m_max=M_MAX, method="pcg", guards=guards, tol=1e-10)
    pre, st = tap.prepare_padded_solve(batch["qt"], batch["seeds"], m_max=M_MAX,
                                       guards=guards, device="cpu")
    cap = tap.padded_trip_cap(M_MAX, 100)
    while not bool(st.done.all()) and int(st.trips) < cap:
        st = tap.padded_solve_segment(batch["qt"], pre, st, min(cap, int(st.trips) + 7),
                                      method="pcg", guards=guards, device="cpu")
    xt, stt = tap.finalize_padded_solve(pre, st, m_max=M_MAX, device="cpu")
    assert np.all(np.asarray(sj["status"]) == int(SolveStatus.OK))
    _assert_certificates_agree(xj, sj, xt, stt)


def test_batched_entry_points_refuse_single_problems(batch):
    q1 = Quadratic(A=batch["qt"].A[0], b=batch["qt"].b[0], nu=batch["qt"].nu[0],
                   lam_diag=batch["qt"].lam_diag[0])
    with pytest.raises(ValueError, match="batched"):
        tap.prepare_padded_solve(q1, 0, m_max=M_MAX, device="cpu")
    with pytest.raises(ValueError, match="single problems"):
        tap.padded_adaptive_solve_batched(q1, 0, m_max=M_MAX, device="cpu")


def test_reprecondition_on_segment_matches_reference(batch):
    """After the first 5-trip segment both drivers swap in the same
    replacement ladder (the reference's Grams under other keys, handed
    over): the solves re-anchor and finish with agreeing certificates."""
    keys2 = jax.random.split(jax.random.PRNGKey(7), B)
    g2 = jap._compute_ladder_grams(batch["qj"], keys2, m_max=M_MAX, sketch="gaussian",
                                   mesh=None, compute_dtype="fp32")
    g2_t = torch.as_tensor(np.asarray(g2).copy())
    calls = []

    def hook(new):
        def on_segment(seg, st):
            calls.append(seg)
            return new if seg == 1 else None
        return on_segment

    xj, sj = jrb.segmented_padded_solve_batched(
        batch["qj"], batch["keys"], m_max=M_MAX, method="pcg", segment_trips=5,
        grams=batch["grams_j"], on_segment=hook(g2))
    xt, st = trb.segmented_padded_solve_batched(
        batch["qt"], batch["seeds"], m_max=M_MAX, method="pcg", segment_trips=5,
        grams=batch["grams_t"], on_segment=hook(g2_t), device="cpu")
    assert calls.count(1) == 2
    assert np.all(np.asarray(sj["status"]) == int(SolveStatus.OK))
    _assert_certificates_agree(xj, sj, xt, st)


def test_reprecondition_keeps_done_problems_and_freezes_invalid(batch):
    """Problems already done keep every state field bit for bit; an active
    problem whose new ladder has no valid level freezes at once; validity
    composes with the old ladder."""
    q = batch["qt"]
    pre, st = tap.prepare_padded_solve(q, batch["seeds"], m_max=M_MAX, device="cpu")
    st = tap.padded_solve_segment(q, pre, st, 12, method="pcg", device="cpu")
    done = st.done.clone()
    assert bool(done.any()) and not bool(done.all())
    active = int(torch.nonzero(~done)[0])
    g2 = batch["grams_t"].clone()
    g2[:, active] = torch.nan
    pre2, st2 = tap.reprecondition_padded(q, pre, st, g2, device="cpu")
    for name, old, new in zip(st._fields, st, st2):
        if old.dim():
            assert torch.equal(old[done], new[done]), name
    assert bool(st2.done[active]) and not bool(pre2.any_valid[active])
    assert bool(pre2.gram_poisoned[active])
    x, s = tap.finalize_padded_solve(pre2, st2, m_max=M_MAX, device="cpu")
    assert int(s["status"][active]) == int(SolveStatus.NAN_POISONED)
    assert bool(torch.isfinite(x).all())


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_padded_adaptive_solve_single_problem(batch, rhs):
    """One problem, a vector or (d, 3) matrix RHS; the reference splits its
    key per column, so its per-column seeds are handed over."""
    A, nu = batch["A"][2], np.float32(0.1)
    rng = np.random.default_rng(11)
    b = (A.T @ rng.standard_normal((N, 3) if rhs == "matrix" else N)).astype(np.float32)
    lam = np.ones(D, np.float32)
    key = jax.random.PRNGKey(3)
    qj = JQuadratic(A=jnp.asarray(A), b=jnp.asarray(b), nu=jnp.asarray(nu),
                    lam_diag=jnp.asarray(lam))
    qt = Quadratic(A=torch.as_tensor(A), b=torch.as_tensor(b), nu=torch.as_tensor(nu),
                   lam_diag=torch.as_tensor(lam))
    kw = dict(m_max=M_MAX, method="pcg", tol=1e-10)
    xj, sj = jap.padded_adaptive_solve(qj, key, **kw)
    keys = jax.random.split(key, 3) if rhs == "matrix" else key[None]
    seeds = torch.as_tensor(np.asarray(_uint32_seeds(keys)).astype(np.int64))
    xt, st = tap.padded_adaptive_solve(qt, seeds if rhs == "matrix" else seeds[0],
                                       device="cpu", **kw)
    assert tuple(xt.shape) == b.shape
    if rhs == "vector":
        assert st["status"].dim() == 0
    _assert_certificates_agree(xj, sj, xt, st)


def test_deadline_zero_runs_one_segment_like_reference(batch):
    """``deadline_s=0.0``: exactly one 8-trip segment, every unfinished slot
    DEADLINE_EXCEEDED at its best finite iterate with a real δ̃, as the
    reference pauses (both on the reference's level Grams).

    x is compared per slot in the 2-norm, within max(1e-4, 2^-24·κ_b),
    κ_b the condition number of the slot's paused-level H_S = G_l + ν²Λ:
    after 8 trips a slot may sit on a low level (m = 4 rows for d = 32),
    whose explicit inverse each package rounds in its own order, off by
    about 2^-24·κ_b (3e-4 here for the ν = 0.02 slot)."""
    kw = dict(m_max=M_MAX, method="pcg", segment_trips=8, deadline_s=0.0)
    xj, sj = jrb.segmented_padded_solve_batched(batch["qj"], batch["keys"],
                                                grams=batch["grams_j"], **kw)
    xt, st = trb.segmented_padded_solve_batched(batch["qt"], batch["seeds"],
                                                grams=batch["grams_t"], device="cpu", **kw)
    assert st["deadline_hit"] and st["segments"] == 1 and int(st["trips"]) == 8
    assert int(sj["trips"]) == 8
    np.testing.assert_array_equal(st["status"].numpy(), np.asarray(sj["status"]))
    np.testing.assert_array_equal(st["level"].numpy(), np.asarray(sj["level"]))
    assert (st["status"] == DEADLINE).any()
    assert bool(torch.isfinite(xt).all()) and bool(torch.isfinite(st["dtilde"]).all())
    G = np.asarray(batch["grams_j"], np.float64)[st["level"].numpy(), np.arange(B)]
    HS = G + np.eye(D) * (batch["nus"].astype(np.float64) ** 2)[:, None, None]
    tol = np.maximum(1e-4, 2.0 ** -24 * np.linalg.cond(HS))
    xj = np.asarray(xj)
    err = np.linalg.norm(xt.numpy() - xj, axis=1) / np.linalg.norm(xj, axis=1)
    assert np.all(err <= tol), (err, tol)


def test_deadline_slots_never_retried_or_fallen_back(batch):
    x, s = trb.robust_padded_solve_batched(
        batch["qt"], batch["seeds"], m_max=M_MAX, tol=0.0, segment_trips=8,
        deadline_s=0.0, max_retries=2, fallback=True, device="cpu")
    assert torch.all(s["status"] == DEADLINE)
    assert torch.all(s["retries"] == 0) and not bool(s["fell_back"].any())
    assert bool(torch.isfinite(s["dtilde"]).all()) and bool(torch.isfinite(x).all())
    assert s["deadline_hit"] and s["segments"] == 1 and s["trips"] == 8


def test_generous_deadline_is_bitwise_monolithic(batch):
    kw = dict(m_max=M_MAX, method="pcg", device="cpu")
    x_ref, s_ref = trb.robust_padded_solve_batched(batch["qt"], batch["seeds"], **kw)
    x, s = trb.robust_padded_solve_batched(batch["qt"], batch["seeds"], deadline_s=3600.0,
                                           segment_trips=7, **kw)
    _assert_bitwise(x, s, x_ref, s_ref)
    assert s_ref["segments"] == 0 and s["segments"] >= 1 and not s["deadline_hit"]


class _SegmentClock:
    """A clock the test controls: ``perf_counter`` reads ``now``, and every
    segment the driver runs advances it by one second."""

    def __init__(self, monkeypatch, *modules):
        self.now = 0.0
        fake = types.SimpleNamespace(perf_counter=lambda: self.now)
        for mod in modules:
            monkeypatch.setattr(mod, "time", fake)
        segment = trb.padded_solve_segment

        def ticking(*a, **k):
            self.now += 1.0
            return segment(*a, **k)

        monkeypatch.setattr(trb, "padded_solve_segment", ticking)


def test_retry_out_of_time_keeps_previous_verdict(batch, monkeypatch):
    """Slots that stall at max_iters = 6 are retried with what is left of
    the budget; the retry runs out of time, so the slots keep their STALLED
    verdict (not DEADLINE_EXCEEDED), and the fallback is skipped."""
    kw = dict(m_max=M_MAX, method="pcg", max_iters=6, segment_trips=4, device="cpu")
    _, first = trb.segmented_padded_solve_batched(batch["qt"], batch["seeds"], **kw)
    stalled = first["status"] == int(SolveStatus.STALLED)
    assert bool(stalled.any())
    clock = _SegmentClock(monkeypatch, trb)
    x, s = trb.robust_padded_solve_batched(batch["qt"], batch["seeds"],
                                           deadline_s=first["segments"] + 1.0, **kw)
    assert clock.now == first["segments"] + 1
    assert torch.all(s["status"][stalled] == int(SolveStatus.STALLED))
    assert torch.all(s["retries"][stalled] == 1) and not bool(s["fell_back"].any())
    assert s["segments"] == first["segments"] + 1 and not s["deadline_hit"]


def test_checkpoint_and_preempt_refused(batch):
    """What the drivers refuse: a segment of no trips, a checkpoint that is
    neither a manager nor a path, and any segment once the preemption flag
    is up (PreemptedError at segment 0, with nothing to save)."""
    with pytest.raises(ValueError, match="segment_trips"):
        trb.robust_padded_solve_batched(batch["qt"], batch["seeds"], m_max=M_MAX,
                                        segment_trips=0, device="cpu")
    stop = types.SimpleNamespace(should_stop=True)
    for solve in (trb.robust_padded_solve_batched, trb.segmented_padded_solve_batched):
        with pytest.raises(TypeError, match="CheckpointManager or a path"):
            solve(batch["qt"], batch["seeds"], m_max=M_MAX, checkpoint=3, device="cpu")
        with pytest.raises(trb.PreemptedError, match="segment 0") as ei:
            solve(batch["qt"], batch["seeds"], m_max=M_MAX, preempt=stop, device="cpu")
        assert ei.value.checkpoint_dir is None


# -- the service ---------------------------------------------------------

CLASSES = [(256, 32, 64, None), (1024, 64, 128, None)]
# (n, d, deadline_s) per request, in submission order: a patient backlog,
# requests without deadlines, then urgent ones in both classes
SUBMISSIONS = ([(200, 20, 3600.0)] * 5 + [(900, 50, None)] * 3 + [(800, 40, 7200.0)] * 2
               + [(100, 10, 600.0), (1000, 60, 300.0), (150, 12, None)])


def _dispatch_order(svc):
    """Replace the chunk solver with a recorder of (class n, request ids)."""
    order = []

    def record(cls, reqs, budget_s=None):
        order.append((cls.n, [r.req_id for r in reqs], budget_s is not None))
        return {}

    svc._solve_chunk = record
    return order


def test_edf_dispatch_order_matches_reference():
    rng = np.random.default_rng(1)
    ref = jsvc.SolverService([jsvc.ShapeClass(*c) for c in CLASSES], batch_size=4)
    port = tsvc.SolverService([tsvc.ShapeClass(*c) for c in CLASSES], batch_size=4,
                              device="cpu")
    orders = [_dispatch_order(ref), _dispatch_order(port)]
    for n, d, dl in SUBMISSIONS:
        A = rng.standard_normal((n, d)).astype(np.float32)
        y = rng.standard_normal(n).astype(np.float32)
        ref.submit(jnp.asarray(A), jnp.asarray(y), 0.1, deadline_s=dl)
        port.submit(torch.as_tensor(A), torch.as_tensor(y), 0.1, deadline_s=dl)
    ref.flush()
    port.flush()
    assert orders[1] == orders[0]
    assert orders[1][0] == (1024, [11, 8, 9, 5], True)    # the most urgent first


def test_spent_deadline_expires_chunk_like_reference():
    """A chunk whose deadline passed before dispatch expires unsolved, in
    both services: x = 0, no certificate, no batch run."""
    sols = []
    for mod, arr in ((jsvc, jnp.asarray), (tsvc, torch.as_tensor)):
        kw = {} if mod is jsvc else {"device": "cpu"}
        svc = mod.SolverService([mod.ShapeClass(*CLASSES[0])], batch_size=4, **kw)
        rid = svc.submit(arr(np.eye(40, 8, dtype=np.float32)), arr(np.ones(40, np.float32)),
                         0.1, deadline_s=-1.0)
        sols.append((svc.flush()[rid], svc.stats))
    (sj, stats_j), (st, stats_t) = sols
    assert st.status == sj.status == "DEADLINE_EXCEEDED"
    assert st.iters == sj.iters == 0 and np.isnan(st.delta_tilde)
    assert bool((st.x == 0).all()) and tuple(st.x.shape) == (8,)
    assert stats_t["deadline_exceeded"] == stats_j["deadline_exceeded"] == 1
    assert stats_t["batches"] == stats_j["batches"] == 0


def test_deadline_binds_mid_solve(batch, monkeypatch):
    """A request deadline of 2 s on the controlled clock: the chunk's solve
    runs two segments of 4 trips, then stops. Each request that was not done
    after those 8 trips comes back DEADLINE_EXCEEDED with its best finite
    iterate and a real δ̃; one that finished keeps its verdict."""
    svc = tsvc.SolverService([tsvc.ShapeClass(N, D, M_MAX)], batch_size=B,
                             segment_trips=4, device="cpu")
    svc._slot_seeds = lambda ids: batch["seeds"]
    reqs = [tsvc.RidgeRequest(i, torch.as_tensor(batch["A"][i]),
                              torch.as_tensor(batch["Y"][i]), float(batch["nus"][i]))
            for i in range(B)]
    q, seeds = svc._pack(svc.shape_classes[0], reqs)
    pre, st8 = tap.prepare_padded_solve(q, seeds, m_max=M_MAX, device="cpu")
    st8 = tap.padded_solve_segment(q, pre, st8, 8, method="pcg", device="cpu")
    expected = ["DEADLINE_EXCEEDED" if not done else "OK" for done in st8.done.tolist()]
    assert "OK" in expected and "DEADLINE_EXCEEDED" in expected
    clock = _SegmentClock(monkeypatch, trb, tsvc)
    ids = [svc.submit(torch.as_tensor(batch["A"][i]), torch.as_tensor(batch["Y"][i]),
                      float(batch["nus"][i]), deadline_s=2.0) for i in range(B)]
    sols = svc.flush()
    assert clock.now == 2.0
    assert [sols[rid].status for rid in ids] == expected
    for rid in ids:
        s = sols[rid]
        assert s.iters > 0 and np.isfinite(s.delta_tilde) and bool(torch.isfinite(s.x).all())
    assert svc.stats["deadline_exceeded"] == expected.count("DEADLINE_EXCEEDED")
    assert svc.stats["segments"] == 2
    assert svc.stats["retries"] == 0 and svc.stats["batches"] == 1


def test_flush_deadline_default_is_generous_and_bitwise(batch):
    """The service's ``flush_deadline_s`` routes chunks through the segmented
    driver; with a generous budget the answers are bitwise the monolithic
    service's."""
    out = []
    for kw in ({}, {"flush_deadline_s": 3600.0, "segment_trips": 8}):
        svc = tsvc.SolverService([tsvc.ShapeClass(N, D, M_MAX)], batch_size=B,
                                 device="cpu", **kw)
        ids = [svc.submit(torch.as_tensor(batch["A"][i]), torch.as_tensor(batch["Y"][i]),
                          float(batch["nus"][i])) for i in range(B)]
        sols = svc.flush()
        out.append(([sols[i] for i in ids], svc.stats["segments"]))
    (mono, seg0), (segd, seg1) = out
    assert seg0 == 0 and seg1 >= 1
    for a, b in zip(mono, segd):
        assert torch.equal(a.x, b.x)
        assert (a.delta_tilde, a.m_final, a.iters, a.doublings, a.status) == \
            (b.delta_tilde, b.m_final, b.iters, b.doublings, b.status)
