"""The port's sharded pass over ``torch.distributed`` on the CPU: gloo
groups of 8 and 4 ranks, one process each, started once per module through
``launch.mesh.run_ranks`` (``launch.sharded.run_tasks`` on every rank).

The expected values come from one process: the port's
``BlockEmulationProvider`` and ``ShardLadderCache.from_emulation`` (shard k
seeded ``fold_seeds(seed, k)``, Grams summed in shard order), and the
reference's own emulation (``repro.core.level_grams.BlockEmulationProvider``)
on handed-over per-shard samples. Tolerances: the summed all-reduce adds
the 8 shard stacks in gloo's order, not in shard order, so
``shard_level_grams`` matches the emulation within 1e-6 of the Grams'
scale (fp32 sums of 8 terms reordered: a few ulp); the per-shard form and
``ShardLadderCache.from_mesh`` are exact (an all-reduce of a zero-filled
buffer), so they are held bitwise. Sharded solves are held to the emulated
engine's statuses and m_final exactly, x within 1e-4 of its scale."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import level_grams as jlg  # noqa: E402
from repro.core import quadratic as jq  # noqa: E402
from repro.ft import resilience as jres  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core.adaptive_padded import doubling_ladder, padded_adaptive_solve_batched  # noqa: E402
from repro_torch.core.level_grams import BlockEmulationProvider, fold_seeds, get_provider  # noqa: E402
from repro_torch.core.precond import factorize  # noqa: E402
from repro_torch.core.quadratic import Quadratic, direct_solve, weighted_gram  # noqa: E402
from repro_torch.core.robust import (  # noqa: E402
    robust_padded_solve_batched,
    segmented_padded_solve_batched,
)
from repro_torch.core.sketches import make_sketch  # noqa: E402
from repro_torch.ft import resilience as tres  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.serve.solver_service import ShapeClass, SolverService  # noqa: E402

torch.set_num_threads(1)
JOB = "repro_torch.launch.sharded:run_tasks"
B, N, DD, M_MAX, K = 3, 256, 8, 16, 8
LADDER = doubling_ladder(M_MAX)
FAMILIES = ("gaussian", "gaussian_dense", "sjlt", "srht")
DTYPES = ("fp32", "bf16", "int8")


def _problem(seed, *, n=N, d=DD, weighted=False, shared=False, decay=0.8):
    g = torch.Generator().manual_seed(seed)
    shape = (n, d) if shared else (B, n, d)
    A = torch.randn(shape, generator=g) * decay ** torch.arange(d) / n ** 0.5
    w = torch.rand((B, n), generator=g) + 0.5 if weighted else None
    return Quadratic(A=A, b=torch.randn((B, d), generator=g), nu=torch.tensor([0.3, 0.05, 0.01]),
                     lam_diag=torch.ones((B, d)), batched=True, row_weights=w)


SEEDS = torch.tensor([11, 2 ** 31 + 5, 4000000000], dtype=torch.int64)
PASS_CASES = ([(f, c, w, False) for f in FAMILIES for c in DTYPES for w in (False, True)]
              + [("gaussian", "fp32", False, True), ("srht", "bf16", False, True)])
ENGINE_CASES = [("pcg", "gaussian", None), ("pcg", "gaussian", False), ("ihs", "srht", None),
                ("polyak", "sjlt", None), ("pcg", "sjlt", False)]
BLOCK_CASES = [("gaussian", 1), ("srht", 1), ("sjlt", 1), ("sjlt", 3)]


def _pass_name(f, c, w, sh):
    return f"pass-{f}-{c}-{'w' if w else 'u'}-{'shared' if sh else 'per'}"


def _pass_problem(f, c, w, sh):
    return _problem(FAMILIES.index(f) + 10 * DTYPES.index(c) + 100 * w + 1000 * sh,
                    weighted=w, shared=sh)


def _engine_problem():
    return _problem(7, n=512, d=16, decay=0.95)


@pytest.fixture(scope="module")
def eight():
    """One gloo group of 8 ranks that runs every 8-rank task of the module."""
    tasks = [(_pass_name(*case), "pass",
              dict(q=_pass_problem(*case), seeds=SEEDS, ladder=LADDER, sketch=case[0],
                   compute_dtype=case[1])) for case in PASS_CASES]
    tasks.append(("wgram", "weighted_gram", dict(q=_problem(3, weighted=True))))
    A = torch.randn((N, 12), generator=torch.Generator().manual_seed(4))
    for kind, s in BLOCK_CASES:
        tasks.append((f"block-{kind}-{s}", "block_sketch",
                      dict(A=A, seed=21, kind=kind, m=24, s=s, nu=0.5, v=torch.ones(12))))
    for method, sketch, gram_hvp in ENGINE_CASES:
        tasks.append((f"engine-{method}-{sketch}-{gram_hvp}", "engine",
                      dict(q=_engine_problem(), seeds=SEEDS,
                           kw=dict(m_max=64, method=method, sketch=sketch, gram_hvp=gram_hvp,
                                   max_iters=100))))
    tasks.append(("robust", "robust", dict(q=_engine_problem(), seeds=SEEDS,
                                           kw=dict(m_max=64, sketch="sjlt", max_retries=1))))
    tasks.append(("meshes", "meshes", {}))
    tasks.append(("imports", "imports", {}))
    return run_ranks(JOB, K, {"tasks": tasks}, device="cpu", timeout=600)


def _emulated_grams(case):
    f, c, w, sh = case
    q = _pass_problem(*case)
    p = BlockEmulationProvider(f, K)
    return q, p.level_grams(p.sample(SEEDS, M_MAX, N), q, LADDER, compute_dtype=c)


@pytest.mark.parametrize("case", PASS_CASES, ids=lambda c: _pass_name(*c))
def test_shard_level_grams_match_block_emulation(eight, case):
    _, want = _emulated_grams(case)
    got = eight[0][_pass_name(*case)]["grams"]
    assert got.shape == (len(LADDER), B, DD, DD)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    for r in eight[1:]:                      # replicated: every rank the same bits
        assert torch.equal(r[_pass_name(*case)]["grams"], got)


@pytest.mark.parametrize("case", PASS_CASES, ids=lambda c: _pass_name(*c))
def test_per_shard_and_from_mesh_are_bitwise_the_emulation(eight, case):
    f, c, w, sh = case
    q, want_total = _emulated_grams(case)
    emu = D.ShardLadderCache.from_emulation(f, SEEDS, q, LADDER, K, compute_dtype=c)
    res = eight[0][_pass_name(*case)]
    assert torch.equal(res["per_shard"], emu.shard_grams)
    assert torch.equal(res["cache_total"], emu.total())
    assert torch.equal(res["cache_total"], want_total)


def test_summed_pass_matches_the_reference_emulation_on_handed_over_samples(eight):
    """The reference's one-device block emulation (``level_grams.py:274``),
    handed the port's per-shard samples, gives the sharded SJLT Grams."""
    q = _pass_problem("sjlt", "fp32", False, False)
    p = get_provider("sjlt")
    shards = [p.sample(fold_seeds(SEEDS, k), M_MAX, N // K) for k in range(K)]
    qj = jq.Quadratic(A=jnp.asarray(q.A.numpy()), b=jnp.asarray(q.b.numpy()),
                      nu=jnp.asarray(q.nu.numpy()), lam_diag=jnp.asarray(q.lam_diag.numpy()),
                      batched=True)
    data = {"shards": [{k: jnp.asarray(v.numpy()) for k, v in s.items()} for s in shards]}
    want = np.asarray(jlg.BlockEmulationProvider("sjlt", K).level_grams(data, qj, LADDER))
    got = eight[0][_pass_name("sjlt", "fp32", False, False)]["grams"].numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_shard_weighted_gram(eight):
    q = _problem(3, weighted=True)
    want = weighted_gram(q.A, q.row_weights)
    got = eight[0]["wgram"]["gram"]
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("kind,s", BLOCK_CASES)
def test_block_sketch_gram_is_the_summed_block_sketch(eight, kind, s):
    """SA = Σ_k S_k A_k with S_k = make_sketch(..., fold_seeds(seed, k)) on
    rows [k·n/K, (k+1)·n/K), no rescale (the reference's regression)."""
    A = torch.randn((N, 12), generator=torch.Generator().manual_seed(4))
    n_loc = N // K
    want = sum(make_sketch(kind, 24, n_loc, fold_seeds(torch.tensor(21), k), s=s,
                           device="cpu").apply(A[k * n_loc:(k + 1) * n_loc])
               for k in range(K))
    got = eight[0][f"block-{kind}-{s}"]["SA"]
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # distributed_sketch_and_factorize: the replicated H_S of that sketch
    # (m = 24 ≥ d = 12: the primal Cholesky)
    want_solve = factorize(want, torch.tensor(0.5), torch.ones(12)).solve(torch.ones(12))
    got_solve = eight[0][f"block-{kind}-{s}"]["solve"]
    assert float((got_solve - want_solve).abs().max()) <= 1e-4 * float(want_solve.abs().max())


@pytest.mark.parametrize("method,sketch,gram_hvp", ENGINE_CASES)
def test_sharded_engine_matches_the_emulated_engine(eight, method, sketch, gram_hvp):
    """The sharded engine (gram_hvp off: the matrix-free H·v all-reduced every
    trip) against the one-device engine on BlockEmulationProvider."""
    q = _engine_problem()
    xe, se = padded_adaptive_solve_batched(
        q, SEEDS, m_max=64, method=method, sketch=BlockEmulationProvider(sketch, K),
        gram_hvp=gram_hvp, max_iters=100, device="cpu")
    for r in eight:
        res = r[f"engine-{method}-{sketch}-{gram_hvp}"]
        assert torch.equal(res["stats"]["status"], se["status"])
        assert torch.equal(res["stats"]["m_final"], se["m_final"])
        assert float((res["x"] - xe).abs().max()) <= 1e-4 * float(xe.abs().max())
    assert int(se["m_final"].max()) >= 8            # the ladders climbed


def test_sharded_robust_driver(eight):
    q = _engine_problem()
    xe, se = robust_padded_solve_batched(q, SEEDS, m_max=64, sketch=BlockEmulationProvider(
        "sjlt", K), max_retries=1, device="cpu")
    res = eight[0]["robust"]
    assert torch.equal(res["stats"]["status"], se["status"])
    assert torch.equal(res["stats"]["m_final"], se["m_final"])
    assert float((res["x"] - xe).abs().max()) <= 1e-4 * float(xe.abs().max())


def test_meshes_and_data_index(eight):
    ranks = sorted(r["rank"] for r in eight)
    assert ranks == list(range(K))
    host = [r["meshes"]["host"] for r in eight]
    assert {h["shape"] for h in host} == {(2, 4)}
    assert host[0]["names"] == ("data", "model") and host[0]["data_axes"] == ("data",)
    assert sorted(h["data_index"] for h in host) == [0] * 4 + [1] * 4
    assert all(h["n_data_shards"] == 2 for h in host)
    el = eight[0]["meshes"]["elastic"]
    assert el["shape"] == tres.plan_mesh_shape(K) == (1, 8)


def test_ranks_import_no_jax(eight):
    assert all(r["imports"] == [] for r in eight)


def _requests(g, n_rng, d_rng, count):
    out = []
    for _ in range(count):
        n = int(torch.randint(*n_rng, (1,), generator=g))
        d = int(torch.randint(*d_rng, (1,), generator=g))
        U, _ = torch.linalg.qr(torch.randn(n, d, generator=g))
        A = U * 0.9 ** torch.arange(d)
        out.append((A, torch.randn(n, generator=g), float(torch.rand((), generator=g)) * 0.2 + 0.05))
    return out


CLASSES = (ShapeClass(n=256, d=16, m_max=32), ShapeClass(n=512, d=16, m_max=32, sketch="srht"))
SVC = dict(shape_classes=CLASSES, batch_size=4, tol=1e-8)


@pytest.fixture(scope="module")
def service_run():
    """A sharded service on a gloo group of 4 ranks: ridge requests in both
    classes, two logistic GLM requests and two λ paths."""
    g = torch.Generator().manual_seed(5)
    reqs = _requests(g, (100, 256), (4, 16), 5) + _requests(g, (300, 512), (4, 16), 3)
    glm = []
    for _ in range(2):
        A = torch.randn(200, 8, generator=g) / 8 ** 0.5
        glm.append((A, (torch.rand(200, generator=g) < torch.sigmoid(A @ torch.randn(8, generator=g))).float(), 0.2))
    paths = [(A, y, (1.0, 0.3, 0.1)) for A, y, _ in _requests(g, (100, 256), (4, 16), 2)]
    payload = {"tasks": [("svc", "service", dict(
        requests=reqs, glm=glm, paths=paths, service=SVC))]}
    return reqs, glm, paths, run_ranks(JOB, 4, payload, device="cpu", timeout=600)


def _energy_err(x, A, y, nu) -> float:
    """‖x − x*‖_H / ‖x*‖_H against an fp64 solve: the norm the δ̃
    certificate bounds (tol 1e-8 on δ̃ is about 1e-4 here)."""
    A64, y64 = A.double(), y.double()
    H = A64.T @ A64 + nu ** 2 * torch.eye(A.shape[1], dtype=torch.float64)
    x_star = torch.linalg.solve(H, A64.T @ y64)
    e = x.double() - x_star
    return float(torch.sqrt(e @ H @ e) / torch.sqrt(x_star @ H @ x_star))


def test_sharded_service_answers(service_run):
    reqs, _, _, res = service_run
    answers = res[0]["svc"]["answers"]
    for (A, y, nu), a in zip(reqs, answers):
        assert a["status"] == "OK"
        assert _energy_err(a["x"], A, y, nu) < 1e-3
    assert {a["shape_class"][0] for a in answers} == {256, 512}
    for r in res[1:]:
        for a, b in zip(answers, r["svc"]["answers"]):
            assert torch.equal(a["x"], b["x"]) and a["m_final"] == b["m_final"]


def test_sharded_service_queues_only_the_ranks_rows(service_run):
    """Rank k keeps rows [k·n/K, (k+1)·n/K) of the class's n of every queued
    ridge and path request, not the whole request."""
    reqs, _, paths, res = service_run
    for r in res:
        k, want = r["rank"], []
        for A, _, _ in reqs + paths:
            rows = next(c.n for c in CLASSES if A.shape[0] <= c.n) // 4
            want.append(min(max(A.shape[0] - k * rows, 0), rows))
        assert sorted(r["svc"]["queued_rows"]) == sorted(want)


def test_sharded_service_matches_the_emulated_service(service_run):
    """A one-device service whose family is the 4-shard emulation gives the
    same certificates (the SRHT class keeps its own family, so only the
    Gaussian class is compared)."""
    reqs, _, _, res = service_run
    svc = SolverService(device="cpu", sketch=BlockEmulationProvider("gaussian", 4), **SVC)
    ids = [svc.submit(A, y, nu) for A, y, nu in reqs]
    sols = svc.flush()
    for rid, a in zip(ids, res[0]["svc"]["answers"]):
        if a["shape_class"][0] != 256:
            continue
        assert sols[rid].status == a["status"] and sols[rid].m_final == a["m_final"]
        assert float((sols[rid].x - a["x"]).abs().max()) <= 1e-4 * float(a["x"].abs().max())


def test_sharded_service_glm_and_paths(service_run):
    _, glm, paths, res = service_run
    for a in res[0]["svc"]["glm"]:
        assert a["converged"] and a["status"] == "OK"
    for (A, y, nus), p in zip(paths, res[0]["svc"]["paths"]):
        assert p["statuses"] == ["OK"] * len(nus)
        for x, nu in zip(p["xs"], nus):
            assert _energy_err(x, A, y, nu) < 1e-3


class _FakeMesh:
    """A mesh's names, shape and this rank's place on it, enough for a
    driver whose collectives the tests replace (``_one_rank_collectives``)."""

    mesh_dim_names = ("data",)
    shape = (4,)
    device_type = "cpu"

    def __init__(self, rank: int = 0):
        self.rank = rank

    def get_local_rank(self, dim):
        return self.rank


def _one_rank_collectives(monkeypatch, *, stop=False, expired=False):
    """Replace the collectives with a one-rank stand-in whose host verdict
    is (stop, expired) whatever this rank reads; returns the verdict calls."""
    calls = []

    def verdict(mesh, *, stop=stop, expired=expired, _want=(stop, expired)):
        calls.append((stop, expired))
        return _want

    monkeypatch.setattr(D, "all_reduce_sum", lambda t, mesh: t)
    monkeypatch.setattr(D, "barrier", lambda mesh: None)
    monkeypatch.setattr(D, "lead_values", lambda mesh, v: list(v) if isinstance(
        v, (list, tuple)) else [v])
    monkeypatch.setattr(D, "host_verdict", verdict)
    return calls


def test_sharded_service_refusals(monkeypatch):
    """A class whose n the shard count does not divide is refused; a
    flush's deadline is the lead rank's verdict, taken once per chunk."""
    with pytest.raises(ValueError, match="not divisible"):
        SolverService(mesh=_FakeMesh(), device="cpu",
                      shape_classes=(ShapeClass(n=102, d=8, m_max=16),))
    calls = _one_rank_collectives(monkeypatch, expired=True)
    svc = SolverService(mesh=_FakeMesh(rank=1), device="cpu", flush_deadline_s=3600.0, **SVC)
    rid = svc.submit(torch.randn(50, 4), torch.randn(50), 0.1, deadline_s=3600.0)
    assert svc.flush()[rid].status == "DEADLINE_EXCEEDED"
    assert calls == [(False, False)]      # this rank's clock said no; the lead's said yes
    default = SolverService(mesh=_FakeMesh(), device="cpu")
    assert default.bucket_for(60000, 200).n == 65536
    with pytest.raises(ValueError, match="no shape class fits"):
        SolverService(device="cpu").bucket_for(60000, 200)


def test_sharded_drivers_refuse_per_rank_host_decisions(tmp_path, monkeypatch):
    """No rank decides on its own clock or flag: a deadline and a preemption
    flag follow the host verdict, and a rank other than the lead writes no
    checkpoint."""
    from repro_torch.core.newton import adaptive_newton_solve_batched
    from repro_torch.core.robust import PreemptedError

    q = _problem(1)
    kw = dict(m_max=8, segment_trips=1, mesh=_FakeMesh(rank=1), device="cpu")
    calls = _one_rank_collectives(monkeypatch, expired=True)
    _, st = segmented_padded_solve_batched(q, SEEDS, deadline_s=3600.0, **kw)
    assert st["deadline_hit"] and st["segments"] == 1 and calls == [(False, False)] * 2
    _, st = robust_padded_solve_batched(q, SEEDS, m_max=8, deadline_s=3600.0,
                                        segment_trips=1, mesh=_FakeMesh(rank=1),
                                        device="cpu")
    assert st["deadline_hit"] and st["segments"] == 1
    _, st = adaptive_newton_solve_batched("logistic", q.A, torch.zeros(B, N), 0.1, m_max=8,
                                          deadline_s=3600.0, mesh=_FakeMesh(rank=1),
                                          device="cpu")
    assert st["newton_iters"].tolist() == [1] * B
    _one_rank_collectives(monkeypatch, stop=True)
    with pytest.raises(PreemptedError):
        segmented_padded_solve_batched(q, SEEDS, checkpoint=tmp_path, preempt=object(), **kw)
    assert list(tmp_path.iterdir()) == []


def test_quadratic_shardings():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh2:
        mesh_dim_names = ("data", "model")

    per = D.quadratic_shardings(Mesh2(), _problem(1, weighted=True))
    assert per.A == (Shard(1), Replicate()) and per.row_weights == (Shard(1), Replicate())
    assert per.b == per.nu == per.lam_diag == (Replicate(), Replicate()) and per.batched
    shared = D.quadratic_shardings(Mesh2(), _problem(1, shared=True))
    assert shared.A == (Shard(0), Replicate()) and shared.row_weights is None
    single = D.quadratic_shardings(Mesh2())
    assert single.A == (Shard(0), Replicate()) and not single.batched


@pytest.mark.parametrize("global_batch,n_live", [(256, 512), (256, 96), (96, 24), (30, 7),
                                                 (64, 1), (48, 36)])
def test_plan_elastic_matches_reference(global_batch, n_live):
    want = jres.plan_elastic(global_batch, n_live)
    got = tres.plan_elastic(global_batch, n_live)
    assert got.n_devices == want.n_devices
    assert got.mesh.shape == dict(want.mesh.shape)
    assert got.mesh.axis_names == tuple(want.mesh.axis_names)
    assert got.per_device_batch == want.per_device_batch
    assert got.num_microbatches == want.num_microbatches
    assert tres.plan_mesh_shape(n_live) == jres.plan_mesh_shape(n_live)


def test_shard_quadratic_blocks_are_contiguous_rows():
    class Rank3:
        mesh_dim_names = ("data",)
        shape = (4,)

        def get_local_rank(self, name):
            return 3

    q = _problem(2, weighted=True)
    loc = D.shard_quadratic(q, Rank3())
    assert loc.A.is_contiguous() and torch.equal(loc.A, q.A[:, 192:])
    assert torch.equal(loc.row_weights, q.row_weights[:, 192:])
    assert loc.b is q.b and loc.nu is q.nu
    single = D.shard_quadratic(Quadratic(A=q.A[0], b=q.b[0], nu=q.nu[0], lam_diag=q.lam_diag[0]),
                               Rank3())
    assert torch.equal(single.A, q.A[0, 192:])
    with pytest.raises(ValueError, match="not divisible"):
        D.shard_quadratic(_problem(2, n=250), Rank3())


def test_bridge_quadratic_shards_like_the_reference():
    """A handed-over problem's block is the reference's row block."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((2, 64, 4)).astype(np.float32)
    q = bridge.quadratic_from_numpy(A, np.ones((2, 4)), [0.1, 0.2], np.ones((2, 4)),
                                    device="cpu")

    class Rank1:
        mesh_dim_names = ("data",)
        shape = (2,)

        def get_local_rank(self, name):
            return 1

    np.testing.assert_array_equal(D.shard_quadratic(q, Rank1()).A.numpy(), A[:, 32:])
    assert direct_solve(q).shape == (2, 4)
