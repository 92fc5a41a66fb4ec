"""Deadlines, checkpoints and preemption under a mesh, on the CPU: gloo
groups of 4 ranks (and 2, for a resume onto another shard count), one
process each, started through ``launch.mesh.run_ranks`` with a time limit,
so a collective taken on one rank only fails the test instead of hanging
it.

Every host decision of a sharded solve is the lead rank's or every rank's
(``core.distributed.host_verdict``): the tests hold the verdicts, the
segment counts, the statuses and the answers equal on every rank, a
generous deadline and a resume on the same K bitwise to the uninterrupted
sharded answer, and a deadline that binds after the first segment to the
statuses of the one-device emulation (``BlockEmulationProvider``) under the
same rule. A resume onto another K recomputes ``prepare`` with the new
blocks' sketches, so its answers are held to the ridge gate (energy-norm
error against an fp64 solve below 1e-3), not bitwise."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.level_grams import BlockEmulationProvider  # noqa: E402
from repro_torch.core.newton import adaptive_newton_solve_batched  # noqa: E402
from repro_torch.core.quadratic import Quadratic  # noqa: E402
from repro_torch.core.robust import segmented_padded_solve_batched  # noqa: E402
from repro_torch.core.status import SolveStatus  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.serve.solver_service import ShapeClass  # noqa: E402

torch.set_num_threads(1)
JOB = "repro_torch.launch.sharded:run_tasks"
K, B, N, DD, M_MAX, TRIPS = 4, 3, 512, 16, 64, 4
SEEDS = torch.tensor([11, 2 ** 31 + 5, 4000000000], dtype=torch.int64)
KW = dict(m_max=M_MAX, sketch="gaussian", segment_trips=TRIPS, max_iters=100)
PREEMPT = (2, 3)       # rank 2's flag turns on at its third poll: before segment 3
CLASSES = (ShapeClass(n=256, d=16, m_max=32),)
DEADLINES = (3600.0, None, 0.0, 0.0, None, 1800.0)


def _problem():
    g = torch.Generator().manual_seed(7)
    A = torch.randn((B, N, DD), generator=g) * 0.95 ** torch.arange(DD) / N ** 0.5
    return Quadratic(A=A, b=torch.randn((B, DD), generator=g),
                     nu=torch.tensor([0.3, 0.05, 0.01]), lam_diag=torch.ones((B, DD)),
                     batched=True)


def _glm():
    g = torch.Generator().manual_seed(8)
    A = torch.randn((B, 256, 8), generator=g) / 8 ** 0.5
    y = (torch.rand((B, 256), generator=g) < 0.5).float()
    return A, y


def _requests():
    g = torch.Generator().manual_seed(9)
    out = []
    for _ in DEADLINES:
        n = int(torch.randint(100, 256, (1,), generator=g))
        d = int(torch.randint(4, 16, (1,), generator=g))
        U, _ = torch.linalg.qr(torch.randn(n, d, generator=g))
        out.append((U * 0.9 ** torch.arange(d), torch.randn(n, generator=g), 0.1))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 4-rank group for every same-K case, then one 2-rank group that
    resumes the second preempted solve."""
    q = _problem()
    A, y = _glm()
    ck = tmp_path_factory.mktemp("mesh_ft")
    seg = dict(q=q, seeds=SEEDS)
    tasks = [
        ("plain", "segmented", dict(seg, kw=KW)),
        ("generous", "segmented", dict(seg, kw=dict(KW, deadline_s=3600.0))),
        ("bind", "segmented", dict(seg, kw=dict(KW, deadline_s=0.0))),
        # only the lead rank's clock counts: spent elsewhere never binds,
        # spent on the lead binds every rank
        ("others-late", "segmented", dict(seg, kw=KW, deadlines=[3600.0] + [0.0] * (K - 1))),
        ("lead-late", "segmented", dict(seg, kw=KW, deadlines=[0.0] + [3600.0] * (K - 1))),
        ("pre", "segmented", dict(seg, kw=KW, checkpoint=str(ck / "a"), preempt=PREEMPT)),
        # rank 1 sees an empty directory (a per-host checkpoint_dir)
        ("blind", "segmented", dict(seg, kw=KW, checkpoint=[
            str(ck / ("empty" if r == 1 else "a")) for r in range(K)])),
        ("resume", "segmented", dict(seg, kw=KW, checkpoint=str(ck / "a"))),
        ("pre2", "segmented", dict(seg, kw=KW, checkpoint=str(ck / "b"), preempt=PREEMPT)),
        ("mismatch", "segmented", dict(seg, kw=dict(KW, max_iters=99),
                                       checkpoint=str(ck / "b"))),
        ("newton", "newton", dict(A=A, y=y, nu=0.2, kw=dict(m_max=16, deadline_s=0.0,
                                                            seeds=SEEDS))),
        ("svc", "service", dict(requests=_requests(), deadlines=DEADLINES,
                                service=dict(shape_classes=CLASSES, batch_size=2, tol=1e-8,
                                             segment_trips=TRIPS,
                                             checkpoint_dir=str(ck / "svc")))),
    ]
    four = run_ranks(JOB, K, {"tasks": tasks}, device="cpu", timeout=300)
    manifests = sorted((ck / "b").glob("step_*/manifest.json"))
    fingerprint = json.loads(manifests[-1].read_text())["extra"]["fingerprint"]
    two = run_ranks(JOB, 2, {"tasks": [("resume", "segmented", dict(
        seg, kw=KW, checkpoint=str(ck / "b")))]}, device="cpu", timeout=300)
    return four, two, fingerprint


def _same(res, name, key):
    return all(torch.equal(r[name][key], res[0][name][key]) for r in res)


def test_generous_deadline_is_bitwise_the_no_deadline_answer(runs):
    four, _, _ = runs
    for r in four:
        assert torch.equal(r["generous"]["x"], r["plain"]["x"])
        assert torch.equal(r["generous"]["stats"]["status"], r["plain"]["stats"]["status"])
        assert not r["generous"]["stats"]["deadline_hit"]
        assert r["generous"]["stats"]["verdicts"] == r["generous"]["stats"]["segments"]
    assert _same(four, "plain", "x")
    assert four[0]["plain"]["stats"]["segments"] >= 3


def test_binding_deadline_is_one_verdict_on_every_rank(runs):
    """deadline_s = 0: the first segment always runs, then the lead rank's
    clock stops every rank; the statuses are the emulation's under the same
    rule."""
    four, _, _ = runs
    got = [r["bind"]["stats"] for r in four]
    assert all(s["deadline_hit"] and s["segments"] == 1 and s["verdicts"] == 2 for s in got)
    assert _same(four, "bind", "x")
    assert all(torch.equal(s["status"], got[0]["status"]) for s in got)
    _, want = segmented_padded_solve_batched(
        _problem(), SEEDS, **dict(KW, sketch=BlockEmulationProvider("gaussian", K)),
        deadline_s=0.0, device="cpu")
    assert torch.equal(got[0]["status"], want["status"])
    assert int(SolveStatus.DEADLINE_EXCEEDED) in got[0]["status"].tolist()


def test_only_the_lead_ranks_clock_counts(runs):
    """A deadline spent on every rank but the lead never binds (bitwise the
    no-deadline answer); one spent on the lead alone binds every rank after
    the first segment, as a deadline spent everywhere does."""
    four, _, _ = runs
    for r in four:
        s = r["others-late"]["stats"]
        assert not s["deadline_hit"] and s["verdicts"] == s["segments"]
        assert torch.equal(r["others-late"]["x"], r["plain"]["x"])
        assert torch.equal(s["status"], r["plain"]["stats"]["status"])
        s = r["lead-late"]["stats"]
        assert s["deadline_hit"] and s["segments"] == 1 and s["verdicts"] == 2
        assert torch.equal(r["lead-late"]["x"], r["bind"]["x"])
        assert torch.equal(s["status"], r["bind"]["stats"]["status"])
    assert [r["others-late"]["deadline_s"] for r in four] == [3600.0] + [0.0] * (K - 1)


def test_a_rank_that_cannot_read_the_lead_step_stops_every_rank(runs):
    """Every rank resumes the lead rank's latest step or none does: when one
    rank cannot read it, every rank raises ValueError before the loop and
    nobody writes a checkpoint."""
    four, _, _ = runs
    errors = [r["blind"]["error"] for r in four]
    assert all(e and "cannot resume step" in e for e in errors), errors
    assert "No such file" in errors[1] or "no committed" in errors[1], errors[1]
    assert all("another rank cannot read it" in e for i, e in enumerate(errors) if i != 1)
    assert [r["blind"]["saves"] for r in four] == [0] * K


def test_preempting_one_rank_stops_every_rank_and_resumes_bitwise(runs):
    four, _, _ = runs
    assert [r["pre"]["preempted"] for r in four] == [2] * K
    assert [r["pre"]["saves"] > 0 for r in four] == [True] + [False] * (K - 1)
    for r in four:
        assert r["resume"]["stats"]["resumed"]
        assert torch.equal(r["resume"]["x"], r["plain"]["x"])
        assert torch.equal(r["resume"]["stats"]["status"], r["plain"]["stats"]["status"])
        assert r["resume"]["saves"] == (r["resume"]["stats"]["segments"] if r["rank"] == 0
                                        else 0)


def test_fingerprint_carries_the_global_n_and_a_mismatch_raises(runs):
    four, _, fingerprint = runs
    assert fingerprint == f"{B}x{N}x{DD}:m{M_MAX}:pcg:gaussian:mi100"
    assert all("fingerprint mismatch" in r["mismatch"]["error"] for r in four)


def _energy_err(x, q, b):
    A = q.A[b].double()
    H = A.T @ A + float(q.nu[b]) ** 2 * torch.eye(DD, dtype=torch.float64)
    xs = torch.linalg.solve(H, q.b[b].double())
    e = x.double() - xs
    return float(torch.sqrt(e @ H @ e) / torch.sqrt(xs @ H @ xs))


def test_resume_onto_another_shard_count(runs):
    four, two, _ = runs
    q = _problem()
    assert all(r["pre2"]["preempted"] == 2 for r in four)
    assert _same(two, "resume", "x")
    for r in two:
        assert r["resume"]["stats"]["resumed"]
        assert r["resume"]["stats"]["status"].tolist() == [int(SolveStatus.OK)] * B
    for b in range(B):
        assert _energy_err(two[0]["resume"]["x"][b], q, b) < 1e-3


def test_sharded_newton_deadline_verdict(runs):
    four, _, _ = runs
    A, y = _glm()
    got = [r["newton"]["stats"] for r in four]
    assert all(torch.equal(s["status"], got[0]["status"]) for s in got)
    assert all(torch.equal(s["newton_iters"], got[0]["newton_iters"]) for s in got)
    assert _same(four, "newton", "x")
    assert got[0]["newton_iters"].tolist() == [1] * B
    _, want = adaptive_newton_solve_batched("logistic", A, y, 0.2, m_max=16, seeds=SEEDS,
                                            deadline_s=0.0, device="cpu")
    assert torch.equal(got[0]["status"], want["status"])
    assert got[0]["status"].tolist() == [int(SolveStatus.DEADLINE_EXCEEDED)] * B


def test_sharded_service_deadlines_order_and_answers(runs):
    four, _, _ = runs
    svc = [r["svc"] for r in four]
    assert all(s["order"] == svc[0]["order"] for s in svc)
    for s in svc[1:]:
        for a, b in zip(svc[0]["answers"], s["answers"]):
            assert torch.equal(a["x"], b["x"]) and a["status"] == b["status"]
    statuses = [a["status"] for a in svc[0]["answers"]]
    # EDF in chunks of 2: the two spent requests expire together before
    # dispatch, then 1800 s and 3600 s, then the two without a deadline
    assert svc[0]["order"] == [2, 3, 5, 0, 1, 4]
    assert statuses == ["OK", "OK", "DEADLINE_EXCEEDED", "DEADLINE_EXCEEDED", "OK", "OK"]


def test_launch_serve_preempt_cycle_on_a_mesh():
    """``python -m repro_torch.launch.serve --mesh 2 --preempt-after`` on the
    CPU: SIGTERM to rank 1 only, both ranks exit 75 after the same segment,
    and ``--resume`` answers bitwise as the uninterrupted run did."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--mesh", "2",
                        "--preempt-after", "0.2", "--requests", "3", "--device", "cpu"],
                       capture_output=True, text=True, env=env, cwd=str(root), timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "exit codes [75, 75]" in r.stdout
    assert "answers bitwise the uninterrupted run's: True" in r.stdout
    assert "preemption cycle OK on 2 ranks" in r.stdout
