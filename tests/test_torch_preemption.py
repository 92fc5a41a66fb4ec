"""Preemptible solves on the port, on the CPU: a solve preempted at segment
k and resumed from its checkpoint is bitwise the uninterrupted one (the
driver for ihs, pcg and polyak; a real SIGTERM; a kill -9 subprocess; a
preempted service flush resumed on a new service), a checkpoint of another
solve is refused, a checkpoint the JAX reference wrote resumes in the port
to the reference's statuses and m_final, the service names a chunk's
checkpoint directory as the reference does, and the launcher's SIGTERM →
exit 75 → ``--resume`` cycle runs."""

import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import PreemptedError as JPreemptedError  # noqa: E402
from repro.core import robust as jrb  # noqa: E402
from repro.core.level_grams import _uint32_seeds  # noqa: E402
from repro.core.quadratic import from_least_squares_batch as j_flsb  # noqa: E402
from repro.ft import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.serve import solver_service as jsvc  # noqa: E402
from repro_torch.core import PreemptedError  # noqa: E402
from repro_torch.core import adaptive_padded as tap  # noqa: E402
from repro_torch.core import robust as trb  # noqa: E402
from repro_torch.core.quadratic import from_least_squares_batch as t_flsb  # noqa: E402
from repro_torch.core.status import SolveStatus  # noqa: E402
from repro_torch.ft import CheckpointManager, PreemptionHandler  # noqa: E402
from repro_torch.serve import solver_service as tsvc  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, N, D, M_MAX = 4, 128, 16, 32
CERT_KEYS = ("status", "m_final", "iters", "dtilde", "level", "doublings", "trips")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((B, N, D)) / np.sqrt(N)).astype(np.float32)
    Y = rng.standard_normal((B, N)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(42), B)
    return {"A": A, "Y": Y, "keys": keys,
            "qt": t_flsb(torch.as_tensor(A), torch.as_tensor(Y), 0.1),
            "qj": j_flsb(jnp.asarray(A), jnp.asarray(Y), 0.1),
            "seeds": torch.as_tensor(np.asarray(_uint32_seeds(keys)).astype(np.int64))}


def _assert_bitwise(x, s, x_ref, s_ref):
    assert torch.equal(x, x_ref)
    for k in CERT_KEYS:
        assert torch.equal(torch.as_tensor(s[k]), torch.as_tensor(s_ref[k])), k


class _Flag:
    should_stop = False


def _trip_wire(flag, at):
    def hook(seg, st):
        if seg == at:
            flag.should_stop = True
    return hook


@pytest.mark.parametrize("method", ["ihs", "pcg", "polyak"])
def test_preempt_checkpoint_resume_bitwise(batch, tmp_path, method):
    """Preempted at segment 2: the state is committed and PreemptedError
    raised; a second call resumes from the committed segment and finishes
    bitwise the uninterrupted segmented run. Resuming a finished solve
    restores it, runs no segment and gives the same answer."""
    kw = dict(m_max=M_MAX, method=method, tol=1e-10, segment_trips=4, device="cpu")
    x_ref, s_ref = trb.segmented_padded_solve_batched(batch["qt"], batch["seeds"], **kw)
    assert s_ref["segments"] >= 3                       # the preemption lands mid-solve
    ckpt = CheckpointManager(tmp_path / "ck")
    flag = _Flag()
    with pytest.raises(PreemptedError) as ei:
        trb.segmented_padded_solve_batched(batch["qt"], batch["seeds"], checkpoint=ckpt,
                                           preempt=flag, on_segment=_trip_wire(flag, 2), **kw)
    assert ei.value.segment == 2 and ckpt.latest_step() == 2
    assert ei.value.checkpoint_dir == ckpt.dir
    # the restored state is the in-memory one: values, dtypes and strides
    pre, st = tap.prepare_padded_solve(batch["qt"], batch["seeds"], m_max=M_MAX, device="cpu")
    st = tap.padded_solve_segment(batch["qt"], pre, st, 8, method=method, device="cpu")
    restored, _ = ckpt.restore(st._asdict())
    for k, v in st._asdict().items():
        assert torch.equal(restored[k], v) and restored[k].stride() == v.stride(), k
    x, s = trb.segmented_padded_solve_batched(batch["qt"], batch["seeds"], checkpoint=ckpt,
                                              **kw)
    assert s["resumed"] and s["segments"] == s_ref["segments"] - 2
    _assert_bitwise(x, s, x_ref, s_ref)
    x2, s2 = trb.segmented_padded_solve_batched(batch["qt"], batch["seeds"],
                                                checkpoint=ckpt, **kw)
    assert s2["resumed"] and s2["segments"] == 0
    _assert_bitwise(x2, s2, x_ref, s_ref)
    # resume=False starts over (and overwrites the steps as it goes)
    x3, s3 = trb.segmented_padded_solve_batched(batch["qt"], batch["seeds"], checkpoint=ckpt,
                                                resume=False, **kw)
    assert not s3["resumed"] and s3["segments"] == s_ref["segments"]
    _assert_bitwise(x3, s3, x_ref, s_ref)


def test_robust_driver_checkpoints_first_attempt_and_reports_resume(batch, tmp_path):
    """The robust driver routes ``checkpoint``/``preempt`` to its first
    attempt: a preempted solve resumes bitwise and ``resumed`` is real."""
    kw = dict(m_max=M_MAX, tol=1e-10, segment_trips=4, device="cpu")
    x_ref, s_ref = trb.robust_padded_solve_batched(batch["qt"], batch["seeds"], **kw)
    assert not s_ref["resumed"]
    flag = _Flag()
    with pytest.raises(PreemptedError):
        trb.robust_padded_solve_batched(batch["qt"], batch["seeds"], preempt=flag,
                                        checkpoint=str(tmp_path), checkpoint_every=2,
                                        on_segment=_trip_wire(flag, 3), **kw)
    x, s = trb.robust_padded_solve_batched(batch["qt"], batch["seeds"],
                                           checkpoint=str(tmp_path), **kw)
    assert s["resumed"] and s["segments"] == s_ref["segments"] - 3
    _assert_bitwise(x, s, x_ref, s_ref)


def test_resume_fingerprint_mismatch_raises(batch, tmp_path):
    """A checkpoint of another solve (here another m_max) is refused."""
    trb.segmented_padded_solve_batched(batch["qt"], batch["seeds"], m_max=M_MAX, tol=1e-10,
                                       segment_trips=4, checkpoint=str(tmp_path),
                                       device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        trb.segmented_padded_solve_batched(batch["qt"], batch["seeds"], m_max=16,
                                           tol=1e-10, segment_trips=4,
                                           checkpoint=str(tmp_path), device="cpu")


def test_sigterm_checkpoints_and_resumes(batch, tmp_path):
    """The real signal: PreemptionHandler catches SIGTERM mid-solve, the
    driver commits and raises, and the restarted solve resumes bitwise."""
    kw = dict(m_max=M_MAX, tol=1e-10, segment_trips=4, device="cpu")
    x_ref, s_ref = trb.segmented_padded_solve_batched(batch["qt"], batch["seeds"], **kw)

    def self_sigterm(seg, st):
        if seg == 2:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.05)                 # let the Python-level handler run

    with PreemptionHandler(signals=(signal.SIGTERM,)) as handler:
        with pytest.raises(PreemptedError):
            trb.segmented_padded_solve_batched(batch["qt"], batch["seeds"],
                                               checkpoint=str(tmp_path), preempt=handler,
                                               on_segment=self_sigterm, **kw)
    x, s = trb.segmented_padded_solve_batched(batch["qt"], batch["seeds"],
                                              checkpoint=str(tmp_path), **kw)
    assert s["resumed"]
    _assert_bitwise(x, s, x_ref, s_ref)


def test_reference_checkpoint_resumes_in_port(batch, tmp_path):
    """The reference checkpoints a Gaussian solve at segment 2 and raises;
    the port, handed its seeds, resumes that checkpoint and finishes with the
    reference's statuses and m_final, x to the tolerance
    ``test_torch_segmented.py`` holds the split to (rtol 1e-4)."""
    kw = dict(m_max=M_MAX, method="pcg", tol=1e-10, segment_trips=4)
    xj, sj = jrb.segmented_padded_solve_batched(batch["qj"], batch["keys"], **kw)
    flag = _Flag()
    with pytest.raises(JPreemptedError):
        jrb.segmented_padded_solve_batched(batch["qj"], batch["keys"],
                                           checkpoint=str(tmp_path), preempt=flag,
                                           on_segment=_trip_wire(flag, 2), **kw)
    assert JCheckpointManager(tmp_path).latest_step() == 2
    x, s = trb.segmented_padded_solve_batched(batch["qt"], batch["seeds"],
                                              checkpoint=str(tmp_path), device="cpu", **kw)
    assert s["resumed"]
    for k in ("status", "m_final"):
        np.testing.assert_array_equal(s[k].numpy(), np.asarray(sj[k]), err_msg=k)
    xj = np.asarray(xj)
    np.testing.assert_allclose(x.numpy(), xj, rtol=1e-4, atol=1e-4 * np.abs(xj).max())


# -- the service -------------------------------------------------------------------

CLASSES = [(256, 32, 64), (1024, 64, 128)]


def _requests(count, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n, d = int(rng.integers(100, 900)), int(rng.integers(8, 60))
        out.append(((rng.standard_normal((n, d)) / np.sqrt(n)).astype(np.float32),
                    rng.standard_normal(n).astype(np.float32), float(rng.uniform(0.05, 0.5))))
    return out


def test_chunk_checkpoint_tag_matches_reference(tmp_path):
    """The same class and request ids name the same ``chunk_<tag>``
    directory in both packages."""
    ref = jsvc.SolverService([jsvc.ShapeClass(*c) for c in CLASSES],
                             checkpoint_dir=tmp_path / "j")
    port = tsvc.SolverService([tsvc.ShapeClass(*c) for c in CLASSES],
                              checkpoint_dir=tmp_path / "t", device="cpu")
    for ids in ([0], [3, 4, 5, 9], list(range(16))):
        for c in CLASSES:
            reqs = [tsvc.RidgeRequest(i, None, None, 0.1) for i in ids]
            a = ref._chunk_checkpoint(jsvc.ShapeClass(*c), reqs).dir.name
            b = port._chunk_checkpoint(tsvc.ShapeClass(*c), reqs).dir.name
            assert a == b and b.startswith("chunk_")
    assert tsvc.SolverService(device="cpu")._chunk_checkpoint(
        tsvc.ShapeClass(*CLASSES[0]), []) is None


class _StopAfterPolls:
    """``should_stop`` turns on at its ``n``-th poll and stays on."""

    def __init__(self, n):
        self.n, self.polls = n, 0

    @property
    def should_stop(self):
        self.polls += 1
        return self.polls >= self.n


def test_preempted_service_flush_resumes_bitwise(tmp_path):
    """A flush preempted in its second chunk raises PreemptedError with the
    chunk committed; a new service with the same seed and the same
    submissions resumes the committed chunks and answers bitwise as an
    uninterrupted checkpointing service does."""
    reqs = _requests(7)
    kw = dict(shape_classes=[tsvc.ShapeClass(*c) for c in CLASSES], batch_size=4,
              seed=5, segment_trips=4, device="cpu")

    def serve(**extra):
        svc = tsvc.SolverService(**kw, **extra)
        ids = [svc.submit(*r) for r in reqs]
        return svc, ids, svc.flush

    svc, ids, flush = serve(checkpoint_dir=tmp_path / "ref")
    ref = flush()
    assert svc.stats["resumed_chunks"] == 0 and svc.stats["segments"] > 0
    chunks = sorted(p.name for p in (tmp_path / "ref").iterdir())
    svc, _, flush = serve(checkpoint_dir=tmp_path / "run", preempt=_StopAfterPolls(12))
    with pytest.raises(PreemptedError) as ei:
        flush()
    committed = [p for p in (tmp_path / "run").iterdir()
                 if CheckpointManager(p).latest_step() is not None]
    assert committed and Path(ei.value.checkpoint_dir).parent == tmp_path / "run"
    svc, ids2, flush = serve(checkpoint_dir=tmp_path / "run")
    got = flush()
    assert ids2 == ids and svc.stats["resumed_chunks"] >= 1
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == chunks
    for i in ids:
        a, b = got[i], ref[i]
        assert torch.equal(a.x, b.x), i
        assert (a.delta_tilde, a.m_final, a.iters, a.doublings, a.status) == \
            (b.delta_tilde, b.m_final, b.iters, b.doublings, b.status), i


def test_service_without_checkpoint_or_budget_stays_monolithic():
    """With no budget, checkpoint directory or preemption flag the ridge
    chunk takes the monolithic path: no segments, nothing resumed."""
    svc = tsvc.SolverService([tsvc.ShapeClass(*c) for c in CLASSES], batch_size=4,
                             device="cpu")
    rid = svc.submit(*_requests(1)[0])
    assert svc.flush()[rid].status == "OK"
    assert svc.stats["segments"] == 0 and svc.stats["resumed_chunks"] == 0


# -- processes ---------------------------------------------------------------------

_CHILD_SOLVE = textwrap.dedent("""
    import hashlib, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.core.quadratic import from_least_squares_batch
    from repro_torch.core.robust import segmented_padded_solve_batched

    rng = np.random.default_rng(0)
    B, n, d = 4, 128, 16
    A = torch.as_tensor((rng.standard_normal((B, n, d)) / np.sqrt(n)).astype(np.float32))
    Y = torch.as_tensor(rng.standard_normal((B, n)).astype(np.float32))
    q = from_least_squares_batch(A, Y, 0.1)

    def mark(seg, st):
        print(f"SEG {seg}", flush=True)

    x, s = segmented_padded_solve_batched(
        q, torch.tensor([7, 8, 9, 10]), m_max=32, method="pcg", tol=1e-10,
        segment_trips=2, checkpoint=sys.argv[1], checkpoint_every=1, on_segment=mark,
        device="cpu")
    print("RESUMED", int(s["resumed"]), flush=True)
    print("SEGMENTS", int(s["segments"]), flush=True)
    print("STATUS", ",".join(str(int(v)) for v in s["status"]), flush=True)
    print("MFINAL", ",".join(str(int(v)) for v in s["m_final"]), flush=True)
    print("XHASH", hashlib.sha1(x.numpy().tobytes()).hexdigest(), flush=True)
""")


def _marks(stdout: str) -> dict:
    out = {}
    for line in stdout.splitlines():
        parts = line.split(None, 1)
        if parts and parts[0] in ("RESUMED", "SEGMENTS", "STATUS", "MFINAL", "XHASH"):
            out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def test_kill9_restart_resumes_bitwise(tmp_path):
    """kill -9 a solve as soon as it reports segment 3 (no handler gets a
    say), restart it, and the resumed run ends bitwise as an uninterrupted
    one: checkpoint_every=1 aligns every segment boundary."""
    ck = str(tmp_path / "ck")
    p = subprocess.Popen([sys.executable, "-u", "-c", _CHILD_SOLVE, ck],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=_env(), cwd=str(ROOT))
    watchdog = threading.Timer(120, p.kill)      # a hung child ends the read
    watchdog.start()
    killed = False
    try:
        for line in p.stdout:
            if line.startswith("SEG 3"):
                p.kill()                        # SIGKILL: nothing cleans up
                killed = True
                break
    finally:
        watchdog.cancel()
        p.kill()
        p.communicate(timeout=60)
    assert killed, "the child never reached segment 3"
    runs = [subprocess.run([sys.executable, "-u", "-c", _CHILD_SOLVE, d],
                           capture_output=True, text=True, env=_env(), cwd=str(ROOT),
                           timeout=120)
            for d in (ck, str(tmp_path / "ref"))]
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]
    resumed, ref = (_marks(r.stdout) for r in runs)
    assert resumed["RESUMED"] == "1" and ref["RESUMED"] == "0"
    assert 0 < int(resumed["SEGMENTS"]) < int(ref["SEGMENTS"])
    assert resumed["STATUS"] == ref["STATUS"] == ",".join([str(int(SolveStatus.OK))] * 4)
    assert resumed["MFINAL"] == ref["MFINAL"]
    assert resumed["XHASH"] == ref["XHASH"]


def test_solve_service_demo_runs_on_cuda_by_default():
    """The demo's default device is the card: with none it raises, and
    ``--device cpu`` runs it (auditing every answer)."""
    from repro_torch.launch import solve_service

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve_service.main(["--requests", "1"])
    assert solve_service.main(["--requests", "2", "--device", "cpu", "--seed", "3"]) == 0


def test_launch_serve_preempt_cycle_on_cpu():
    """``python -m repro_torch.launch.serve --preempt-after`` on the CPU:
    exit 75 after the SIGTERM, then a clean ``--resume`` whose answers are
    all finite and audited."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--preempt-after", "0.2", "--requests", "3", "--device", "cpu"],
                       capture_output=True, text=True, env=_env(), cwd=str(ROOT), timeout=330)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "PREEMPTED at segment" in r.stdout
    assert "ALL_FINITE=1" in r.stdout and "AUDIT_OK=1" in r.stdout
    assert "resumed_chunks=" in r.stdout and "resumed_chunks=0" not in r.stdout
    assert "preemption cycle OK" in r.stdout
