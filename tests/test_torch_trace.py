"""The span recorder (``repro_torch.trace``) and the trip counters: off, a
span is one shared no-op and a flush answers bitwise as it does traced; on,
a flush records the layers' span tree; ``trips_run`` is what the host
dispatched against the ``trips`` the problems needed; spans map onto the
profiler's clock. CPU, but for the one test marked ``cuda``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_trace.py --noconftest
"""

import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.core import adaptive_padded as tap  # noqa: E402
from repro_torch.core import robust as trb  # noqa: E402
from repro_torch.core.quadratic import from_least_squares_batch  # noqa: E402
from repro_torch.serve.solver_service import ShapeClass, SolverService  # noqa: E402

torch.set_num_threads(1)

CLS = ShapeClass(256, 32, 64)
M_MAX = 64


def _requests(seed, k=5, n=(160, 256), d=(17, 32)):
    """k ridge requests A = U·diag(0.8^j)·Vᵀ of random sizes, ν 1e-2..1e-1."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        ni, di = int(rng.integers(*n)), int(rng.integers(*d))
        U, _ = np.linalg.qr(rng.standard_normal((ni, di)))
        V, _ = np.linalg.qr(rng.standard_normal((di, di)))
        A = (U * 0.8 ** np.arange(1, di + 1)) @ V.T
        out.append((torch.as_tensor(A, dtype=torch.float32),
                    torch.as_tensor(rng.standard_normal(ni), dtype=torch.float32),
                    float(10 ** rng.uniform(-2, -1))))
    return out


def _serve(reqs, **kw):
    svc = SolverService([CLS], batch_size=4, seed=7, device="cpu", **kw)
    ids = [svc.submit(A, y, nu) for A, y, nu in reqs]
    return svc, ids, svc.flush()


def _batch(seed, B=4, n=256, d=32, rates=(0.6, 0.8, 0.9, 0.95), nus=(0.3, 0.1, 0.05, 0.02)):
    rng = np.random.default_rng(seed)
    As, Ys = [], []
    for rate in rates[:B]:
        U, _ = np.linalg.qr(rng.standard_normal((n, d)))
        V, _ = np.linalg.qr(rng.standard_normal((d, d)))
        As.append((U * rate ** np.arange(1, d + 1)) @ V.T)
        Ys.append(rng.standard_normal(n))
    q = from_least_squares_batch(torch.as_tensor(np.stack(As), dtype=torch.float32),
                                 torch.as_tensor(np.stack(Ys), dtype=torch.float32),
                                 torch.as_tensor(nus[:B], dtype=torch.float32))
    return q, torch.arange(B, dtype=torch.int64) * 7919 + seed


@pytest.fixture(autouse=True)
def _recording_off():
    trace.take()
    yield
    trace.take()


def test_off_span_is_the_shared_noop_and_records_nothing():
    reqs = _requests(0, k=3)
    assert trace.span("service.flush") is trace.OFF
    assert trace.span("service.submit", req_id=3) is trace.OFF
    with trace.span("engine.loop") as sp:
        sp.set(trips=4)
    _serve(reqs)
    got = trace.take()
    assert got.spans == [] and isinstance(got.epoch_offset_ns, int)


def test_flush_answers_bitwise_traced_or_not():
    reqs = _requests(1)
    svc0, ids0, off = _serve(reqs)
    trace.enable()
    svc1, ids1, on = _serve(reqs)
    assert trace.take().spans
    assert ids0 == ids1
    for rid in ids0:
        a, b = off[rid], on[rid]
        assert torch.equal(a.x, b.x)
        assert (a.delta_tilde, a.m_final, a.iters, a.status) == \
            (b.delta_tilde, b.m_final, b.iters, b.status)
    assert svc0.stats == svc1.stats


# each span's parent, as §2 of the layers puts them on the monolithic path
PARENT = {
    "service.submit": None, "service.flush": None,
    "service.chunk": "service.flush", "service.pack": "service.chunk",
    "robust.attempt": "service.chunk", "robust.to_host": "service.chunk",
    "service.answers": "service.chunk",
    "engine.prepare": "robust.attempt", "ladder.sketch": "engine.prepare",
    "ladder.factor": "engine.prepare", "engine.true_gram": "engine.prepare",
    "engine.loop": "robust.attempt", "engine.host_read": "engine.loop",
    "engine.finalize": "robust.attempt",
}


def test_flush_records_the_span_tree():
    reqs = _requests(2, k=6)          # two chunks of the batch of 4
    trace.enable()
    svc, ids, sols = _serve(reqs)
    spans = trace.take().spans
    by_id = {s.id: s for s in spans}
    assert {s.name for s in spans} == set(PARENT)     # no device: no service.sync
    for s in spans:
        parent = by_id.get(s.parent_id)
        assert (parent.name if parent else None) == PARENT[s.name], s
        if parent is not None:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    submits = [s for s in spans if s.name == "service.submit"]
    assert [s.attrs["req_id"] for s in submits] == ids
    chunks = [s for s in spans if s.name == "service.chunk"]
    assert len(chunks) == 2 and all(c.attrs["cls"] == CLS for c in chunks)
    assert sorted(r for c in chunks for r in c.attrs["req_ids"]) == ids
    assert all(max(s.end_ns for s in submits) <= c.start_ns for c in chunks)
    loops = [s for s in spans if s.name == "engine.loop"]
    attempts = [s for s in spans if s.name == "robust.attempt"]
    assert [a.attrs["attempt"] for a in attempts] == [0, 0]
    assert sum(s.attrs["trips"] for s in loops) == svc.stats["trips_run"] > 0


@pytest.mark.parametrize("max_iters", [100, 6])       # 6: the trip cap binds
def test_trips_run_monolithic(max_iters):
    q, seeds = _batch(3)
    _, st = tap.padded_adaptive_solve_batched(q, seeds, m_max=M_MAX, method="pcg",
                                              max_iters=max_iters, device="cpu")
    cap, need = tap.padded_trip_cap(M_MAX, max_iters), int(st["trips"])
    assert isinstance(st["trips_run"], int)
    assert st["trips_run"] == min(cap, tap.CHECK_TRIPS * math.ceil(need / tap.CHECK_TRIPS))


@pytest.mark.parametrize("max_iters", [100, 6])
def test_trips_run_segmented(max_iters):
    q, seeds = _batch(4)
    _, st = trb.segmented_padded_solve_batched(q, seeds, m_max=M_MAX, method="pcg",
                                               max_iters=max_iters, segment_trips=4,
                                               device="cpu")
    cap, need = tap.padded_trip_cap(M_MAX, max_iters), int(st["trips"])
    assert st["trips_run"] == min(cap, 4 * math.ceil(need / 4))
    assert st["segments"] == math.ceil(st["trips_run"] / 4)


def test_forced_retry_adds_to_both_counters():
    """max_iters = 6 stalls the ill-conditioned slots; one retry redraws
    their sketches and runs a second attempt, whose trips both counters add."""
    reqs = _requests(5, k=4, n=(200, 256), d=(28, 32))
    s0, _, _ = _serve(reqs, max_iters=6, max_retries=0, fallback=False)
    s1, _, sols = _serve(reqs, max_iters=6, max_retries=1, fallback=False)
    assert s0.stats["retries"] == 0 < s1.stats["retries"]
    run = s1.stats["trips_run"] - s0.stats["trips_run"]
    need = s1.stats["trips_needed"] - s0.stats["trips_needed"]
    assert 0 < need <= run == min(tap.padded_trip_cap(CLS.m_max, 6),
                                  tap.CHECK_TRIPS * math.ceil(need / tap.CHECK_TRIPS))
    assert s0.stats["trips_needed"] <= s0.stats["trips_run"]


def test_span_maps_onto_the_profiler_clock():
    """A record_function event opened inside a span lies inside the span
    mapped through ``epoch_offset_ns`` (1 ms of room on either side)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            time.sleep(1e-3)
            with record_function("inside"):
                torch.ones(64).sum()
            time.sleep(1e-3)
    got = trace.take()
    (sp,) = got.spans
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inside"]
    lo, hi = sp.start_ns + got.epoch_offset_ns, sp.end_ns + got.epoch_offset_ns
    assert lo < ev.start_ns() and ev.start_ns() + ev.duration_ns() < hi


def test_a_span_closing_after_take_is_not_kept():
    trace.enable()
    with trace.span("a"):
        with trace.span("b"):
            pass
        first = trace.take()
    assert [s.name for s in first.spans] == ["b"]
    assert trace.take().spans == []


@pytest.mark.cuda
def test_kernel_starts_on_the_device_within_5ms_of_its_span():
    """On the card: a kernel launched inside a span starts on the device
    after the span's start mapped onto the CUPTI clock, and within 5 ms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUPTI's clock is the card's")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    x = torch.randn(1 << 20, device=dev)
    for _ in range(3):                                 # warm: no lazy set-up in the span
        torch.mul(x, 2.0)
    torch.cuda.synchronize(dev)
    trace.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.span("launch"):
            torch.mul(x, 3.0)
        torch.cuda.synchronize(dev)
    got = trace.take()
    (sp,) = got.spans
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    assert kernels
    start = min(e.start_ns() for e in kernels)
    lo = sp.start_ns + got.epoch_offset_ns
    assert lo <= start <= lo + 5_000_000, (start - lo)
