"""The device's idle time put down to the program's spans
(``bench/attribution.py``) and the readers of the span metrics, on
synthetic intervals; then once on the CPU around a real flush."""

import random

import pytest
import torch

from bench import attribution, check, manifest
from bench.harness import Context
from bench.trace import DeviceTrace, TraceSummary, summarize, union_seconds
from repro_torch import trace as ptrace
from repro_torch.trace import Span

OFFSET = 1_000_000_000_000        # the epoch offset of the synthetic spans


def sp(i, parent, name, start, end, **attrs):
    return Span(i, parent, name, start, end, attrs)


def slice_of(spans, busy, lo=0, hi=1000):
    """Spans given on the epoch clock, recorded on a clock OFFSET behind it."""
    spans = [s._replace(start_ns=s.start_ns - OFFSET, end_ns=s.end_ns - OFFSET) for s in spans]
    return attribution.SpanSlice(spans, OFFSET, busy, lo, hi)


def test_idle_goes_to_the_innermost_span():
    spans = [sp(1, None, "service.flush", 0, 900), sp(2, 1, "robust.attempt", 100, 800),
             sp(3, 2, "engine.loop", 200, 600), sp(4, 3, "engine.host_read", 300, 400)]
    # the device idles before 50, in [310, 390], [650, 700] and after 950
    s = slice_of(spans, [(50, 310), (390, 650), (700, 950)])
    assert s.idle_self_ns("engine.host_read") == 80
    assert s.idle_self_ns("robust.attempt") == 50 and s.idle_self_ns("service.flush") == 50
    assert s.idle_self_ns("engine.loop") == 0 and s.idle_self_ns(None) == 50
    assert s.idle_in_ns("engine.loop") == 80 and s.idle_in_ns("robust.attempt") == 130
    assert s.idle_in_ns("service.flush") == 180
    assert s.host_ns("engine.loop") == 400 and s.self_ns("engine.loop") == 300


def test_a_gap_across_two_spans_is_split_by_time():
    spans = [sp(1, None, "service.submit", 0, 50), sp(2, None, "service.submit", 50, 100),
             sp(3, None, "service.flush", 120, 200)]
    s = slice_of(spans, [(0, 40), (170, 200)], hi=200)
    assert s.idle_by_id == {1: 10, 2: 50, None: 20, 3: 50}
    assert s.idle_self_ns("service.submit") == 60 and s.idle_in_ns("service.submit") == 60


def _random_slice(seed):
    """Nested spans of a few flushes and a few hundred device intervals,
    some overlapping, some past the slice's ends."""
    rng = random.Random(seed)
    spans, ids, t = [], iter(range(1, 10 ** 6)), 0
    for _ in range(6):
        fid = next(ids)
        f0 = t + rng.randint(0, 50)
        t = f0
        for name in ("service.submit", "service.chunk"):
            cid = next(ids)
            c0 = t + rng.randint(0, 20)
            k0 = c0 + rng.randint(1, 30)
            k1 = k0 + rng.randint(1, 400)
            spans.append(sp(next(ids), cid, "engine.loop", k0, k1, trips=rng.randint(1, 64)))
            t = k1 + rng.randint(1, 30)
            spans.append(sp(cid, fid, name, c0, t))
        spans.append(sp(fid, None, "service.flush", f0, t + 5))
        t += 5
    hi = t + 40
    busy = []
    for _ in range(300):
        s = rng.randint(-50, hi + 50)
        busy.append((s, s + rng.randint(1, 25)))
    return spans, busy, hi


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shares_and_outside_sum_to_the_idle_share(seed):
    spans, busy, hi = _random_slice(seed)
    s = slice_of(spans, busy, lo=0, hi=hi)
    clipped = [(max(a, 0) * 1e-9, min(b, hi) * 1e-9) for a, b in busy if b > 0 and a < hi]
    summary = TraceSummary(window_s=hi * 1e-9, busy_s=union_seconds(clipped), kernels={},
                           device_ops=[], idle_gaps=[])
    idle_share = manifest.reader("device.idle_share.service")(ctx(summary))
    total = sum(s.share(s.idle_self_ns(n)) for n in s.names()) + s.share(s.idle_self_ns(None))
    assert total == pytest.approx(idle_share, abs=1e-9)
    last = s.table(idle_share)[-1]
    assert last.endswith(f"; device.idle_share: {idle_share}")
    assert float(last.split(": ")[1].split(";")[0]) == pytest.approx(idle_share, abs=1e-9)


def ctx(summary=None, counters=None):
    verdict = check.Verdict(numbers={}, correct=True, passed=[True])
    return Context(setup_s=3.0, window_s=2.0,
                   records={"latencies_s": [0.1, 0.2], "submit_s": [0.01], "wait_s": [0.02],
                            "fill": [64], "iters": [25], "m_final": [512],
                            "gaussian_sa_shape": (64, 4096, 256, 512)},
                   answers=[check.Answer(0, torch.zeros(1), True, True)], verdict=verdict,
                   counters=counters or {"retries": 1, "batches": 4},
                   window_peak_bytes=2 ** 30, trace=summary)


NEW = ("engine.trip_host_us", "engine.prepare_ms", "service.pack_ms", "service.submit_span_ms",
       "device.idle_in_loop.service", "device.idle_in_loop.poisson",
       "device.idle_in_submit.service", "device.idle_outside.service")


def test_existing_metrics_read_alike_with_and_without_spans():
    summary = TraceSummary(window_s=2.0, busy_s=0.5, device_ops=[], idle_gaps=[],
                           kernels={"gaussian_sa_f32": [2e-3, 2e-3]})
    spans, busy, hi = _random_slice(0)
    plain, traced = ctx(summary), ctx(summary)
    traced.spans = slice_of(spans, busy, hi=hi)
    accepted = [m["name"] for m in manifest.load()["end_to_end"] + manifest.load()["per_layer"]]
    for name in accepted:
        assert manifest.reader(name)(plain) == manifest.reader(name)(traced), name
    for name in NEW:
        assert manifest.reader(name)(plain) is None, name
        assert manifest.reader(name)(traced) is not None, name


def test_span_readers():
    spans = [
        sp(1, None, "service.submit", 0, 4_000_000, req_id=0),
        sp(2, None, "service.submit", 4_000_000, 10_000_000, req_id=1),
        sp(3, None, "service.flush", 10_000_000, 90_000_000),
        sp(4, 3, "service.chunk", 10_000_000, 90_000_000, req_ids=[0, 1]),
        sp(5, 4, "service.pack", 10_000_000, 16_000_000),
        sp(6, 4, "robust.attempt", 16_000_000, 80_000_000, attempt=0),
        sp(7, 6, "engine.prepare", 16_000_000, 24_000_000),
        sp(8, 6, "engine.loop", 24_000_000, 74_000_000, trips=32),
        sp(9, 8, "engine.host_read", 24_000_000, 26_000_000),
        sp(10, 8, "engine.host_read", 70_000_000, 74_000_000),
    ]
    # the device works from 20 to 30 ms and from 60 to 80 ms of a 100 ms slice
    c = ctx(counters={"retries": 0, "batches": 1, "trips_run": 64, "trips_needed": 40})
    c.spans = slice_of(spans, [(20_000_000, 30_000_000), (60_000_000, 80_000_000)],
                       hi=100_000_000)
    read = {n: manifest.reader(n)(c) for n in NEW + ("engine.noop_trip_share",)}
    assert read["engine.noop_trip_share"] == pytest.approx(1 - 40 / 64)
    assert read["engine.trip_host_us"] == pytest.approx((50 - 6) * 1e3 / 32)
    assert read["engine.prepare_ms"] == pytest.approx(8.0)
    assert read["service.pack_ms"] == pytest.approx(6.0)
    assert read["service.submit_span_ms"] == pytest.approx(10.0)
    # idle: [0, 20) submit 10, pack 6, prepare 4; [30, 60) loop; [80, 100) attempt, chunk, out
    assert read["device.idle_in_loop.service"] == pytest.approx(0.30)
    assert read["device.idle_in_loop.poisson"] == pytest.approx(0.30)
    assert read["device.idle_in_submit.service"] == pytest.approx(0.10)
    assert read["device.idle_outside.service"] == pytest.approx(0.10)
    assert c.spans.idle_in_ns("service.flush") == 50_000_000


def test_noop_trip_share_is_silent_without_the_counter():
    assert manifest.reader("engine.noop_trip_share")(ctx()) is None


def test_from_trace_around_a_flush_on_the_cpu():
    """The harness's traced slice, with the program's spans recorded around
    it: one flush's spans, and (the CPU's ops standing for the device's)
    the idle shares and outside summing to the slice's idle share."""
    from conftest import small_cell

    cell = small_cell("ridge_service_b64.wide4k")
    run = manifest.entry(cell.entry, cell.root).setup(cell, 3, torch.device("cpu"))
    run.step(record=False)
    ptrace.enable()
    with DeviceTrace("cpu") as tr:
        run.step()
    s = attribution.from_trace(tr, ptrace.take())
    assert s.count("service.flush") == 1 and s.count("service.submit") == 4
    summary = summarize(tr)
    total = sum(s.share(s.idle_self_ns(n)) for n in s.names()) + s.share(s.idle_self_ns(None))
    assert total == pytest.approx(1 - summary.busy_s / summary.window_s, abs=1e-3)
    assert any(line.startswith("span engine.loop: 1 ") for line in s.table())
