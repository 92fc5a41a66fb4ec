"""The metric arithmetic: a rate over the whole window, a tail over every
request, and the device's idle share as a union of intervals."""

import numpy as np
import pytest
import torch

from bench import check, manifest, readers, trace
from bench.harness import Context
from bench.trace import TraceSummary


def ctx(records=None, answers=(), passed=(), window_s=2.0, trace_summary=None, peak=0):
    verdict = check.Verdict(numbers={}, correct=True, passed=list(passed))
    return Context(setup_s=3.5, window_s=window_s, records=records or {},
                   answers=list(answers), verdict=verdict, counters={"retries": 3, "batches": 6},
                   window_peak_bytes=peak, trace=trace_summary)


def ans(certified=True, window=True):
    return check.Answer(0, torch.zeros(1), certified, window)


def test_rate_counts_certified_correct_answers_of_the_whole_window():
    answers = [ans(), ans(), ans(certified=False), ans(), ans(window=False), ans()]
    passed = [True, True, True, False, True, True]
    # 3 answers certified, right and in the window, over the whole 2.0 s
    assert manifest.reader("solved_rps")(ctx(answers=answers, passed=passed)) == 1.5


def test_p95_is_over_every_request_not_per_flush():
    # two flushes: 19 fast requests and one slow one in each
    lat = [0.1] * 19 + [1.0] + [0.1] * 19 + [1.0]
    got = manifest.reader("request_p95_ms")(ctx({"latencies_s": lat}))
    assert got == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert got == pytest.approx(145.0)        # a median of per-flush p95s would say 955


@pytest.mark.parametrize("values", [[3.0], [5, 1, 4, 2], list(np.random.default_rng(0).random(101))])
@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_is_numpys(values, q):
    assert readers.percentile(values, q) == pytest.approx(np.percentile(values, q))


def test_union_counts_overlapping_kernels_once():
    # two kernels overlap in [1, 2]; a third stands alone
    assert trace.union_seconds([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]) == 4.0
    assert trace.union_seconds([(0.0, 4.0), (1.0, 2.0)]) == 4.0


def test_idle_share_from_the_union():
    busy = trace.union_seconds([(0.0, 1.0), (0.5, 1.5), (3.0, 3.5)])
    s = TraceSummary(window_s=4.0, busy_s=busy, kernels={}, device_ops=[], idle_gaps=[])
    for name in ("device.idle_share.service", "device.idle_share.poisson"):
        assert manifest.reader(name)(ctx(trace_summary=s)) == 0.5
    assert manifest.reader("device.idle_share.service")(ctx()) is None


def test_idle_gaps_are_named_by_the_op_that_ends_them():
    ev = [(0.0, 1.0, "gemv"), (0.5, 2.0, "bmm"), (2.5, 3.0, "potrf"), (4.0, 4.5, "gemv"),
          (5.0, 6.0, "potrf")]
    assert trace.idle_before(ev) == {"before potrf": 1.0, "before gemv": 1.0}


def test_roofline_share_is_the_bound_over_the_mean_launch():
    bound = 2 * 64 * 512 * 4096 * 256 / 67e12
    s = TraceSummary(window_s=1.0, busy_s=0.5, kernels={
        "(anonymous namespace)::gaussian_sa_f32(float const*, ...)": [2 * bound, 2 * bound],
        "other": [1.0]}, device_ops=[], idle_gaps=[])
    read = manifest.reader("gaussian_sa_roofline")
    assert read(ctx({"gaussian_sa_shape": (64, 4096, 256, 512)}, trace_summary=s)) == \
        pytest.approx(50.0)
    assert read(ctx({"gaussian_sa_shape": None}, trace_summary=s)) is None


def test_counters_and_means():
    c = ctx({"iters": [10, 20], "m_final": [256, 512], "submit_s": [0.01, 0.03]},
            peak=3 * 2 ** 30)
    assert manifest.reader("robust.retries_per_batch")(c) == 0.5
    assert manifest.reader("engine.iters_mean")(c) == 15
    assert manifest.reader("ladder.m_final_mean")(c) == 384
    assert manifest.reader("service.submit_ms")(c) == pytest.approx(20.0)
    assert manifest.reader("device.peak_gib.service")(c) == 3.0
    assert manifest.reader("setup_s")(c) == 3.5


def test_open_loop_readers():
    c = ctx({"fill": [64, 48, 50], "wait_s": [0.01, 0.03]})
    assert manifest.reader("service.fill.poisson")(c) == pytest.approx(54.0)
    assert manifest.reader("service.wait_ms.poisson")(c) == pytest.approx(20.0)
