"""The audit's op recorder (``analysis.audit.op_trace``), the memory scans,
and the two plain-version repairs the one-touch rule asked for.

* The plain Gaussian generates S one (B, m, 256) micro-tile at a time, as
  the reference's ``gaussian_sa_ref`` does: its largest new tensor at the
  audit shapes (3, 2000, 16, 128) is within rule (c)'s 786,432 B, and its
  result is bitwise what the chunk-tile version gave.
* ``prefix_level_grams`` and the SJLT ladder write each level into one
  (L, B, d, d) stack, so the stack exists once; the Grams are bitwise the
  list-then-stack version's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import collectives, memscan  # noqa: E402
from repro_torch.analysis.audit import op_trace as ot  # noqa: E402
from repro_torch.analysis.audit.entrypoints import B, D, M_MAX, N, problem  # noqa: E402
from repro_torch.analysis.audit.rules import gaussian_budget  # noqa: E402
from repro_torch.core.adaptive_padded import (  # noqa: E402
    doubling_ladder,
    padded_adaptive_solve_batched,
)
from repro_torch.core.level_grams import get_provider, prefix_level_grams  # noqa: E402
from repro_torch.kernels import gaussian_gram as tg  # noqa: E402
from repro_torch.kernels.precision import contract_dtype, round_to  # noqa: E402


def _chunk_tile_sa(A, seeds, m, chunk_cols, scale, compute_dtype):
    """The plain Gaussian before the repair: a whole (B, m, chunk) S tile
    per chunk, reduced in 256-column micro-tiles."""
    n, d = A.shape[-2], A.shape[-1]
    ct = contract_dtype(compute_dtype)
    k = min(max(1, -(-chunk_cols // 256)), -(-n // 256))
    chunk = k * 256
    pad = (-n) % chunk
    if pad:
        A = torch.nn.functional.pad(A, (0, 0, 0, pad))
        if scale is not None:
            scale = torch.nn.functional.pad(scale, (0, pad))
    acc = torch.zeros((seeds.shape[0], m, d))
    for c0 in range(0, n + pad, chunk):
        S = tg.gaussian_tile(seeds, 0, c0, (m, chunk))
        if scale is not None:
            S = S * scale[:, None, c0:c0 + chunk]
        S = round_to(S, ct)
        for i in range(k):
            a_mu = round_to(A[..., c0 + i * 256:c0 + (i + 1) * 256, :], ct)
            acc = acc + torch.matmul(S[:, :, i * 256:(i + 1) * 256], a_mu)
    return acc


@pytest.mark.parametrize("chunk_cols", [256, 512, 2048])
@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shared,scaled", [(False, False), (True, False), (False, True)])
def test_plain_gaussian_per_micro_tile_is_bitwise_the_chunk_tile(chunk_cols, compute_dtype,
                                                                  shared, scaled):
    rng = np.random.default_rng(chunk_cols)
    n, d, m = 1300, 7, 40
    A = torch.as_tensor(rng.standard_normal((n, d) if shared else (2, n, d)), dtype=torch.float32)
    seeds = torch.as_tensor(rng.integers(0, 2 ** 32, 2), dtype=torch.int64)
    scale = torch.as_tensor(rng.random((2, n)) + 0.5, dtype=torch.float32) if scaled else None
    got = tg.gaussian_sa_ref(A, seeds, m, chunk_cols=chunk_cols, scale=scale,
                             compute_dtype=compute_dtype)
    assert torch.equal(got, _chunk_tile_sa(A, seeds, m, chunk_cols, scale, compute_dtype))


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16", "int8"])
def test_plain_gaussian_largest_new_tensor_within_budget(compute_dtype):
    """At the audit shapes the int64 hash words of one micro-tile,
    8·3·128·256 = 786,432 B, are the largest new tensor: exactly rule (c)'s
    budget, 2·4·max(3·128·256, 3·2048·16, 8·3·16², 3·128·16)."""
    q, seeds = problem("cpu")
    budget = gaussian_budget(B, N, D, M_MAX)
    assert budget == 786_432
    trace = ot.record(lambda: tg.gaussian_sa_ref(q.A, seeds, M_MAX, compute_dtype=compute_dtype),
                      watch=[q.A])
    peak, shape, site = ot.max_new_tensor_bytes(trace)
    assert peak <= budget, (peak, shape, site)
    assert peak == 786_432 and shape == (B, M_MAX, 256)


@pytest.mark.parametrize("family", ["gaussian", "sjlt", "srht"])
def test_ladder_stack_made_once_and_bitwise(family):
    q, seeds = problem("cpu")
    prov = get_provider(family)
    ladder = doubling_ladder(M_MAX)
    trace = ot.record(lambda: prov.level_grams(prov.sample(seeds, M_MAX, N), q, ladder))
    grams = trace.result
    stacks = ot.find_new_tensors(trace, lambda shp, dt: shp == (len(ladder), B, D, D))
    assert len(stacks) == 1, [s.op for s in stacks]
    if family != "sjlt":
        # the list-then-stack version of prefix_level_grams
        R = torch.randn((B, M_MAX, D), generator=torch.Generator().manual_seed(3))
        acc, old, prev = torch.zeros((B, D, D)), [], 0
        for m in ladder:
            acc = acc + torch.bmm(R[:, prev:m].transpose(1, 2), R[:, prev:m])
            old.append(acc / m)
            prev = m
        assert torch.equal(prefix_level_grams(R, ladder, inv_m_scale=True), torch.stack(old))
    assert grams.shape == (len(ladder), B, D, D) and torch.isfinite(grams).all()


def test_views_and_in_place_ops_are_not_new_storage():
    x = torch.randn(4, 5)

    def fn():
        v = x.T                       # view
        x.add_(1.0)                   # in place
        c = v.contiguous()            # a copy
        return (x @ torch.ones(5)).sum() + c.sum()

    trace = ot.record(fn, watch=[x])
    by_op = {}
    for s in trace.sites:
        by_op.setdefault(s.base, []).append(s)
    assert not any(any(s.new) for s in by_op["aten.permute"] + by_op["aten.add_"])
    assert any(any(s.new) for s in by_op["aten.clone"])
    # the view reads A's storage but is no consumer; the in-place add, the
    # copy and the matvec are
    assert ot.count_a_consumers(trace) == 3
    assert all(s.provenance == "" or s.provenance.startswith("<outside")
               for s in trace.sites)


def test_engine_trips_and_carries_are_marked():
    q, seeds = problem("cpu")
    trace = ot.record(lambda: padded_adaptive_solve_batched(
        q, seeds, m_max=M_MAX, method="pcg", device="cpu"), watch=[q.A])
    # the loop's Python trips include the no-op tail after the batch is done
    assert trace.trips >= int(trace.result[1]["trips"]) > 0
    assert any(s.in_trip for s in trace.sites) and not trace.sites[0].in_trip
    labels = [c[0] for c in trace.carries]
    assert labels == ["segment in", "segment out"]
    assert all(dt in (torch.float32, torch.int64, torch.bool)
               for _, fields, _ in trace.carries for dt in fields.values())
    assert trace.carries[0][2].startswith("src/repro_torch/core/adaptive_padded.py:")
    assert collectives.collective_count(trace) == 0 == collectives.collective_bytes(trace)


def test_collective_payload_bytes():
    """The collective term's bytes: each ``c10d`` site's tensor inputs."""
    stack = (8, 3, 16, 16)
    site = ot.OpSite(op="c10d.allreduce_.default", base="c10d.allreduce_",
                     in_shapes=(stack,), in_dtypes=(torch.float32,), out_shapes=(stack,),
                     out_dtypes=(torch.float32,), new=(False,))
    other = ot.OpSite(op="aten.mm.default", base="aten.mm", in_shapes=((4, 4), (4, 4)),
                      in_dtypes=(torch.float32,) * 2, out_shapes=((4, 4),),
                      out_dtypes=(torch.float32,), new=(True,))
    trace = ot.OpTrace(sites=[site, other, site], launches={}, body_launches={})
    assert collectives.collective_sites(trace) == [site, site]
    assert collectives.collective_bytes(trace) == 2 * 8 * 3 * 16 * 16 * 4


def test_peak_bytes_above_entry_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        memscan.peak_bytes_above_entry(lambda: torch.zeros(3), "cpu")


@pytest.mark.parametrize("m,n", [(16, 300), (64, 4096), (5, 129), (7, 1)])
def test_dense_s_is_bitwise_the_one_call_s(m, n):
    """``gaussian_s_dense`` fills S in column blocks: the entries are
    counter hashes, so S is bitwise one ``gaussian_tile`` call's."""
    seeds = torch.tensor([3, 2 ** 31 + 7, 4000000000], dtype=torch.int64)
    assert torch.equal(tg.gaussian_s_dense(seeds, m, n), tg.gaussian_tile(seeds, 0, 0, (m, n)))


def test_live_bytes_count_what_is_alive_at_once():
    x = torch.zeros(1000)              # made before the trace: not counted

    def fn():
        a = x + 1.0                    # 4000 B
        b = a * 2.0                    # 8000 B alive
        del a
        c = b + 3.0                    # a freed: 8000 B again
        return c.sum()

    trace = ot.record(fn)
    assert trace.peak_live_bytes == 8000 + 4


@pytest.mark.parametrize("alias", ["slice", "detach", "transpose"])
def test_live_bytes_follow_the_storage_through_a_view(alias):
    """A temporary whose only survivor is a view stays counted until the
    view dies: the storage, not the first tensor that held it, is freed (a
    detached alias keeps no reference to that tensor)."""
    x = torch.zeros(1000)              # made before the trace: not counted
    take = {"slice": lambda a: a[:10], "detach": lambda a: a.detach()[:10],
            "transpose": lambda a: a.view(10, 100).T[0]}[alias]

    def fn():
        a = x + 1.0                    # 4000 B
        v = take(a)                    # an alias of 10 elements: the same storage
        del a
        b = v * 2.0                    # 40 B; a's storage still alive through v
        del v
        c = b + 1.0                    # now freed: 40 + 40 B
        return c

    trace = ot.record(fn)
    assert trace.peak_live_bytes == 4000 + 40


DENSE_CASE = (2, 4096, 32, 64)          # (B, n, d, m_max): the top class's n and d/m


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("weighted", [False, True])
def test_dense_pass_live_set_within_a_quarter_of_s_and_sa(weighted, compute_dtype):
    """The ``gaussian_dense`` pass holds at most 1.25 × (dense S + SA) bytes
    of its own tensors at once, plus in bf16 and int8 one A-sized fp32 copy
    (4·B·n·d; the gates ``chip_smoke.py`` phase 9 holds it to on the card);
    building S in one call held over twice S, and rounding A whole held an
    A-sized bf16 copy beside the fp32 one."""
    Bc, n, d, m = DENSE_CASE
    q, seeds = problem("cpu", b=Bc, n=n, d=d)
    w = torch.rand((Bc, n), generator=torch.Generator().manual_seed(2)) + 0.5
    prov = get_provider("gaussian_dense")
    S, SA = 4 * Bc * m * n, 4 * Bc * m * d
    gate = 1.25 * (S + SA) + (0 if compute_dtype == "fp32" else 4 * Bc * n * d)
    trace = ot.record(lambda: prov.level_grams(prov.sample(seeds, m, n), q,
                                               doubling_ladder(m),
                                               row_weights=w if weighted else None,
                                               compute_dtype=compute_dtype),
                      watch=[q.A])
    assert trace.peak_live_bytes <= gate, trace.peak_live_bytes / gate
    one_call = ot.record(lambda: tg.gaussian_tile(seeds, 0, 0, (m, n)))
    assert one_call.peak_live_bytes > 2 * S


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("weighted", [False, True])
def test_dense_pass_in_place_is_bitwise_the_out_of_place_pass(compute_dtype, weighted):
    """Scaling and rounding S in place, a block at a time, gives the bits of
    the whole-S formula the dense pass used before."""
    from repro_torch.kernels.precision import contract_dtype, round_to

    Bc, n, d, m = 2, 700, 6, 16
    q, seeds = problem("cpu", b=Bc, n=n, d=d)
    w = torch.rand((Bc, n), generator=torch.Generator().manual_seed(4)) + 0.5
    prov = get_provider("gaussian_dense")
    ladder = doubling_ladder(m)
    got = prov.level_grams(prov.sample(seeds, m, n), q, ladder,
                           row_weights=w if weighted else None, compute_dtype=compute_dtype)
    A, scale = tg.resolve_stream(q.A, Bc, w if weighted else None, compute_dtype)
    S = tg.gaussian_tile(seeds, 0, 0, (m, n))
    if scale is not None:
        S = S * scale[:, None, :]
    ct = contract_dtype(compute_dtype)
    want = prefix_level_grams(torch.matmul(round_to(S, ct), round_to(A, ct)), ladder,
                              inv_m_scale=True)
    assert torch.equal(got, want)


def test_device_time_counts_each_kernel_once():
    """``launch.breakdown``'s device time sums the device-side events only.
    An op's event carries the device time of the kernels it launched as
    well, so the sum over every ``key_averages()`` row that phases 10 and
    11 of chip_smoke.py took before counted each kernel twice."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import FunctionEvent

    from repro_torch.launch.breakdown import device_totals, on_device

    op = FunctionEvent(id=1, name="aten::mm", thread=0, start_us=0, end_us=10,
                       device_type=DeviceType.CPU, use_device="cuda")
    op.append_kernel("gemm", 0, 5)
    kernel = FunctionEvent(id=2, name="gemm", thread=0, start_us=2, end_us=7,
                           device_type=DeviceType.CUDA, use_device="cuda")
    copy = FunctionEvent(id=3, name="Memcpy HtoD", thread=0, start_us=8, end_us=9,
                         device_type=DeviceType.CUDA, use_device="cuda")
    assert op.self_device_time_total == kernel.self_device_time_total == 5
    events = on_device([op, kernel, copy])
    assert events == [kernel, copy]
    busy, n, copies = device_totals(events)
    assert busy == pytest.approx(6e-6) and (n, copies) == (2, 1)
    assert device_totals([]) == (None, 0, 0)
