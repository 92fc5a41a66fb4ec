"""Where the time of one packed ridge batch goes, phase by phase, on the card.

    PYTHONPATH=src python -m repro_torch.launch.breakdown [--device cuda] [--reps 3] \
        [--sketch gaussian|gaussian_dense|sjlt|srht] [--dtype fp32|bf16|int8] \
        [--segment-trips 8 32]

Packs one full batch of the top class (n=4096, d=256, m_max=512), under
``--sketch`` (default gaussian), and one of the SRHT class (n=16384, d=256,
m_max=512), both with the sketch pass in ``--dtype``, with the main-path
traffic of ``chip_smoke.py`` (A = U·diag(0.95^i)·Vᵀ, ν log-uniform in
[1e-3, 1e-1]), and runs the engine through its public split as the
segmented driver does, synchronizing the device after each phase, so each
phase's wall time is its own: pack, ``prepare_padded_solve`` (sketch pass,
ladder factorization, true Gram, initial state), each
``padded_solve_segment`` of ``--segment-trips`` trips, and
``finalize_padded_solve`` with the copy of the certificates to the host.
Between two segments the host reads ``done`` and ``trips`` and starts the
next: that host gap is reported beside the segments' times, once per
segment length. It then times the whole batch through
``robust_padded_solve_batched``, monolithic and segmented (a deadline of an
hour, segments of the first ``--segment-trips``) in turns, and, under
``torch.profiler``, the device's busy time over the monolithic solve, and
prints one JSON line per class. Times are medians over ``--reps`` runs
after one warm-up run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.core import adaptive_padded as ap
from repro_torch.core.level_grams import COMPUTE_DTYPES, PADDED_SKETCHES
from repro_torch.core.robust import robust_padded_solve_batched
from repro_torch.serve.solver_service import RidgeRequest, SolverService


def _traffic(g, dev, count, n_rng, d_rng):
    reqs = []
    for i in range(count):
        n = int(torch.randint(n_rng[0], n_rng[1] + 1, (), generator=g, device=dev))
        d = int(torch.randint(d_rng[0], d_rng[1] + 1, (), generator=g, device=dev))
        U, _ = torch.linalg.qr(torch.randn((n, d), generator=g, device=dev))
        V, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev))
        A = (U * (0.95 ** torch.arange(d, device=dev))[None, :]) @ V.T
        y = torch.randn((n,), generator=g, device=dev)
        nu = 10.0 ** (-3.0 + 2.0 * float(torch.rand((), generator=g, device=dev)))
        reqs.append(RidgeRequest(i, A, y, nu))
    return reqs


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _phases(svc, cls, reqs, segment_trips):
    """Wall seconds of pack, prepare and finalize, the list of segment
    times and of host gaps between segments, and the trips, for one packed
    batch run through the public split."""
    dev, sketch = svc.device, cls.sketch or svc.sketch
    cd = cls.compute_dtype or svc.compute_dtype
    times = {}

    def timed(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        times[name] = time.perf_counter() - t0
        return out

    q, seeds = timed("pack", lambda: svc._pack(cls, reqs))
    pre, st = timed("prepare", lambda: ap.prepare_padded_solve(
        q, seeds, m_max=cls.m_max, sketch=sketch, compute_dtype=cd, tol=svc.tol,
        device=dev))
    cap = ap.padded_trip_cap(cls.m_max, svc.max_iters)
    segments, gaps, t_end = [], [], None
    while True:
        # the segmented driver's check between segments (host reads)
        if bool(st.done.all()) or int(st.trips) >= cap:
            break
        t0 = time.perf_counter()
        if t_end is not None:
            gaps.append(t0 - t_end)
        st = ap.padded_solve_segment(
            q, pre, st, min(cap, int(st.trips) + segment_trips), method=svc.method,
            max_iters=svc.max_iters, rho=svc.rho, tol=svc.tol, device=dev)
        _sync(dev)
        t_end = time.perf_counter()
        segments.append(t_end - t0)
    timed("finalize_to_host", lambda: {
        k: v.cpu() for k, v in ap.finalize_padded_solve(pre, st, m_max=cls.m_max,
                                                        device=dev)[1].items()})
    return times, segments, gaps, int(st.trips), q, seeds


def on_device(events) -> list:
    """The device-side events (kernels, memcpys, memsets) among a profile's
    events. Only these carry device time of their own: an op's event (and
    its row in ``key_averages()``) also carries the device time of the
    kernels it launched, so a sum over every event counts each kernel
    twice."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA]


def device_events(fn) -> list:
    """The device-side events of one torch.profiler run of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return on_device(prof.events())


def device_totals(events) -> tuple[float | None, int, int]:
    """(the device time of device-side ``events`` in s, None where it is 0;
    how many there are; how many are memcpys or memsets)."""
    total = sum(e.device_time_total for e in events)
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in events)
    return (total * 1e-6 if total > 0 else None), len(events), copies


def _device_profile(fn) -> tuple[float | None, int, int]:
    """One torch.profiler run of ``fn``: ``device_totals`` of its device
    events."""
    return device_totals(device_events(fn))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--sketch", default="gaussian", choices=PADDED_SKETCHES)
    p.add_argument("--dtype", default="fp32", choices=COMPUTE_DTYPES)
    p.add_argument("--segment-trips", type=int, nargs="+", default=[8, 32])
    args = p.parse_args(argv)
    svc = SolverService(sketch=args.sketch, compute_dtype=args.dtype,
                        device=args.device)
    dev = svc.device
    g = torch.Generator(device=dev).manual_seed(2)
    classes = {c.n: c for c in svc.shape_classes}
    med = statistics.median
    for cls, n_rng in ((classes[4096], (2049, 4096)), (classes[16384], (8193, 16384))):
        reqs = _traffic(g, dev, svc.batch_size, n_rng, (129, 256))
        per_k = {}
        for k in args.segment_trips:
            runs = [_phases(svc, cls, reqs, k) for _ in range(args.reps + 1)][1:]
            per_k[k] = {
                "phases_s": {name: med(r[0][name] for r in runs) for name in runs[0][0]},
                "segments": len(runs[0][1]),
                "segments_total_s": med(sum(r[1]) for r in runs),
                "segment_s_median": med(t for r in runs for t in r[1]),
                "host_gap_s_median": (med(t for r in runs for t in r[2])
                                      if runs[0][2] else None),
                "trips": runs[0][3],
            }
        q, seeds = runs[0][4], runs[0][5]

        def solve(**seg):
            x, stats = robust_padded_solve_batched(
                q, seeds, m_max=cls.m_max, method=svc.method,
                sketch=cls.sketch or svc.sketch, max_iters=svc.max_iters,
                rho=svc.rho, tol=svc.tol, compute_dtype=svc.compute_dtype,
                device=dev, **seg)
            _sync(dev)
            return stats

        # the monolithic and the segmented solve in turns, each first in
        # every other round
        k0 = args.segment_trips[0]
        forms = [("mono", {}), ("seg", dict(deadline_s=3600.0, segment_trips=k0))]
        solve()                                  # warm-up
        walls = {name: [] for name, _ in forms}
        for rep in range(args.reps):
            for name, seg in (forms if rep % 2 == 0 else forms[::-1]):
                t0 = time.perf_counter()
                stats = solve(**seg)
                walls[name].append(time.perf_counter() - t0)
        mono_s, seg_s = med(walls["mono"]), med(walls["seg"])
        busy = _device_profile(solve)[0] if dev.type == "cuda" else None
        print(json.dumps({
            "class": list(cls[:3]) + [cls.sketch or svc.sketch],
            "compute_dtype": svc.compute_dtype,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "batch": svc.batch_size, "split_by_segment_trips": per_k,
            "solve_s": mono_s, f"segmented_solve_s_{k0}": seg_s,
            "requests_per_s": svc.batch_size / mono_s,
            "retries": int(stats["retries"].sum()),
            "device_busy_s": busy,
            "device_idle_share": None if busy is None else max(0.0, 1.0 - busy / mono_s),
        }))


if __name__ == "__main__":
    main()
