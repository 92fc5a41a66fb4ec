"""Where the time of one packed ridge batch goes, phase by phase, on the card.

    PYTHONPATH=src python -m repro_torch.launch.breakdown [--device cuda] [--reps 3] \
        [--sketch gaussian|gaussian_dense|sjlt|srht] [--dtype fp32|bf16|int8]

Packs one full batch of the top class (n=4096, d=256, m_max=512), under
``--sketch`` (default gaussian), and one of the SRHT class (n=16384, d=256,
m_max=512), both with the sketch pass in ``--dtype``, with the main-path traffic of ``chip_smoke.py`` (A = U·diag(0.95^i)·Vᵀ,
ν log-uniform in [1e-3, 1e-1]), and runs the engine's pieces in order,
synchronizing the device after each, so each phase's wall time is its own:
pack, sketch pass (the kernel plus the prefix Grams), ladder factorization
(Cholesky + inverses + guard tables), true-Gram precompute, the PCG loop,
and finalize with the copy of the certificates to the host. It then times
the whole batch through ``robust_padded_solve_batched`` and, under
``torch.profiler``, the device's busy time over that solve, and prints one
JSON line per class. Times are medians over ``--reps`` runs after one
warm-up run.
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


def _phases(svc, cls, reqs):
    """Wall seconds of each engine phase, in order, for one packed batch."""
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
    grams = timed("sketch_pass", lambda: ap._compute_ladder_grams(
        q, seeds, m_max=cls.m_max, sketch=sketch, compute_dtype=cd))
    tables = timed("factorize", lambda: ap._ladder_tables(q, grams, guards=True))
    G = timed("gram_precompute", lambda: ap._gram_precompute(q, None))
    pre = ap.PaddedPrecompute(*tables, G_full=G)
    st = timed("pcg_loop", lambda: ap._run_segment(
        q, pre, ap._init_padded_state(q, pre, None, svc.tol),
        ap.padded_trip_cap(cls.m_max, svc.max_iters), method=svc.method,
        max_iters=svc.max_iters, rho=svc.rho, tol=svc.tol, guards=True))
    timed("finalize_to_host", lambda: {
        k: v.cpu() for k, v in ap._finalize(pre, st, m_max=cls.m_max)[1].items()})
    return times, int(st.trips), q, seeds


def _device_busy_seconds(fn) -> float | None:
    """Sum of the device times of the kernels ``fn`` ran (torch.profiler),
    or None where the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
    return total * 1e-6 if total > 0 else None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--sketch", default="gaussian", choices=PADDED_SKETCHES)
    p.add_argument("--dtype", default="fp32", choices=COMPUTE_DTYPES)
    args = p.parse_args(argv)
    svc = SolverService(sketch=args.sketch, compute_dtype=args.dtype,
                        device=args.device)
    dev = svc.device
    g = torch.Generator(device=dev).manual_seed(2)
    classes = {c.n: c for c in svc.shape_classes}
    for cls, n_rng in ((classes[4096], (2049, 4096)), (classes[16384], (8193, 16384))):
        reqs = _traffic(g, dev, svc.batch_size, n_rng, (129, 256))
        runs = [_phases(svc, cls, reqs) for _ in range(args.reps + 1)][1:]
        phases = {k: statistics.median(r[0][k] for r in runs) for k in runs[0][0]}
        q, seeds = runs[0][2], runs[0][3]

        def solve():
            x, stats = robust_padded_solve_batched(
                q, seeds, m_max=cls.m_max, method=svc.method,
                sketch=cls.sketch or svc.sketch, max_iters=svc.max_iters,
                rho=svc.rho, tol=svc.tol, compute_dtype=svc.compute_dtype,
                device=dev)
            _sync(dev)
            return stats

        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            stats = solve()
            walls.append(time.perf_counter() - t0)
        busy = _device_busy_seconds(solve) if dev.type == "cuda" else None
        wall = statistics.median(walls)
        print(json.dumps({
            "class": list(cls[:3]) + [cls.sketch or svc.sketch],
            "compute_dtype": svc.compute_dtype,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "batch": svc.batch_size, "trips": runs[0][1],
            "phases_s": phases, "solve_s": wall,
            "requests_per_s": svc.batch_size / wall,
            "retries": int(stats["retries"].sum()),
            "device_busy_s": busy,
            "device_idle_share": None if busy is None else max(0.0, 1.0 - busy / wall),
        }))


if __name__ == "__main__":
    main()
