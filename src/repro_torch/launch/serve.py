"""Ridge serving launcher: random-shape ridge requests through the port's
shape-class bucketing and batched adaptive engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --ridge --requests 64 \\
        [--sketch gaussian|gaussian_dense|sjlt|srht] [--dtype fp32|bf16|int8] \\
        [--device cuda|cpu] [--deadline-s T] [--segment-trips K]

Mirrors ``repro.launch.serve --ridge`` for ridge traffic only; the data is
drawn from a seeded ``torch.Generator`` on the chosen device. ``--sketch``
is the service's default family (the n = 16384 class keeps its SRHT) and
``--dtype`` the sketch pass's precision; certificates stay fp32 and record
both. ``--deadline-s`` bounds the flush: requests that run out of time
come back DEADLINE_EXCEEDED with their best iterates, the solves running in
segments of ``--segment-trips`` loop trips. LM serving, GLM and path
traffic and meshes are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.level_grams import COMPUTE_DTYPES, PADDED_SKETCHES
from repro_torch.serve.solver_service import SolverService


def serve_ridge(args) -> dict:
    svc = SolverService(method="pcg", sketch=args.sketch, compute_dtype=args.dtype,
                        segment_trips=args.segment_trips, device=args.device)
    dev = svc.device
    g = torch.Generator(device=dev).manual_seed(args.seed)
    for _ in range(args.requests):
        n = int(torch.randint(64, 1800, (), generator=g, device=dev))
        d = int(torch.randint(8, 120, (), generator=g, device=dev))
        A = torch.randn((n, d), generator=g, device=dev) / n ** 0.5
        y = torch.randn((n,), generator=g, device=dev)
        nu = 0.05 + 0.45 * float(torch.rand((), generator=g, device=dev))
        svc.submit(A, y, nu=nu)
    t0 = time.perf_counter()
    sols = svc.flush(deadline_s=args.deadline_s)
    dt = time.perf_counter() - t0
    print(f"solver service on {dev} (sketch={args.sketch}, dtype={args.dtype}): "
          f"{len(sols)} requests in {dt:.2f}s "
          f"({len(sols) / dt:.1f} req/s) — {svc.stats['batches']} batches of "
          f"{svc.batch_size}, {svc.stats['padded_slots']} padded slots "
          f"({100 * svc.slot_utilization():.0f}% slot utilization)")
    ok = [s for s in sols.values() if s.converged]
    if ok:
        m = sorted(s.m_final for s in ok)
        print(f"ridge certificates: m_final min/median/max = "
              f"{m[0]}/{m[len(m) // 2]}/{m[-1]}, "
              f"max residual δ̃ = {max(s.delta_tilde for s in ok):.2e}")
    counts: dict[str, int] = {}
    for s in sols.values():
        counts[s.status] = counts.get(s.status, 0) + 1
    print("statuses: " + ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
          + f"; retries={svc.stats['retries']}, fallbacks={svc.stats['fallbacks']}, "
          f"deadline_exceeded={svc.stats['deadline_exceeded']}, "
          f"segments={svc.stats['segments']}")
    return sols


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ridge", action="store_true", required=True,
                   help="serve ridge-solve traffic (the only ported workload)")
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sketch", default="gaussian", choices=PADDED_SKETCHES,
                   help="sketch family of the ridge service")
    p.add_argument("--dtype", default="fp32", choices=COMPUTE_DTYPES,
                   help="sketch-pass compute dtype: bf16 rounds the sketch "
                        "operands to bfloat16 with fp32 sums, int8 also "
                        "quantizes A per row; certificates stay fp32")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="wall-clock budget for the flush; requests that run out "
                        "of it return DEADLINE_EXCEEDED with their best iterate")
    p.add_argument("--segment-trips", type=int, default=32,
                   help="loop trips per segment of a deadline-bound solve")
    serve_ridge(p.parse_args(argv))


if __name__ == "__main__":
    main()
