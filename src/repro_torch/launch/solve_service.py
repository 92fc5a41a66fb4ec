"""Ridge-solve serving demo with the preemptible lifecycle, on the port.

Submits random-shape ridge requests drawn from ``--seed`` with numpy (so a
restart replays the same submissions), flushes them through the
``SolverService``, audits every converged answer, and every answer that
stopped at the iteration cap, against a dense direct solve, and prints the
certificates. The port's leg of the reference's ``examples/solve_service.py``
with the same flags, plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.solve_service [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.solve_service --sketch sjlt --dtype bf16

``--deadline-s`` bounds the flush (expired requests come back
DEADLINE_EXCEEDED with their best iterate). ``--checkpoint-dir`` makes
every ridge chunk preemptible: SIGTERM checkpoints the chunk in flight,
prints ``PREEMPTED at segment k`` and exits 75; the same command with
``--resume`` restores the committed segments and finishes with the
answers of an uninterrupted run. ``python -m repro_torch.launch.serve
--preempt-after S`` drives that kill → restart cycle:

    PYTHONPATH=src python -m repro_torch.launch.solve_service --checkpoint-dir ck
    # SIGTERM during the flush → "PREEMPTED at segment k", exit 75
    PYTHONPATH=src python -m repro_torch.launch.solve_service --checkpoint-dir ck --resume

``--path N`` also submits N λ-path requests (8-point grids off one sketch
pass each) and then one grid again, which the ladder cache serves without
a sketch pass.

The line ``FLUSH START`` is printed as the flush begins; ``ALL_FINITE=1``
and ``AUDIT_OK=1`` when every answer is finite and every audited one is
within ``AUDIT_REL_TOL`` of the direct solve.
"""

from __future__ import annotations

import argparse
import shutil
import signal
import sys
import time

import numpy as np
import torch

from repro_torch.core import PreemptedError
from repro_torch.core.level_grams import COMPUTE_DTYPES, PADDED_SKETCHES
from repro_torch.core.quadratic import direct_solve, from_least_squares
from repro_torch.launch.mesh import EXIT_PREEMPTED  # 75, EX_TEMPFAIL: restart with --resume
from repro_torch.serve.solver_service import PathSolution, SolverService

# relative 2-norm error of an audited answer against the direct solve: the
# requests' ν ∈ [0.05, 0.5] keeps κ(H) below about 1e3, so fp32 PCG lands
# within 1e-5 of it; an answer off by 1e-3 is wrong, not rounded
AUDIT_REL_TOL = 1e-3
CERTIFICATE_LINES = 8


def _requests(rng, count, dev):
    """``count`` ridge requests, n ∈ [64, 1500), d ∈ [8, 100), A/√n and y
    standard normal, ν ∈ [0.05, 0.5), all drawn from ``rng``."""
    out = []
    for _ in range(count):
        n = int(rng.integers(64, 1500))
        d = int(rng.integers(8, 100))
        A = torch.as_tensor(rng.standard_normal((n, d)) / np.sqrt(n),
                            dtype=torch.float32, device=dev)
        y = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
        out.append((A, y, float(rng.uniform(0.05, 0.5))))
    return out


def _rel_err(x, A, y, nu) -> float:
    x_star = direct_solve(from_least_squares(A.double(), y.double(), nu))
    return float(torch.linalg.norm(x.double() - x_star) / torch.linalg.norm(x_star))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sketch", default="gaussian", choices=PADDED_SKETCHES,
                    help="sketch family of the service")
    ap.add_argument("--dtype", default="fp32", choices=COMPUTE_DTYPES,
                    help="sketch-pass compute dtype; certificates stay fp32")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the requests (numpy) and of the service's sketches")
    ap.add_argument("--tol", type=float, default=1e-12)
    ap.add_argument("--max-iters", type=int, default=100)
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--no-fallback", action="store_true",
                    help="disable the dense direct_solve fallback")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="wall-clock budget for the whole flush")
    ap.add_argument("--segment-trips", type=int, default=32,
                    help="loop trips per segment when the solve runs preemptibly")
    ap.add_argument("--checkpoint-dir", default="",
                    help="checkpoint the chunks' solver state here; SIGTERM then "
                         "exits 75 after a commit, and --resume continues")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint-dir instead of wiping it")
    ap.add_argument("--path", type=int, default=0,
                    help="also submit this many λ-path requests and a repeated grid")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def preemptible_service(args, mesh=None, device=None) -> SolverService:
    """The demo's service from its flags, with a SIGTERM ``PreemptionHandler``
    when ``--checkpoint-dir`` is set; under ``mesh`` the sharded service
    (``launch.serve --mesh K --preempt-after S`` runs one a rank)."""
    preempt = None
    if args.checkpoint_dir:
        from repro_torch.ft import PreemptionHandler

        preempt = PreemptionHandler(signals=(signal.SIGTERM,)).__enter__()
    return SolverService(batch_size=16, method="pcg", sketch=args.sketch,
                         compute_dtype=args.dtype, tol=args.tol, max_iters=args.max_iters,
                         seed=args.seed, max_retries=args.max_retries,
                         fallback=not args.no_fallback, segment_trips=args.segment_trips,
                         checkpoint_dir=args.checkpoint_dir or None, preempt=preempt,
                         ladder_cache=bool(args.path), mesh=mesh,
                         device=args.device if device is None else device)


def submit_requests(svc: SolverService, args):
    """Submit the ``--requests`` ridge requests drawn from ``--seed``;
    returns ({request id: (A, y, ν)}, the generator, for further draws)."""
    rng = np.random.default_rng(args.seed)
    return {svc.submit(A, y, nu): (A, y, nu)
            for A, y, nu in _requests(rng, args.requests, svc.device)}, rng


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.checkpoint_dir and not args.resume:
        shutil.rmtree(args.checkpoint_dir, ignore_errors=True)
    svc = preemptible_service(args)
    dev = svc.device
    requests, rng = submit_requests(svc, args)
    nus = np.geomspace(1.0, 1e-2, 8)          # strong → weak: warm downhill
    paths = {svc.submit_path(A, y, nus): (A, y)
             for A, y, _ in _requests(rng, args.path, dev)}

    print("FLUSH START", flush=True)
    t0 = time.perf_counter()
    try:
        sols = svc.flush(deadline_s=args.deadline_s)
    except PreemptedError as e:
        print(f"PREEMPTED at segment {e.segment} (state committed to "
              f"{e.checkpoint_dir}); re-run with --resume to continue", flush=True)
        return EXIT_PREEMPTED
    dt = time.perf_counter() - t0

    counts: dict[str, int] = {}
    for s in sols.values():
        counts[s.status] = counts.get(s.status, 0) + 1
    ridge = {rid: s for rid, s in sols.items() if rid in requests}
    path = {rid: s for rid, s in sols.items() if isinstance(s, PathSolution)}
    all_finite = (all(bool(torch.isfinite(s.x).all()) for s in ridge.values())
                  and all(bool(torch.isfinite(p.x).all())
                          for s in path.values() for p in s.points))
    audited = {rid: s for rid, s in ridge.items() if s.converged or s.stalled}
    worst = max((_rel_err(s.x, *requests[rid]) for rid, s in audited.items()),
                default=0.0)
    for rid, s in path.items():
        if s.converged:
            A, y = paths[rid]
            worst = max([worst] + [_rel_err(p.x, A, y, p.nu) for p in s.points])

    print(f"{len(sols)} requests in {dt:.2f}s on {dev} ({svc.stats['batches']} batches, "
          f"{svc.stats['padded_slots']} padded slots)")
    print("statuses: " + ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
          + f"; segments={svc.stats['segments']}, "
          f"resumed_chunks={svc.stats['resumed_chunks']}, "
          f"deadline_exceeded={svc.stats['deadline_exceeded']}")
    print(f"ALL_FINITE={int(all_finite)}")
    print(f"audited {len(audited)} ridge answers (converged or stopped at the iteration "
          f"cap) and {sum(s.converged for s in path.values())} converged grids: worst "
          f"relative error vs direct solve {worst:.2e} (tolerance {AUDIT_REL_TOL:g})")
    print(f"AUDIT_OK={int(worst <= AUDIT_REL_TOL)}")
    ok = sorted(rid for rid, s in ridge.items() if s.converged)
    if ok:
        m = sorted(ridge[rid].m_final for rid in ok)
        print(f"adapted sketch sizes m_final: min={m[0]} median={m[len(m) // 2]} "
              f"max={m[-1]}")
    for rid in ok[:CERTIFICATE_LINES]:
        s = ridge[rid]
        c = s.shape_class
        print(f"  cert req={rid:3d} sketch={s.sketch:<14s} dtype={s.compute_dtype:<4s} "
              f"class=(n={c.n}, d={c.d}, m_max={c.m_max}) m_final={s.m_final:4d} "
              f"iters={s.iters:3d} doublings={s.doublings} δ̃={s.delta_tilde:.2e}")
    if path:
        s0 = path[min(path)]
        print(f"path: {sum(s.converged for s in path.values())}/{len(path)} grids "
              f"converged, {sum(s.sketch_passes for s in path.values())} one-touch "
              f"passes for {sum(len(s.points) for s in path.values())} λ points; warm m "
              f"trajectory (req {s0.req_id}): {tuple(p.m_final for p in s0.points)}")
        A, y = paths[min(path)]
        warm = svc.flush()[svc.submit_path(A, y, nus)]
        same = all(torch.equal(a.x, b.x) for a, b in zip(warm.points, s0.points))
        print(f"repeat-A path round: cache_hit={warm.cache_hit}, "
              f"sketch_passes={warm.sketch_passes}, identical_solutions={int(same)}")
    return 0 if all_finite and worst <= AUDIT_REL_TOL else 1


if __name__ == "__main__":
    sys.exit(main())
