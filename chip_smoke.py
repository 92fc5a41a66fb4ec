#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is passed over:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every CUDA kernel of ``src/repro_torch/kernels/csrc`` with
   nvcc, one process per source, all started together;
3. kernels against plain: at the main path's shapes, hold each kernel
   against its plain PyTorch version and time both (CUDA events, warm,
   median), beside the least time the card could take for the same work;
4. main path: a default ``SolverService`` on the card answers ridge
   requests of every default shape class (two full batches of the top
   Gaussian class, one of the SRHT class, and the three smaller classes);
   every answer is held against an fp64 direct solve, and each kernel's
   launch count over the run must be positive;
5. summary: one ``{"kernels": [...]}`` line, then the device line last.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# kernel vs plain: fp32 sums of n products taken in two orders differ by
# about sqrt(n)·2^-24 of the result's scale; an indexing fault shows as O(1)
GAUSSIAN_REL_TOL = 1e-4
# FWHT: both run the same butterfly stages in the same order: exact
FWHT_REL_TOL = 0.0
# main path: each solution against an fp64 direct solve, in the energy norm
# ‖e‖_H / ‖x‖_H that the δ̃ certificate measures, within 1e-3 or within
# 2^-24·κ(H)·√k where that is larger, k the answer's PCG iterations. The
# engine's PCG, like the JAX reference's, runs in fp32 with a recursively
# updated residual; the gap between it and the true residual grows by about
# 2^-24·‖H‖·‖x‖ per iteration, so the attainable accuracy is about
# 2^-24·κ(H)·√k whatever the δ̃ tolerance, and κ(H) reaches 1e6 at ν = 1e-3
# on this spectrum. The error against the fp64 solve of the fp32-rounded
# normal equations is printed beside it: it is the same, so the fp32 Gram
# is not what limits the accuracy.
SOLVE_REL_TOL = 1e-3
FP32_UNIT = 2.0 ** -24


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    return smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} libraries compiled in "
          f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def _compare(name, got, want, tol):
    import torch

    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel = err / scale if scale else err
    ok = bool(torch.isfinite(got).all()) and rel <= tol
    print(f"[kernel] {name}: max_abs_err {err:.3e}, rel {rel:.3e} "
          f"(tolerance {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: kernel {name} disagrees with its plain version")
    return err


def phase_kernels():
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.fwht import fwht_ref
    from repro_torch.kernels.gaussian_gram import gaussian_s_dense, gaussian_sa_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    # Gaussian sketch→SA at the top Gaussian class: B=16, n=4096, d=256, m=512
    B, n, d, m = 16, 4096, 256, 512
    A = torch.randn((B, n, d), generator=g, device=dev) / n ** 0.5
    A_sh = torch.randn((n, d), generator=g, device=dev) / n ** 0.5
    seeds = torch.randint(0, 2 ** 32, (B,), generator=g, device=dev, dtype=torch.int64)
    w = torch.rand((B, n), generator=g, device=dev) + 0.5
    variants = [
        ("per-problem A", lambda: ops.gaussian_sa(A, seeds, m),
         lambda: gaussian_sa_ref(A, seeds, m), 4 * (B * n * d + B * m * d) + 8 * B,
         2.0 * B * m * n * d),
        ("shared A", lambda: ops.gaussian_sa(A_sh, seeds, m),
         lambda: gaussian_sa_ref(A_sh, seeds, m), 4 * (n * d + B * m * d) + 8 * B,
         2.0 * B * m * n * d),
        ("scaled (row weights)", lambda: ops.gaussian_sa(A, seeds, m, row_weights=w),
         lambda: gaussian_sa_ref(A, seeds, m, scale=torch.sqrt(w)),
         4 * (B * n * d + B * n + B * m * d) + 8 * B, 2.0 * B * m * n * d + B * m * n),
    ]
    gauss = []
    for label, kern, plain, nbytes, flops in variants:
        err = _compare(f"gaussian_sa {label}", kern(), plain(), GAUSSIAN_REL_TOL)
        ms, pms = time_ms(kern, reps=10), time_ms(plain, reps=3, warm=1)
        bms, by = bound_ms(flops, nbytes)
        print(f"[kernel] gaussian_sa {label}: {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bms:.4f} ms ({by})")
        gauss.append({"variant": label, "max_abs_err": err, "ms": ms, "plain_ms": pms,
                      "bound_ms": bms, "bound_by": by})
    lib_ms = time_ms(lambda: torch.bmm(gaussian_s_dense(seeds, m, n), A), reps=3, warm=1)
    print(f"[kernel] gaussian_sa library yardstick gaussian_s_dense + torch.bmm: "
          f"{lib_ms:.4f} ms")
    rows.append(dict(name="gaussian_sa", route="cuda",
                     source="src/repro_torch/kernels/csrc/gaussian_sa.cu",
                     replaces="src/repro/kernels/gaussian_gram.py:210",
                     **{k: gauss[0][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                 "bound_ms", "bound_by")},
                     library_ms=lib_ms, variants=gauss[1:]))
    del A, A_sh, w

    # FWHT at the SRHT class: B=16, n=16384, d=256, with the SRHT signs fused
    B, n, d = 16, 16384, 256
    X = torch.randn((B, n, d), generator=g, device=dev)
    s = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    lg = n.bit_length() - 1
    variants = [
        ("signs fused", lambda: ops.fwht_cols(X, row_scale=s),
         lambda: fwht_ref(X * s[:, :, None]), 4 * (2 * B * n * d + B * n),
         float(B * d * n * (lg + 1))),
        ("unscaled", lambda: ops.fwht_cols(X), lambda: fwht_ref(X),
         4 * 2 * B * n * d, float(B * d * n * lg)),
    ]
    fw = []
    for label, kern, plain, nbytes, flops in variants:
        err = _compare(f"fwht {label}", kern(), plain(), FWHT_REL_TOL)
        ms, pms = time_ms(kern, reps=10), time_ms(plain, reps=3, warm=1)
        bms, by = bound_ms(flops, nbytes)
        print(f"[kernel] fwht {label}: {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bms:.4f} ms ({by})")
        fw.append({"variant": label, "max_abs_err": err, "ms": ms, "plain_ms": pms,
                   "bound_ms": bms, "bound_by": by})
    rows.append(dict(name="fwht", route="cuda",
                     source="src/repro_torch/kernels/csrc/fwht.cu",
                     replaces="src/repro/kernels/fwht.py:43",
                     **{k: fw[0][k] for k in ("max_abs_err", "ms", "plain_ms",
                                              "bound_ms", "bound_by")},
                     library_ms=None, variants=fw[1:]))
    del X, s
    torch.cuda.empty_cache()
    return rows


# main-path traffic: (count, n range, d range) per shape class of the
# default service; ν is log-uniform in [1e-3, 1e-1]
TRAFFIC = [
    (6, (64, 256), (8, 32)),             # class (256, 32, 64)
    (5, (257, 1024), (33, 64)),          # class (1024, 64, 128)
    (5, (1025, 2048), (65, 128)),        # class (2048, 128, 256)
    (32, (2049, 4096), (129, 256)),      # class (4096, 256, 512): two batches
    (16, (8193, 16384), (129, 256)),     # class (16384, 256, 512, srht)
]
DECAY = 0.95


def _request(g, dev, n_rng, d_rng):
    """A = U·diag(0.95^i)·Vᵀ with orthonormal U, V (ill-conditioned, so the
    ladders climb), y ~ N(0, I), ν log-uniform in [1e-3, 1e-1]."""
    import torch

    n = int(torch.randint(n_rng[0], n_rng[1] + 1, (), generator=g, device=dev))
    d = int(torch.randint(d_rng[0], d_rng[1] + 1, (), generator=g, device=dev))
    U, _ = torch.linalg.qr(torch.randn((n, d), generator=g, device=dev))
    V, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev))
    sv = DECAY ** torch.arange(d, device=dev, dtype=torch.float32)
    A = (U * sv[None, :]) @ V.T
    y = torch.randn((n,), generator=g, device=dev)
    nu = 10.0 ** (-3.0 + 2.0 * float(torch.rand((), generator=g, device=dev)))
    return A, y, nu


def phase_main_path(dev="cuda"):
    """A default SolverService answers the traffic; returns the kernels'
    launch counts over the run."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.solver_service import SolverService

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    requests = [_request(g, dev, n_rng, d_rng)
                for count, n_rng, d_rng in TRAFFIC for _ in range(count)]
    svc = SolverService(device=dev)
    per_class = {}
    solve_chunk = svc._solve_chunk

    def timed_chunk(cls, reqs):           # per-class wall time and launches
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        out = solve_chunk(cls, reqs)
        rec = per_class.setdefault(cls, {"seconds": 0.0, "requests": 0,
                                         "launches": dict.fromkeys(before, 0)})
        rec["seconds"] += time.perf_counter() - t0
        rec["requests"] += len(reqs)
        for k in before:
            rec["launches"][k] += ops.LAUNCHES[k] - before[k]
        return out

    svc._solve_chunk = timed_chunk
    ops.reset_launches()
    t0 = time.perf_counter()
    ids = [svc.submit(A, y, nu) for A, y, nu in requests]
    sols = svc.flush()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"[main] {len(ids)} requests answered in {wall:.3f} s "
          f"({len(ids) / wall:.2f} req/s, first-call set-up included); "
          f"{svc.stats['batches']} batches of {svc.batch_size}, "
          f"{svc.stats['padded_slots']} padded slots; launches {launches}")

    worst, failures = 0.0, []
    by_class = {}
    for rid, (A, y, nu) in zip(ids, requests):
        s = sols[rid]
        A64 = A.double()
        H = A64.T @ A64 + nu ** 2 * torch.eye(A.shape[1], dtype=torch.float64, device=dev)
        x64 = torch.linalg.solve(H, A64.T @ y.double())
        e = s.x.double() - x64
        err = float(torch.sqrt((e @ H @ e) / (x64 @ H @ x64)))
        err2 = float(torch.linalg.norm(e) / torch.linalg.norm(x64))
        # the fp32-rounded normal equations, solved in fp64
        H32 = (A.T @ A).double() + nu ** 2 * torch.eye(
            A.shape[1], dtype=torch.float64, device=dev)
        x32 = torch.linalg.solve(H32, (A.T @ y).double())
        e32 = s.x.double() - x32
        err32 = float(torch.sqrt((e32 @ H32 @ e32) / (x32 @ H32 @ x32)))
        ev = torch.linalg.eigvalsh(H)
        tol = max(SOLVE_REL_TOL,
                  FP32_UNIT * float(ev[-1] / ev[0]) * max(s.iters, 1) ** 0.5)
        worst = max(worst, err / tol)
        by_class.setdefault(s.shape_class, []).append((s, err, err2, err32, err / tol))
        if s.status not in ("OK", "RETRIED") or not err <= tol:
            failures.append((rid, s.status, err, tol))
    for cls, rows in by_class.items():
        rec = per_class[cls]
        hist = {}
        for s, *_ in rows:
            hist[s.status] = hist.get(s.status, 0) + 1
        m = sorted(s.m_final for s, *_ in rows)
        dts = [s.delta_tilde for s, *_ in rows if s.converged]
        print(f"[main] class n={cls.n} d={cls.d} m_max={cls.m_max} "
              f"sketch={cls.sketch or svc.sketch}: {rec['requests']} requests, "
              f"{rec['requests'] / rec['seconds']:.2f} req/s, statuses {hist}, "
              f"m_final min/median/max {m[0]}/{m[len(m) // 2]}/{m[-1]}, "
              f"max δ̃ {max(dts) if dts else float('nan'):.3e}, "
              f"max rel err vs fp64: H-norm {max(r[1] for r in rows):.3e}, "
              f"2-norm {max(r[2] for r in rows):.3e}, against the fp64 solve of "
              f"the fp32 normal equations: H-norm {max(r[3] for r in rows):.3e}; "
              f"worst share of tolerance {max(r[4] for r in rows):.3f}, "
              f"launches {rec['launches']}")
    print(f"[main] worst H-norm rel err vs fp64 direct solve, as a share of its "
          f"tolerance max({SOLVE_REL_TOL:g}, 2^-24·κ(H)·√k): {worst:.3f}")
    if failures:
        raise SystemExit(f"chip_smoke: main path failures (id, status, rel err, "
                         f"tolerance): {failures[:10]}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernels {missing} were never launched on "
                         "the main path")
    return launches


def main() -> int:
    import torch

    import repro_torch  # noqa: F401  (fails when run outside the checkout)

    phase_device()
    phase_build()
    rows = phase_kernels()
    launches = phase_main_path()
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
