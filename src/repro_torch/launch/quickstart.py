"""Quickstart: a regularized least-squares problem solved by the paper's
adaptive sketching PCG, against direct and CG baselines; or, with
``--logistic``, a batch of logistic-ridge problems by adaptive sketched
Newton against exact IRLS.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--logistic] [--small]
        [--device cpu]

The port's leg of ``examples/quickstart.py``, with its sizes, spectra and
solver settings:

* ``main``: (n, d, ν) = (8192, 1024, 1e-2), or (1024, 128, 1e-2) with
  ``--small``; A = U·diag(0.99^i)·Vᵀ from QRs of Gaussian blocks, y
  Gaussian. Direct Cholesky, CG (300 iterations) and adaptive PCG
  (``AdaptiveConfig(method="pcg", sketch="sjlt", max_iters=100,
  tol=1e-10)``, the B = 1 SJLT kernel); prints the times, rel_err against
  the direct solve, iterations, doublings, m_final and d_e. At the small
  size (κ(H) ≈ 13) CG reaches fp32's resolution of its first residual
  within about 30 iterations and stops moving there (``core.solvers.cg_solve``).
* ``main_logistic``: (B, n, d, m_max) = (8, 2048, 64, 128), or
  (4, 256, 16, 32) with ``--small``, ν = 0.3:
  ``adaptive_newton_solve_batched("logistic", …)`` (Gaussian sketches, the
  weighted Gaussian kernel) against ``irls_reference``; prints the max
  rel_err, the converged count, the outer iterations, the max decrement
  and problem 0's m trajectory.

Data comes from explicit ``torch.Generator``s (the port's own draws, not
JAX's); ``ridge_solves`` and ``logistic_solve`` take the problem as
arguments, so the tests hand them the reference's arrays.
Everything runs on ``cuda`` unless ``--device cpu``; times are CUDA events
on the card and the host clock on the CPU, each around one whole call.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import (
    AdaptiveConfig,
    adaptive_newton_solve_batched,
    adaptive_solve,
    cg_solve,
    direct_solve,
    effective_dimension,
    exp_decay_singular_values,
    from_least_squares,
    irls_reference,
)
from repro_torch.core.objectives import synthetic_logistic_batch
from repro_torch.device import resolve_device

RIDGE = {"full": (8192, 1024, 1e-2), "small": (1024, 128, 1e-2)}
LOGISTIC = {"full": (8, 2048, 64, 128), "small": (4, 256, 16, 32)}
LOGISTIC_NU = 0.3
DATA_SEEDS = {"ridge": 0, "logistic": 2}      # the generators' roots; sketches use seed 1
ADAPTIVE = AdaptiveConfig(method="pcg", sketch="sjlt", max_iters=100, tol=1e-10)
CG_ITERS = 300


def timed(fn, device):
    """(ms of one call of ``fn``, its result): CUDA events on a card (the
    host's enqueue included), the host clock otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def ridge_problem(n: int, d: int, *, generator: torch.Generator):
    """(A, y, σ): the example's ill-conditioned problem, the paper's §6
    spectrum σ_i = 0.99^i, drawn on the generator's device."""
    dev = generator.device
    sv = exp_decay_singular_values(d, 0.99, device=dev)
    U, _ = torch.linalg.qr(torch.randn((n, d), generator=generator, device=dev))
    V, _ = torch.linalg.qr(torch.randn((d, d), generator=generator, device=dev))
    A = ((U * sv[None, :]) @ V.T).contiguous()
    y = torch.randn((n,), generator=generator, device=dev)
    return A, y, sv


def _rel(x, ref) -> float:
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def ridge_solves(A, y, nu: float, sv, *, device=None) -> dict:
    """Direct, CG and the paper's adaptive PCG (sketch seed 1) on one problem."""
    dev = resolve_device(device)
    q = from_least_squares(A, y, nu)
    out = {"d_e": float(effective_dimension(sv, nu))}
    out["direct_ms"], x_star = timed(lambda: direct_solve(q), dev)
    out["cg_ms"], (x_cg, cg_trace) = timed(
        lambda: cg_solve(q, torch.zeros_like(q.b), iters=CG_ITERS), dev)
    out["adaptive_ms"], res = timed(
        lambda: adaptive_solve(q, ADAPTIVE, seed=1, device=dev), dev)
    out.update(x_star=x_star, x_cg=x_cg, cg_trace=cg_trace, x=res.x,
               cg_rel_err=_rel(x_cg, x_star),
               rel_err=_rel(res.x, x_star), iters=res.iters, doublings=res.n_doublings,
               m_final=res.m_final)
    return out


def main(small: bool = False, device=None) -> dict:
    dev = resolve_device(device)
    n, d, nu = RIDGE["small" if small else "full"]
    g = torch.Generator(device=dev).manual_seed(DATA_SEEDS["ridge"])
    A, y, sv = ridge_problem(n, d, generator=g)
    r = ridge_solves(A, y, nu, sv, device=dev)
    print(f"problem: n={n} d={d} ν={nu}  effective dimension d_e≈{r['d_e']:.0f}")
    print(f"direct Cholesky:        {r['direct_ms'] / 1e3:6.2f}s")
    print(f"CG ({CG_ITERS} iters):         {r['cg_ms'] / 1e3:6.2f}s  "
          f"rel_err={r['cg_rel_err']:.2e}")
    print(f"adaptive PCG (paper):   {r['adaptive_ms'] / 1e3:6.2f}s  rel_err={r['rel_err']:.2e}  "
          f"iters={r['iters']}  doublings={r['doublings']}  "
          f"final sketch m={r['m_final']} (vs 2d={2 * d}, d_e≈{r['d_e']:.0f})")
    return r


def logistic_solve(A, Y, nu: float, m_max: int, *, device=None) -> dict:
    """One sketched-Newton call on the batch (sketch seed 1) and the
    exact-IRLS answer."""
    dev = resolve_device(device)
    ms, (x, stats) = timed(lambda: adaptive_newton_solve_batched(
        "logistic", A, Y, nu, m_max=m_max, seeds=1, device=dev), dev)
    x_ref = irls_reference("logistic", A, Y, nu, device=dev)
    rel = torch.linalg.norm(x - x_ref, dim=1) / torch.linalg.norm(x_ref, dim=1)
    outer = stats["newton_iters"]
    return {"x": x, "x_ref": x_ref, "stats": stats, "newton_ms": ms,
            "max_rel_err": float(rel.max()), "converged": int(stats["converged"].sum()),
            "outer_min": int(outer.min()), "outer_max": int(outer.max()),
            "max_decrement": float(stats["decrement"].max()),
            "m_trajectory": stats["m_trajectory"][:, 0].tolist()}


def main_logistic(small: bool = False, device=None) -> dict:
    dev = resolve_device(device)
    B, n, d, m_max = LOGISTIC["small" if small else "full"]
    g = torch.Generator(device=dev).manual_seed(DATA_SEEDS["logistic"])
    A, Y = synthetic_logistic_batch(g, B, n, d)
    print(f"logistic-ridge batch: B={B} n={n} d={d} ν={LOGISTIC_NU} m_max={m_max}")
    r = logistic_solve(A, Y, LOGISTIC_NU, m_max, device=dev)
    print(f"sketched Newton:        {r['newton_ms'] / 1e3:6.2f}s  "
          f"max rel_err vs IRLS = {r['max_rel_err']:.2e}")
    print(f"certificates: converged {r['converged']}/{B}, outer iters "
          f"{r['outer_min']}–{r['outer_max']}, max decrement λ̃²/2 = "
          f"{r['max_decrement']:.2e}")
    print(f"warm-started m trajectory (problem 0): {r['m_trajectory']}")
    return r


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logistic", action="store_true",
                    help="run the GLM quickstart (sketched Newton)")
    ap.add_argument("--small", action="store_true", help="CI-scale problem sizes")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    (main_logistic if args.logistic else main)(small=args.small, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
