"""Adaptive sketch-size solvers: Algorithm 4.1 (IHS, Polyak-IHS) and 4.2
(PCG) of the paper, on one problem, driven from the host.

Port of ``repro.core.adaptive``. The outer loop runs on the host and reads
δ̃ after every iteration (one host sync an iteration, as in the
reference: the test below is the algorithm). Sketch sizes are m_init times
powers of two, capped at m_max. The improvement test is exactly Alg. 4.1:

    reject  iff  δ̃⁺ / δ̃_I  >  c(α,ρ) · φ(ρ)^{t+1−I};

on a rejection I ← t, m ← 2m, S is drawn anew, the sketch and the
factorization are redone, and the method restarts at the current iterate.

Phase i's sketch (the first is phase 0; every resketch, a doubling or a
resample at the cap, starts the next) is ``make_sketch(cfg.sketch, m, n,
fold_seeds(seed, i))``, the port's stand-in for the reference's chain of
``jax.random.split``. ``adaptive_solve(sampler=)`` replaces it: a callable
``(phase, m) -> Sketch``, through which the tests replay the reference's
sketches. For m ≥ n no sketch is drawn (the phase still counts): H_S is
factorized from A itself, which makes H_S = H. A weighted problem sketches
W^{1/2}A, materialized here as in the reference (this path is small-scale
by design; the padded engine's weighted pass folds w^{1/2} into its kernel).

The padded engine (``core.adaptive_padded``) is the batched, fixed-shape
form of the same controller that serves requests.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch

from repro_torch.device import require_on, resolve_device

from . import solvers
from .level_grams import fold_seeds
from .precond import SketchedPrecond, factorize
from .quadratic import Quadratic
from .sketches import Sketch, make_sketch


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    method: str = "pcg"          # "ihs" | "pcg" | "polyak"
    sketch: str = "sjlt"         # "gaussian" | "srht" | "sjlt"
    rho: float = 0.5             # ρ = 1/2 matches the paper's observed
                                 # m_final ≈ (1–5)·d_e
    m_init: int = 1
    m_max: int | None = None     # cap; defaults to n (where S = I_n)
    max_iters: int = 500
    tol: float = 1e-12           # stop when δ̃_t ≤ tol · δ̃_0
    sjlt_s: int = 1
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass
class AdaptiveResult:
    x: torch.Tensor
    m_final: int
    n_doublings: int
    iters: int
    m_trace: list            # sketch size after each accepted iteration
    delta_tilde_trace: list  # δ̃ after each accepted iteration
    resketch_times: list     # host seconds (sketch + factorize) per phase
    iter_times: list         # host seconds per accepted or rejected iteration


def _sketch_and_factorize(q: Quadratic, sampler, phase: int, m: int) -> SketchedPrecond:
    A = q.A if q.row_weights is None else torch.sqrt(q.row_weights)[:, None] * q.A
    if m >= q.n:
        # the ceiling: S = I_n makes H_S = H exactly (a one-step solve)
        return factorize(A, q.nu, q.lam_diag)
    return factorize(sampler(phase, m).apply(A), q.nu, q.lam_diag)


def _dtilde_at(P: SketchedPrecond, g: torch.Tensor) -> float:
    return float(0.5 * torch.sum(g * P.solve(g)))


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def adaptive_solve(q: Quadratic, cfg: AdaptiveConfig = AdaptiveConfig(),
                   x0: torch.Tensor | None = None, seed=0, *,
                   sampler: Callable[[int, int], Sketch] | None = None,
                   device=None) -> AdaptiveResult:
    """Algorithm 4.1 specialized by ``cfg.method`` (4.2 when it is "pcg"),
    on one (not batched) problem whose tensors lie on ``device`` (default
    cuda). ``seed`` is a uint32 seed; ``sampler`` overrides the per-phase
    sketch (module docstring)."""
    if q.batched:
        raise ValueError("adaptive_solve takes one problem; the padded engine "
                         "takes batches")
    dev = resolve_device(device)
    require_on(dev, A=q.A, b=q.b, nu=q.nu, lam_diag=q.lam_diag,
               row_weights=q.row_weights, x0=x0)
    if sampler is None:
        base = torch.as_tensor(seed, dtype=torch.int64, device=dev)

        def sampler(phase, m):
            return make_sketch(cfg.sketch, m, q.n, fold_seeds(base, phase),
                               dtype=cfg.dtype, s=cfg.sjlt_s, device=dev)
    if x0 is None:
        x0 = torch.zeros_like(q.b)
    m_max = cfg.m_max if cfg.m_max is not None else q.n
    phi, alpha = solvers.rho_to_rate(cfg.method, cfg.rho)
    c = solvers.c_alpha_rho(alpha, cfg.rho)
    init_fn, step_fn = solvers.METHODS[cfg.method]

    m = max(1, cfg.m_init)
    phase = 0
    t_sk = time.perf_counter()
    P = _sketch_and_factorize(q, sampler, phase, m)
    _sync(P.chol)
    resketch_times = [time.perf_counter() - t_sk]

    g0 = q.grad(x0)
    st = init_fn(q, P, x0)
    dtilde_I = float(st.delta_tilde)
    # the relative stop's reference: δ̃ at x0 under the CURRENT sketch,
    # re-evaluated on every resketch (the m = 1 sketch inflates δ̃_{x0} by up
    # to 1 + m_δ/m, Lemma 2.2, which would fire the criterion far too early)
    dtilde_0 = dtilde_I
    t_rel = 0                    # t − I: iterations since the last restart
    n_doublings = 0
    cap_resamples = 0
    m_trace, dt_trace, iter_times = [m], [dtilde_I], []

    t = 0
    while t < cfg.max_iters:
        t_it = time.perf_counter()
        st_next = step_fn(q, P, st, cfg.rho)
        dtilde_next = float(st_next.delta_tilde)              # the host sync
        iter_times.append(time.perf_counter() - t_it)

        converged = dtilde_next <= cfg.tol * max(dtilde_0, 1e-300)
        threshold = c * (phi ** (t_rel + 1)) * dtilde_I
        # a non-finite δ̃⁺ (a tiny-m preconditioner blowing up) is rejected:
        # NaN compares False against everything, so finiteness comes first
        finite = math.isfinite(dtilde_next)
        reject = (not finite) or dtilde_next > threshold
        if not finite and m >= m_max:
            # cannot grow: resample at the cap rather than accept NaNs
            if cap_resamples > 3:
                break
            cap_resamples += 1
            phase += 1
            P = _sketch_and_factorize(q, sampler, phase, m)
            st = init_fn(q, P, st.x)
            dtilde_I = float(st.delta_tilde)
            dtilde_0 = _dtilde_at(P, g0)
            t_rel = 0
            continue
        if reject and not converged and m < m_max:
            # reject: double the sketch, restart the method at the current x
            n_doublings += 1
            m = min(2 * m, m_max)
            phase += 1
            t_sk = time.perf_counter()
            P = _sketch_and_factorize(q, sampler, phase, m)
            _sync(P.chol)
            resketch_times.append(time.perf_counter() - t_sk)
            st = init_fn(q, P, st.x)
            dtilde_I = float(st.delta_tilde)
            dtilde_0 = _dtilde_at(P, g0)
            t_rel = 0
            continue

        st = st_next
        t += 1
        t_rel += 1
        m_trace.append(m)
        dt_trace.append(dtilde_next)
        if converged:
            break

    return AdaptiveResult(x=st.x, m_final=m, n_doublings=n_doublings, iters=t,
                          m_trace=m_trace, delta_tilde_trace=dt_trace,
                          resketch_times=resketch_times, iter_times=iter_times)


def k_max(m_delta: float, rho: float, m_init: int) -> int:
    """Theorem 4.1's bound on the number of doublings."""
    return max(0, math.ceil(math.log2(max(m_delta / (m_init * rho), 1.0))))
