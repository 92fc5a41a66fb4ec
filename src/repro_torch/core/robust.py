"""Retry / fallback driver over the padded adaptive engine.

Port of ``repro.core.robust.robust_padded_solve_batched`` on its
monolithic path. The guarded engine ends every problem with a truthful
verdict; this layer turns engine failures (STALLED / LEVEL_INVALID /
NAN_POISONED) into finished answers:

1. **Retry with a redrawn sketch.** Failed problems are gathered into a
   sub-batch of the SAME (B, …) shape (unused slots get b = 0 and converge
   at x₀), their seeds are redrawn as ``fold_seeds(seed, attempt)``, and the
   ladder is warm-started at the level the failed attempt reached. Bounded
   by ``max_retries``; a retry that converges is reported ``RETRIED``, and
   one that merely improves δ̃ is adopted as the best iterate while the
   problem stays failed.
2. **Fallback.** Problems still failed go to the dense ``direct_solve``. A
   finite answer is adopted as ``FELL_BACK`` with a NaN δ̃; a non-finite one
   keeps the engine's best finite iterate and its verdict.

The segmented driver (deadlines, checkpoints, preemption) is not ported
yet: those arguments raise ``NotImplementedError`` (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .adaptive_padded import batch_seeds, padded_adaptive_solve_batched
from .level_grams import fold_seeds
from .quadratic import Quadratic, direct_solve
from .status import CONVERGED_STATUSES, ENGINE_FAILURES, SolveStatus

_STAT_KEYS = ("status", "dtilde", "m_final", "iters", "doublings", "level",
              "invalid_levels")


def _gather_quadratic(q: Quadratic, idx: torch.Tensor,
                      dead_mask: torch.Tensor | None = None) -> Quadratic:
    """Sub-batch q[idx]; slots where ``dead_mask`` is True get b = 0 so the
    engine converges on them at x₀ (padding lanes of a retry batch)."""
    b = q.b[idx]
    if dead_mask is not None:
        b = torch.where(dead_mask[:, None], torch.zeros_like(b), b)
    return Quadratic(
        A=q.A if q.shared_A else q.A[idx], b=b, nu=q.nu[idx],
        lam_diag=q.lam_diag[idx],
        row_weights=None if q.row_weights is None else q.row_weights[idx])


def robust_padded_solve_batched(
    q: Quadratic,
    seeds,
    *,
    m_max: int,
    method: str = "pcg",
    sketch: str = "gaussian",
    max_iters: int = 100,
    rho: float = 0.5,
    tol: float = 1e-10,
    gram_hvp: bool | None = None,
    init_level: torch.Tensor | None = None,
    max_retries: int = 2,
    fallback: bool = True,
    compute_dtype: str = "fp32",
    deadline_s: float | None = None,
    segment_trips: int | None = None,
    checkpoint=None,
    preempt=None,
    grams: torch.Tensor | None = None,
    gram_full: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    device=None,
):
    """Solve a batch with engine guards + sketch-redraw retries + fallback.

    Same contract as ``padded_adaptive_solve_batched`` (called with
    ``guards=True``), plus the recovery policy above. Returns ``(x, stats)``:
    x (B, d) on the device, and CPU tensors per problem: ``status``,
    ``retries``, ``fell_back``, ``converged``, ``stalled``, and the engine
    certificates ``dtilde`` (NaN on fallen-back slots), ``m_final``,
    ``iters`` (summed over attempts), ``doublings``, ``level``,
    ``invalid_levels``; ``trips`` sums the loop trips of all attempts.
    ``grams`` / ``gram_full`` / ``x0`` bind to the first attempt only: a
    retry redraws its sketch."""
    if any(v is not None for v in (deadline_s, segment_trips, checkpoint, preempt)):
        raise NotImplementedError(
            "the segmented driver (deadlines, checkpoints, preemption) is not "
            "ported yet (ROADMAP queue 1 item 7)")
    dev = resolve_device(device)
    B = q.batch
    seeds = batch_seeds(seeds, B, dev)

    def solve(qq, ss, lvl, **first):
        return padded_adaptive_solve_batched(
            qq, ss, m_max=m_max, method=method, sketch=sketch,
            max_iters=max_iters, rho=rho, tol=tol, gram_hvp=gram_hvp,
            init_level=lvl, guards=True, compute_dtype=compute_dtype,
            device=dev, **first)

    x, st_dev = solve(q, seeds, init_level, grams=grams, gram_full=gram_full, x0=x0)
    x = x.clone()
    st = {k: st_dev[k].cpu().numpy().copy() for k in _STAT_KEYS}
    trips = int(st_dev["trips"])

    retries = np.zeros(B, dtype=np.int64)
    fell_back = np.zeros(B, dtype=bool)
    failure_codes = [int(s) for s in ENGINE_FAILURES]
    converged_codes = [int(s) for s in CONVERGED_STATUSES]
    failed = np.isin(st["status"], failure_codes)

    for attempt in range(1, max_retries + 1):
        fidx = np.flatnonzero(failed)
        if fidx.size == 0:
            break
        # same-shape padded gather: dead lanes repeat the first failed slot
        pad = np.full(B, fidx[0], dtype=np.int64)
        pad[: fidx.size] = fidx
        live = np.zeros(B, dtype=bool)
        live[: fidx.size] = True
        idx = torch.as_tensor(pad, device=dev)
        q_sub = _gather_quadratic(q, idx, torch.as_tensor(~live, device=dev))
        x_sub, s_dev = solve(q_sub, fold_seeds(seeds[idx], attempt),
                             torch.as_tensor(st["level"][pad], device=dev))
        sub = {k: s_dev[k].cpu().numpy() for k in _STAT_KEYS}
        take_g, take_j = [], []
        for j, g in enumerate(fidx):
            retries[g] = attempt
            st["iters"][g] += sub["iters"][j]
            adopted = int(sub["status"][j]) in converged_codes
            dt_j, dt_g = sub["dtilde"][j], st["dtilde"][g]
            improved = np.isfinite(dt_j) and (not np.isfinite(dt_g) or dt_j < dt_g)
            if adopted or improved:
                take_g.append(g)
                take_j.append(j)
                for k in ("dtilde", "m_final", "doublings", "level", "invalid_levels"):
                    st[k][g] = sub[k][j]
            st["status"][g] = (int(SolveStatus.RETRIED) if adopted
                               else int(sub["status"][j]))
            failed[g] = not adopted
        if take_g:
            x[torch.as_tensor(take_g, device=dev)] = x_sub[
                torch.as_tensor(take_j, device=dev)]
        trips += int(s_dev["trips"])

    fidx = np.flatnonzero(failed)
    if fallback and fidx.size:
        g_idx = torch.as_tensor(fidx, device=dev)
        x_fb = direct_solve(_gather_quadratic(q, g_idx))
        finite = torch.isfinite(x_fb).all(-1).cpu().numpy()
        if finite.any():
            keep = torch.as_tensor(finite, device=dev)
            x[g_idx[keep]] = x_fb[keep]
        for j, g in enumerate(fidx):
            if finite[j]:
                st["status"][g] = int(SolveStatus.FELL_BACK)
                fell_back[g] = True
                st["dtilde"][g] = np.nan    # no sketched certificate

    stats = {k: torch.as_tensor(v) for k, v in st.items()}
    stats.update(
        retries=torch.as_tensor(retries), fell_back=torch.as_tensor(fell_back),
        converged=torch.as_tensor(np.isin(st["status"], converged_codes)),
        stalled=torch.as_tensor(st["status"] == int(SolveStatus.STALLED)),
        trips=trips)
    return x, stats
