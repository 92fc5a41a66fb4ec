"""Adaptive sketched-Newton driver for regularized GLMs.

Port of ``repro.core.newton``. Outer loop: damped Newton with a
backtracking line search on

    F(x) = Σ_i ℓ(a_iᵀx, y_i) + ν²/2 · xᵀΛx      (``core.objectives``).

Inner loop: every Newton system (AᵀW(x_t)A + ν²Λ) Δ = −∇F(x_t) is a
weighted instance of the quadratic, solved by the batched padded engine
with W(x_t) as ``Quadratic.row_weights``: the sketch pass folds W^{1/2}
into its one touch of A, and no weighted copy of A is made.

The ladder level found by outer step t starts step t+1 (``init_level``):
the effective dimension of AᵀW(x)A drifts slowly along the Newton path.
The sketch itself is drawn anew each step, from ``fold_seeds(seeds, t)``.
Each problem stops once its approximate Newton decrement λ̃²/2 =
−⟨∇F, Δ⟩/2 clears ``tol``, while the rest of the batch iterates on.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import require_on, resolve_device

from .adaptive_padded import batch_seeds, padded_adaptive_solve_batched
from .level_grams import fold_seeds
from .objectives import GLMObjective, get_objective, glm_grad_and_weights, glm_value
from .quadratic import Quadratic, _as_batched_reg
from .status import SolveStatus


def _line_search(obj: GLMObjective, A, y, nu, lam, x, delta, dec, active, *,
                 backtracks: int, c1: float):
    """Per-problem backtracking Armijo: the largest s ∈ {1, ½, …, 2^{1−K}}
    with F(x + sΔ) ≤ F(x) − c₁·s·λ̃², the K candidates evaluated at once by
    broadcasting. Returns (x⁺, s, made_progress); a problem with no
    admissible step (or a non-descent Δ) keeps x and reports False."""
    F0 = glm_value(obj, A, y, nu, lam, x)                               # (B,)
    ss = 0.5 ** torch.arange(backtracks, dtype=F0.dtype, device=F0.device)  # (K,)
    vals = glm_value(obj, A, y, nu, lam,
                     x[None] + ss[:, None, None] * delta[None])         # (K, B)
    # once c₁sλ̃² falls below F's own resolution an exact comparison rejects
    # every candidate; the eps·(1+|F|) slack accepts steps whose descent the
    # dtype cannot resolve (Newton's local contraction still shrinks λ̃²)
    slack = torch.finfo(F0.dtype).eps * (1.0 + torch.abs(F0))
    ok = ((vals <= F0[None, :] - c1 * ss[:, None] * dec[None, :] + slack[None, :])
          & torch.isfinite(vals))
    any_ok = ok.any(dim=0) & (dec > 0)
    first = torch.argmax(ok.to(torch.int32), dim=0)       # first True (largest s)
    s = torch.where(any_ok, ss[first], torch.zeros_like(F0))
    move = (active & any_ok)[:, None]
    return torch.where(move, x + s[:, None] * delta, x), s, any_ok


def adaptive_newton_solve_batched(
    family: GLMObjective | str,
    A: torch.Tensor,
    y: torch.Tensor,
    nu,
    *,
    lam_diag=None,
    seeds=None,
    m_max: int,
    method: str = "pcg",
    sketch: str = "gaussian",
    newton_iters: int = 30,
    tol: float = 1e-10,
    inner_max_iters: int = 100,
    inner_tol: float = 1e-10,
    rho: float = 0.5,
    ls_backtracks: int = 12,
    ls_c1: float = 1e-4,
    compute_dtype: str = "fp32",
    deadline_s: float | None = None,
    mesh=None,
    device=None,
):
    """Solve a batch of B regularized GLM problems by adaptive sketched
    Newton. A (B, n, d) per problem or (n, d) shared; y (B, n); ν scalar or
    (B,); Λ (d,) or (B, d); ``seeds`` a (B,) tensor of uint32 seeds or one
    seed folded per problem (default 0). Returns (x, stats) with x (B, d) and

    * ``newton_iters``  (B,)  accepted outer steps per problem,
    * ``decrement``     (B,)  final λ̃²/2 (the Newton-level certificate),
    * ``converged``     (B,)  decrement ≤ tol,
    * ``m_trajectory``  (T, B) numpy: inner m_final after each outer step
      (0 once a problem is done),
    * ``m_final``       (B,)  last inner sketch size,
    * ``level``         (B,)  final ladder level,
    * ``inner_iters``   (B,)  inner iterations summed over the steps,
    * ``status`` / ``stalled`` (B,) the GLM verdict.

    ``deadline_s``: wall-clock budget over the whole solve, read between
    outer steps (the first always runs); problems unfinished when it runs
    out keep their iterate and its decrement and report
    ``DEADLINE_EXCEEDED``.

    ``mesh`` (``core.distributed``): every rank holds the whole (A, y), and
    only each Newton system q_t is row-sharded (this rank's block of A and
    of the weights), as in the reference; the gradient, the line search and
    the weights stay replicated. A deadline is read between outer steps
    through one ``host_verdict``: the lead rank's clock decides for every
    rank."""
    dev = resolve_device(device)
    require_on(dev, A=A, y=y)
    seeds = batch_seeds(0 if seeds is None else seeds, y.shape[0], dev)

    def inner_solve(t, q_t, level):
        if mesh is not None:
            from .distributed import shard_quadratic

            q_t = shard_quadratic(q_t, mesh)
        return padded_adaptive_solve_batched(
            q_t, fold_seeds(seeds, t), m_max=m_max, method=method, sketch=sketch,
            max_iters=inner_max_iters, rho=rho, tol=inner_tol, init_level=level,
            compute_dtype=compute_dtype, mesh=mesh, device=dev)

    return _newton_loop(family, A, y, nu, lam_diag, inner_solve,
                        newton_iters=newton_iters, tol=tol,
                        ls_backtracks=ls_backtracks, c1=ls_c1,
                        deadline_s=deadline_s, mesh=mesh)


def _newton_loop(family, A, y, nu, lam_diag, inner_solve, *, newton_iters: int,
                 tol: float, ls_backtracks: int, c1: float = 1e-4,
                 deadline_s: float | None = None, mesh=None):
    """The damped-Newton outer loop shared by the driver and the references
    (one copy of the stopping, line-search and freeze logic).
    ``inner_solve(t, q_t, level)`` returns the Newton step of the weighted
    system ``q_t`` and the engine's stats (driver) or None (references).
    Under ``mesh`` the deadline is the lead rank's (``host_verdict``)."""
    obj = get_objective(family)
    B, d, dev, dt = y.shape[0], A.shape[-1], A.device, A.dtype
    nu_b, lam_b = _as_batched_reg(nu, lam_diag, B, d, dt, dev)

    x = torch.zeros((B, d), dtype=dt, device=dev)
    level = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    dec = torch.full((B,), float("inf"), dtype=dt, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    inner_total = torch.zeros(B, dtype=torch.int64, device=dev)
    inner_status = torch.zeros(B, dtype=torch.int64, device=dev)  # last active verdict
    m_traj = []
    expired = torch.zeros(B, dtype=torch.bool, device=dev)
    t_start = time.perf_counter()

    for t in range(newton_iters):
        if deadline_s is not None and t > 0:
            late = time.perf_counter() - t_start >= deadline_s
            if mesh is not None:
                from .distributed import host_verdict

                _, late = host_verdict(mesh, stop=False, expired=late)
            if late:
                expired = ~done     # spent between outer steps: the verdict below
                break
        g, w = glm_grad_and_weights(obj, A, y, nu_b, lam_b, x)
        q_t = Quadratic(A=A, b=-g, nu=nu_b, lam_diag=lam_b, batched=True,
                        row_weights=w)
        delta, s_in = inner_solve(t, q_t, level)
        dec_t = -torch.sum(g * delta, dim=-1)          # λ̃² = −⟨∇F, Δ⟩
        newly_done = 0.5 * dec_t <= tol
        active = ~done & ~newly_done
        x, _, progressed = _line_search(obj, A, y, nu_b, lam_b, x, delta, dec_t,
                                        active, backtracks=ls_backtracks, c1=c1)
        if s_in is not None:
            # carry the ladder level across steps (the warm m_t)
            level = torch.where(~done, s_in["level"], level)
            inner_total = inner_total + torch.where(~done, s_in["iters"], 0)
            inner_status = torch.where(~done, s_in["status"], inner_status)
            m_traj.append(torch.where(~done, s_in["m_final"], 0).cpu().numpy())
        dec = torch.where(~done, 0.5 * dec_t, dec)
        iters = iters + active.to(torch.int64)
        done = done | newly_done | (active & ~progressed)
        if bool(done.all()):
            break

    m_traj_arr = np.stack(m_traj) if m_traj else np.zeros((0, B), np.int64)
    m_last = np.zeros(B, np.int64)
    for row in m_traj_arr:                     # last non-frozen m per problem
        m_last = np.where(row > 0, row, m_last)
    converged = dec <= tol
    # the outer decrement certifies the answer; a problem that did not
    # converge inherits its last active inner engine failure, else STALLED
    # (frozen by the line search or the outer budget)
    engine_fail = ((inner_status == int(SolveStatus.LEVEL_INVALID))
                   | (inner_status == int(SolveStatus.NAN_POISONED)))
    status = torch.where(
        converged, int(SolveStatus.OK),
        torch.where(expired, int(SolveStatus.DEADLINE_EXCEEDED),
                    torch.where(engine_fail, inner_status, int(SolveStatus.STALLED))))
    stats = {
        "newton_iters": iters,
        "decrement": dec,
        "converged": converged,
        "m_trajectory": m_traj_arr,
        "m_final": torch.as_tensor(m_last, device=dev),
        "level": level,
        "inner_iters": inner_total,
        "status": status,
        "stalled": status == int(SolveStatus.STALLED),
    }
    return x, stats


def adaptive_newton_solve(family, A, y, nu, *, seed=None, **kw):
    """One problem A (n, d), y (n,) as a B = 1 batch over a shared A through
    the batched driver (``seed`` is its sketch seed); scalar stats, and a
    (T,) m trajectory."""
    seeds = None if seed is None else torch.as_tensor(
        seed, dtype=torch.int64, device=A.device).reshape(1)
    x, stats = adaptive_newton_solve_batched(family, A, y[None, :], nu,
                                             seeds=seeds, **kw)
    out = {}
    for k, v in stats.items():
        out[k] = v[:, 0] if k == "m_trajectory" else v[0]
    return x[0], out


def newton_cg_reference(family, A, y, nu, *, lam_diag=None, newton_iters: int = 30,
                        cg_iters: int = 200, tol: float = 1e-10,
                        ls_backtracks: int = 12, device=None):
    """Unpreconditioned Newton-CG baseline: the same outer loop, each Newton
    system solved by plain CG on the weighted quadratic."""
    from .solvers import cg_solve

    require_on(resolve_device(device), A=A, y=y)

    def inner_solve(t, q_t, level):
        delta, _ = cg_solve(q_t, torch.zeros_like(q_t.b), iters=cg_iters)
        return delta, None

    x, _ = _newton_loop(family, A, y, nu, lam_diag, inner_solve,
                        newton_iters=newton_iters, tol=tol,
                        ls_backtracks=ls_backtracks)
    return x


def irls_reference(family, A, y, nu, *, lam_diag=None, newton_iters: int = 50,
                   tol: float = 1e-12, device=None):
    """Exact-Newton (IRLS) reference: the same outer loop, each weighted
    Hessian factorized densely by ``direct_solve``, in A's dtype (fp64 A
    gives an fp64 reference)."""
    from .quadratic import direct_solve

    require_on(resolve_device(device), A=A, y=y)

    def inner_solve(t, q_t, level):
        return direct_solve(q_t), None

    x, _ = _newton_loop(family, A, y, nu, lam_diag, inner_solve,
                        newton_iters=newton_iters, tol=tol, ls_backtracks=20)
    return x
