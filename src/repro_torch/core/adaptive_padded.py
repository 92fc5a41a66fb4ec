"""The padded adaptive engine on one device: a batch of B problems, each
with its own doubling ladder of sketch sizes, solved in one loop.

Port of ``repro.core.adaptive_padded`` (single device). The sketch is
allocated at m_max once; a problem's active size m_t only visits the
doubling ladder {1, 2, 4, …, m_max}, so the sketched Gram at every level is
computed before the loop by the family's provider in one touch of A
(``core.level_grams``), and every level's H_S⁻¹ is factorized up front
(``precond.shifted_ladder_inverses``). Inside the loop a doubling is a
gather of the precomputed inverse, and the preconditioner is one batched
matvec. Per-problem level validity guards skip ladder levels whose Gram or
factor is not finite, and every problem exits with a truthful status.

The reference's ``lax.while_loop`` runs while ``~all(done) & trips <
limit``. Here the loop is a Python loop of device operations that never
syncs the host inside a trip: a trip after every problem is done is an
exact no-op (every update is gated by the per-problem ``active`` mask, and
the trip counter by a device-side ``running`` flag), so ``trips`` stays the
reference's count, and the host reads ``done.all()`` only every
``CHECK_TRIPS`` trips to leave early. The reference's
``lax.cond(any(reject), do_refactor, …)`` becomes the doubling restart
computed every trip and selected per problem by ``reject``; a problem that
did not reject gathers the inverse it already holds, so the result is
bitwise what the ``cond`` gives.

Weighted problems (``q.row_weights``) and warm-started ladders
(``init_level``) serve the GLM Newton driver (``core.newton``): the sketch
pass folds W^{1/2} into its one touch of A and the true Gram is AᵀWA. The
ladder Grams are λ-free, so ``prepare_path_ladder`` computes them once for
a whole grid of ν, and ``padded_path_solve_batched`` solves every point off
them (``grams=`` / ``gram_full=``), warm-starting x and the ladder level.

The solve splits into public pieces, as in the reference:
``prepare_padded_solve`` (ladder pass, factorizations, guard tables, the
optional true Gram and the initial ``PaddedState``), ``padded_solve_segment``
(the loop up to an integer trip limit), ``finalize_padded_solve`` (status
lattice and certificates) and ``reprecondition_padded`` (a new ladder
mid-solve). ``padded_adaptive_solve_batched`` is prepare → one segment to
the trip cap → finalize, so a solve run as segments back to back
(``core.robust.segmented_padded_solve_batched``) is bitwise the monolithic
one: the same trips run in the same order on the same state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch import trace
from repro_torch.device import check_fp32_matmul, require_on, resolve_device
from repro_torch.kernels.precision import canonical_compute_dtype

from .level_grams import fold_seeds, get_provider
from .precond import shifted_ladder_inverses
from .quadratic import Quadratic, weighted_gram
from .solvers import c_alpha_rho, rho_to_rate
from .status import SolveStatus

PADDED_METHODS = ("ihs", "pcg", "polyak")
# host check of done.all() every this many trips of a segment, counted
# from the segment's start (the value of core/robust.py's
# DEFAULT_SEGMENT_TRIPS, so a default segment checks once, at its start)
CHECK_TRIPS = 32


class PaddedState(NamedTuple):
    x: torch.Tensor            # (B, d) iterates
    x_prev: torch.Tensor       # (B, d) previous iterate (Polyak momentum)
    r: torch.Tensor            # (B, d) PCG residual
    rt: torch.Tensor           # (B, d) preconditioned residual
    p: torch.Tensor            # (B, d) PCG search direction
    grad: torch.Tensor         # (B, d) gradient at x
    level: torch.Tensor        # (B,)  index into the doubling ladder
    t_rel: torch.Tensor        # (B,)  iterations since the last restart
    dtilde_I: torch.Tensor     # (B,)  δ̃ at the last restart
    dtilde: torch.Tensor       # (B,)  current δ̃
    dtilde0: torch.Tensor      # (B,)  δ̃ at x₀ under the current sketch
    x_best: torch.Tensor       # (B, d) best iterate under the current metric
    dt_best: torch.Tensor      # (B,)  its δ̃ (the returned certificate)
    pinv: torch.Tensor         # (B, d, d) H_S⁻¹ at the current level
    iters: torch.Tensor        # (B,)  accepted iterations
    doublings: torch.Tensor    # (B,)
    done: torch.Tensor         # (B,)  bool
    converged: torch.Tensor    # (B,)  bool: δ̃ cleared tol
    nan_hit: torch.Tensor      # (B,)  bool: a non-finite proposal was seen
    trips: torch.Tensor        # ()    loop-trip counter


class PaddedPrecompute(NamedTuple):
    pinvs: torch.Tensor           # (L, B, d, d) remapped per-level H_S⁻¹
    remap: torch.Tensor           # (L, B) valid-level redirect; −1 ⇒ none
    any_valid: torch.Tensor       # (B,) problem has ≥1 usable level
    gram_poisoned: torch.Tensor   # (B,) some level Gram was non-finite
    invalid_levels: torch.Tensor  # (B,) count of skipped levels
    G_full: torch.Tensor | None   # AᵀA, (d, d) shared or (B, d, d); None ⇒
                                  # matrix-free hvp
    mesh: object = None           # row-sharded (core.distributed): the
                                  # matrix-free hvp all-reduces AᵀAv


def _apply_pinv(pinv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """H_S⁻¹ z as one batched matvec — the in-loop hot path."""
    return torch.bmm(pinv, z[:, :, None])[:, :, 0]


def _pdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def doubling_ladder(m_max: int) -> tuple[int, ...]:
    """The sizes m_t can visit: 1, 2, 4, …, capped at m_max."""
    ms, m = [], 1
    while m < m_max:
        ms.append(m)
        m *= 2
    ms.append(m_max)
    return tuple(ms)


def padded_trip_cap(m_max: int, max_iters: int) -> int:
    """Loop-trip safety cap: rejects per problem are bounded by the ladder
    length, so this is a net on top of the per-problem iteration cap."""
    return max_iters + len(doubling_ladder(m_max)) + 3


def _precompute_pinvs(grams: torch.Tensor, q: Quadratic) -> torch.Tensor:
    """(L, B, d, d) explicit H_S⁻¹ at every ladder level."""
    return shifted_ladder_inverses(grams, q.nu, q.lam_diag)


def _gather_pinv(pinvs: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """Each problem's preconditioner at its current ladder level."""
    return pinvs[level, torch.arange(level.shape[0], device=level.device)]


def _valid_level_remap(level_ok: torch.Tensor):
    """Per-(level, problem) redirect around invalid ladder levels: the
    nearest valid level ≥ l, else the largest valid level below, else −1
    (no valid level: LEVEL_INVALID). The reference's two associative scans
    are a reversed cummin and a cummax over the ladder axis."""
    L = level_ok.shape[0]
    idx = torch.arange(L, dtype=torch.int64, device=level_ok.device)[:, None]
    up = torch.where(level_ok, idx, L)
    up = torch.flip(torch.cummin(torch.flip(up, [0]), dim=0).values, [0])
    down = torch.where(level_ok, idx, -1)
    down = torch.cummax(down, dim=0).values
    remap = torch.where(up < L, up, down)
    return remap, level_ok.any(dim=0)


def _compute_ladder_grams(q: Quadratic, seeds, *, m_max, sketch, compute_dtype,
                          mesh=None):
    """(L, B, d, d) ladder-level Grams — the ONE touch of A (under ``mesh``,
    of this rank's block, and one all-reduce)."""
    provider = get_provider(sketch)
    if mesh is not None:
        from .distributed import shard_level_grams

        return shard_level_grams(provider, seeds, q, doubling_ladder(m_max), mesh,
                                 compute_dtype=compute_dtype)
    data = provider.sample(seeds, m_max, q.n)
    return provider.level_grams(data, q, doubling_ladder(m_max),
                                compute_dtype=compute_dtype)


def _ladder_tables(q: Quadratic, grams: torch.Tensor, *, guards: bool):
    """Factorize the ladder and build the guard tables from level Grams:
    (pinvs, remap, any_valid, gram_poisoned, invalid_levels). With
    ``guards=False`` the remap is the identity and validity is assumed."""
    B, dev = q.batch, grams.device
    pinvs = _precompute_pinvs(grams, q)
    L = pinvs.shape[0]
    if not guards:
        remap = torch.arange(L, device=dev)[:, None].expand(L, B)
        return (pinvs, remap, torch.ones(B, dtype=torch.bool, device=dev),
                torch.zeros(B, dtype=torch.bool, device=dev),
                torch.zeros(B, dtype=torch.int64, device=dev))
    gram_ok = torch.isfinite(grams).all(-1).all(-1)                  # (L, B)
    level_ok = gram_ok & torch.isfinite(pinvs).all(-1).all(-1)
    gram_poisoned = (~gram_ok).any(0)
    remap, any_valid = _valid_level_remap(level_ok)
    pinvs = pinvs[remap.clamp(min=0), torch.arange(B, device=dev)[None, :]]
    eye = torch.eye(q.d, dtype=pinvs.dtype, device=dev)
    pinvs = torch.where(any_valid[None, :, None, None], pinvs, eye)
    invalid_levels = (~level_ok).sum(0)
    return pinvs, remap, any_valid, gram_poisoned, invalid_levels


def _gram_precompute(q: Quadratic, gram_hvp: bool | None, mesh=None):
    """The optional true Gram behind ``gram_hvp`` (None = auto: on when
    d ≤ min(n, 1024), n the global row count): AᵀA (d, d) shared or
    (B, d, d), AᵀWA (B, d, d) for a weighted problem, or None for the
    matrix-free hvp (``q.hvp``, which weights the (B, n) intermediate).
    Under ``mesh`` q is this rank's block: its Gram plus one all-reduce."""
    n = q.n
    if mesh is not None:
        from .distributed import all_reduce_sum, n_data_shards

        n *= n_data_shards(mesh)
    if gram_hvp is None:
        gram_hvp = q.d <= min(n, 1024)
    if not gram_hvp:
        return None
    if q.row_weights is not None:
        # AᵀWA per problem (even with shared A) through the chunked Gram:
        # never an (n, d)-sized weighted copy of A
        G = weighted_gram(q.A, q.row_weights)
    elif q.shared_A:
        G = q.A.T @ q.A
    else:
        G = torch.bmm(q.A.transpose(1, 2), q.A)
    return G if mesh is None else all_reduce_sum(G, mesh)


def _hvp_fn(q: Quadratic, G_full, mesh=None):
    """H·v under the precomputed Gram, or matrix-free: q's hvp, or under
    ``mesh`` this block's AᵀWAv all-reduced (the loop's one collective)."""
    if G_full is None and mesh is not None:
        from .distributed import all_reduce_sum

        return lambda v: all_reduce_sum(q.gram_vp(v), mesh) + q._reg(v)
    if G_full is None:
        return q.hvp
    reg = (q.nu ** 2)[:, None] * q.lam_diag
    if G_full.dim() == 2:
        return lambda v: v @ G_full + reg * v
    return lambda v: torch.bmm(G_full, v[:, :, None])[:, :, 0] + reg * v


def _init_padded_state(q: Quadratic, pre: PaddedPrecompute, init_level, tol,
                       x0=None) -> PaddedState:
    B, d, dev = q.batch, q.d, q.device
    top = pre.remap.shape[0] - 1
    hvp = _hvp_fn(q, pre.G_full, pre.mesh)
    if init_level is None:
        lvl0 = torch.zeros(B, dtype=torch.int64, device=dev)
    else:
        lvl0 = init_level.to(torch.int64).clamp(0, top)
    pinv0 = _gather_pinv(pre.pinvs, lvl0)
    if x0 is None:
        x0 = torch.zeros((B, d), dtype=q.b.dtype, device=dev)
        g0 = hvp(x0) - q.b                           # = −b
        rt0 = _apply_pinv(pinv0, -g0)
        dtw = 0.5 * _pdot(-g0, rt0)
        dt0 = dtw
        conv0 = dt0 <= tol * dt0                     # trivially solved (b=0)
    else:
        # warm start: anchor at x0, but keep the convergence scale at the
        # cold b-based δ̃(0), so tol stays relative to the problem
        x0 = x0.to(q.b.dtype)
        g0 = hvp(x0) - q.b
        rt0 = _apply_pinv(pinv0, -g0)
        dtw = 0.5 * _pdot(-g0, rt0)
        dt0 = 0.5 * _pdot(q.b, _apply_pinv(pinv0, q.b))
        conv0 = dtw <= tol * dt0
    zi = torch.zeros(B, dtype=torch.int64, device=dev)
    return PaddedState(
        x=x0, x_prev=x0, r=-g0, rt=rt0, p=rt0, grad=g0,
        level=lvl0, t_rel=zi, dtilde_I=dtw, dtilde=dtw, dtilde0=dt0,
        x_best=x0, dt_best=dtw, pinv=pinv0, iters=zi, doublings=zi,
        done=conv0 | ~pre.any_valid,     # no valid level ⇒ frozen at x₀
        converged=conv0,
        nan_hit=torch.zeros(B, dtype=torch.bool, device=dev),
        trips=torch.zeros((), dtype=torch.int64, device=dev),
    )


def _trip(q, pre, st: PaddedState, hvp, *, method, max_iters, rho, tol,
          guards, top) -> PaddedState:
    """One trip of the adaptive loop (the reference's while_loop body)."""
    fdtype = st.x.dtype
    phi, alpha = rho_to_rate(method, rho)
    c = c_alpha_rho(alpha, rho)
    mu = 1.0 - rho
    _sq = math.sqrt(1.0 - rho)
    mu_p = 2.0 * (1.0 - rho) / (1.0 + _sq)
    beta_p = (1.0 - _sq) / (1.0 + _sq)

    active = ~st.done
    pinv = st.pinv
    # ---- one step of the method under the current preconditioner ----
    if method in ("ihs", "polyak"):
        if method == "ihs":
            x_new = st.x + mu * st.rt
        else:
            x_new = st.x + mu_p * st.rt + beta_p * (st.x - st.x_prev)
        g_new = hvp(x_new) - q.b
        rt_new = _apply_pinv(pinv, -g_new)
        dt_new = 0.5 * _pdot(-g_new, rt_new)
        r_new, p_new = -g_new, st.p
    else:  # pcg
        Hp = hvp(st.p)
        denom = _pdot(st.p, Hp)
        ok = denom > 0
        alpha_s = torch.where(ok, 2.0 * st.dtilde / torch.where(ok, denom, 1.0), 0.0)
        x_new = st.x + alpha_s[:, None] * st.p
        r_new = st.r - alpha_s[:, None] * Hp
        rt_new = _apply_pinv(pinv, r_new)
        dt_new = 0.5 * _pdot(r_new, rt_new)
        okb = st.dtilde > 0
        beta = torch.where(okb, dt_new / torch.where(okb, st.dtilde, 1.0), 0.0)
        p_new = rt_new + beta[:, None] * st.p
        g_new = -r_new

    # ---- per-problem improvement test (Alg 4.1 line 6) ----
    threshold = c * torch.pow(phi, (st.t_rel + 1).to(fdtype)) * st.dtilde_I
    if guards:
        finite_prop = torch.isfinite(dt_new) & torch.isfinite(x_new).all(-1)
    else:
        finite_prop = torch.isfinite(dt_new)
    bad = ~finite_prop | (dt_new > threshold)
    at_cap = st.level >= top
    reject = bad & active & ~at_cap
    # at the ladder cap: accept freely and track the best iterate; clear
    # divergence or a non-finite proposal stalls the problem
    stalled = active & at_cap & (~finite_prop | (dt_new > 1e6 * st.dt_best))
    accept = active & ~reject & ~stalled
    conv_now = accept & (dt_new <= tol * st.dtilde0)

    aB = accept[:, None]
    improved = accept & (dt_new < st.dt_best)
    iters = st.iters + accept.to(torch.int64)
    level = torch.where(reject, torch.clamp(st.level + 1, max=top), st.level)

    # ---- doubling: gather the next level's inverse and restart at x ----
    # (x did not move on a reject, so the restart residual is −grad)
    pinv_new = _gather_pinv(pre.pinvs, level)
    res = -st.grad
    rt_re = _apply_pinv(pinv_new, res)
    dt_re = 0.5 * _pdot(res, rt_re)
    dt0_re = 0.5 * _pdot(q.b, _apply_pinv(pinv_new, q.b))
    rB = reject[:, None]
    x = torch.where(aB, x_new, st.x)
    dtilde = torch.where(accept, dt_new, st.dtilde)
    return PaddedState(
        x=x,
        x_prev=torch.where(rB, x, torch.where(aB, st.x, st.x_prev)),
        r=torch.where(rB, res, torch.where(aB, r_new, st.r)),
        rt=torch.where(rB, rt_re, torch.where(aB, rt_new, st.rt)),
        p=torch.where(rB, rt_re, torch.where(aB, p_new, st.p)),
        grad=torch.where(aB, g_new, st.grad),
        level=level,
        t_rel=torch.where(reject, 0, torch.where(accept, st.t_rel + 1, st.t_rel)),
        dtilde_I=torch.where(reject, dt_re, st.dtilde_I),
        dtilde=torch.where(reject, dt_re, dtilde),
        dtilde0=torch.where(reject, dt0_re, st.dtilde0),
        x_best=torch.where(rB, x, torch.where(improved[:, None], x_new, st.x_best)),
        dt_best=torch.where(reject, dt_re, torch.where(improved, dt_new, st.dt_best)),
        pinv=pinv_new,
        iters=iters,
        doublings=st.doublings + reject.to(torch.int64),
        done=st.done | stalled | conv_now | (iters >= max_iters),
        converged=st.converged | conv_now,
        nan_hit=st.nan_hit | (active & ~finite_prop),
        trips=st.trips + (~st.done.all()).to(torch.int64),
    )


def _run_segment(q: Quadratic, pre: PaddedPrecompute, st: PaddedState,
                 trip_limit: int, *, method: str, max_iters: int, rho: float,
                 tol, guards: bool, tally: dict | None = None) -> PaddedState:
    """The adaptive loop, up to ``trip_limit`` trips in total; ``tally``'s
    ``trips_run`` gains the trips dispatched, counted on the host."""
    hvp = _hvp_fn(q, pre.G_full, pre.mesh)
    top = pre.remap.shape[0] - 1
    ran = 0
    with trace.span("engine.loop") as sp:
        with trace.span("engine.host_read"):
            t0 = int(st.trips)
        for k in range(t0, trip_limit):
            if (k - t0) % CHECK_TRIPS == 0:
                with trace.span("engine.host_read"):
                    done = bool(st.done.all())
                if done:
                    break
            st = _trip(q, pre, st, hvp, method=method, max_iters=max_iters,
                       rho=rho, tol=tol, guards=guards, top=top)
            ran += 1
        sp.set(trips=ran)
    if tally is not None:
        tally["trips_run"] += ran
    return st


def _finalize(pre: PaddedPrecompute, st: PaddedState, *, m_max: int):
    """Status lattice + certificates from the terminal state."""
    dev = st.x.device
    ladder_m = torch.tensor(doubling_ladder(m_max), dtype=torch.int64, device=dev)
    B = pre.remap.shape[1]
    # report the level actually used (the remapped gather target)
    eff_level = pre.remap[st.level, torch.arange(B, device=dev)].clamp(min=0)

    def code(s):
        return torch.tensor(int(s), dtype=torch.int64, device=dev)

    status = torch.where(
        st.converged, code(SolveStatus.OK),
        torch.where(st.nan_hit | pre.gram_poisoned, code(SolveStatus.NAN_POISONED),
                    torch.where(~pre.any_valid, code(SolveStatus.LEVEL_INVALID),
                                code(SolveStatus.STALLED))))
    stats = {"m_final": ladder_m[eff_level], "iters": st.iters,
             "doublings": st.doublings, "dtilde": st.dt_best,
             "level": eff_level, "trips": st.trips,
             "status": status, "converged": st.converged,
             "stalled": status == int(SolveStatus.STALLED),
             "invalid_levels": pre.invalid_levels}
    return st.x_best, stats


def batch_seeds(seeds, B: int, device) -> torch.Tensor:
    """(B,) int64 per-problem seeds from a (B,) tensor, or from one seed
    (an int or 0-d tensor) folded with the problem index."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=device)
    if seeds.dim() == 0:
        return fold_seeds(seeds, torch.arange(B, device=device))
    if seeds.shape != (B,):
        raise ValueError(f"seeds must be (B,) = ({B},), got {tuple(seeds.shape)}")
    return seeds


def prepare_padded_solve(
    q: Quadratic,
    seeds,
    *,
    m_max: int,
    sketch: str = "gaussian",
    gram_hvp: bool | None = None,
    init_level: torch.Tensor | None = None,
    guards: bool = True,
    compute_dtype: str = "fp32",
    tol: float = 1e-10,
    grams: torch.Tensor | None = None,
    gram_full: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    mesh=None,
    device=None,
):
    """Everything before the loop: the one-touch ladder pass (or ``grams=``
    (L, B, d, d) supplied), the batched factorizations and guard tables,
    the optional true Gram (or ``gram_full=``) and the initial state, at
    the origin or at a warm start ``x0`` (B, d). A weighted problem
    (``q.row_weights`` (B, n)) has its weights folded into the sketch pass
    and its true Gram formed as AᵀWA by n-chunks: no (B, n, d) weighted copy
    of A. Under ``mesh`` (a ``DeviceMesh``, ``core.distributed``) q is this
    rank's row block: the ladder pass and the true Gram end in one
    all-reduce each, and everything after them is replicated. Returns
    ``(PaddedPrecompute, PaddedState)``; the precompute is deterministic
    given (q, seeds)."""
    if not q.batched:
        raise ValueError("prepare_padded_solve expects a batched Quadratic")
    dev = resolve_device(device)
    require_on(dev, A=q.A, b=q.b, seeds=seeds if torch.is_tensor(seeds) else None,
               row_weights=q.row_weights, grams=grams, gram_full=gram_full, x0=x0,
               init_level=init_level)
    check_fp32_matmul()
    compute_dtype = canonical_compute_dtype(compute_dtype)
    seeds = batch_seeds(seeds, q.batch, dev)
    with trace.span("engine.prepare"):
        if grams is None:
            with trace.span("ladder.sketch"):
                grams = _compute_ladder_grams(q, seeds, m_max=m_max, sketch=sketch,
                                              compute_dtype=compute_dtype, mesh=mesh)
        with trace.span("ladder.factor"):
            pinvs, remap, any_valid, gram_poisoned, invalid_levels = _ladder_tables(
                q, grams, guards=guards)
        if gram_full is None:
            with trace.span("engine.true_gram"):
                gram_full = _gram_precompute(q, gram_hvp, mesh)
        pre = PaddedPrecompute(
            pinvs=pinvs, remap=remap, any_valid=any_valid,
            gram_poisoned=gram_poisoned, invalid_levels=invalid_levels,
            G_full=gram_full, mesh=mesh)
        return pre, _init_padded_state(q, pre, init_level, tol, x0=x0)


def padded_solve_segment(
    q: Quadratic,
    pre: PaddedPrecompute,
    st: PaddedState,
    trip_limit: int,
    *,
    method: str = "ihs",
    max_iters: int = 100,
    rho: float = 0.5,
    tol: float = 1e-10,
    guards: bool = True,
    device=None,
    tally: dict | None = None,
) -> PaddedState:
    """Advance the loop to ``trip_limit`` trips in total. The state carries
    everything across the boundary, so k-trip segments back to back are
    bitwise the monolithic loop. ``st`` is not modified. ``tally``: a dict
    whose int ``trips_run`` gains the trips this call dispatched."""
    if method not in PADDED_METHODS:
        raise ValueError(f"padded engine supports {PADDED_METHODS}, got {method!r}")
    require_on(resolve_device(device), x=st.x)
    return _run_segment(q, pre, st, int(trip_limit), method=method,
                        max_iters=max_iters, rho=rho, tol=tol, guards=guards,
                        tally=tally)


def finalize_padded_solve(pre: PaddedPrecompute, st: PaddedState, *, m_max: int,
                          device=None):
    """(x_best, stats) from a terminal or deadline-paused state: the
    certificates (δ̃, m_final, level) describe the best finite iterate
    reached, which is what an honest DEADLINE_EXCEEDED answer returns."""
    require_on(resolve_device(device), x=st.x)
    with trace.span("engine.finalize"):
        return _finalize(pre, st, m_max=m_max)


def reprecondition_padded(q: Quadratic, pre: PaddedPrecompute, st: PaddedState,
                          grams: torch.Tensor, *, guards: bool = True, device=None):
    """Rebuild the ladder from replacement level Grams (L, B, d, d) mid-solve
    and re-anchor every unfinished problem at its current iterate: regather
    H_S⁻¹ at its level, recompute r, r̃, p and the δ̃ anchors from the stored
    gradient, and restart best-iterate tracking in the new metric. The true
    Hessian is untouched. Problems already done keep their iterates and
    verdicts bit for bit. Returns the new ``(PaddedPrecompute,
    PaddedState)``."""
    require_on(resolve_device(device), x=st.x, grams=grams)
    pinvs, remap, any_valid2, gram_poisoned2, invalid2 = _ladder_tables(
        q, grams, guards=guards)
    # validity composes: a problem frozen by the old ladder never iterated
    # and stays LEVEL_INVALID; one with no valid level in the new ladder
    # freezes now at its best finite iterate
    any_valid = pre.any_valid & any_valid2
    pre2 = PaddedPrecompute(
        pinvs=pinvs, remap=remap, any_valid=any_valid,
        gram_poisoned=pre.gram_poisoned | gram_poisoned2,
        invalid_levels=torch.maximum(pre.invalid_levels, invalid2),
        G_full=pre.G_full, mesh=pre.mesh)
    active = ~st.done
    pinv_new = _gather_pinv(pinvs, st.level)
    res = -st.grad                                 # b − Hx at the current x
    rt = _apply_pinv(pinv_new, res)
    dt = 0.5 * _pdot(res, rt)
    dt0 = 0.5 * _pdot(q.b, _apply_pinv(pinv_new, q.b))
    aB = active[:, None]
    st2 = st._replace(
        pinv=torch.where(active[:, None, None], pinv_new, st.pinv),
        r=torch.where(aB, res, st.r),
        rt=torch.where(aB, rt, st.rt),
        p=torch.where(aB, rt, st.p),
        x_prev=torch.where(aB, st.x, st.x_prev),   # momentum restart
        t_rel=torch.where(active, 0, st.t_rel),
        x_best=torch.where(aB, st.x, st.x_best),
        dt_best=torch.where(active, dt, st.dt_best),
        dtilde_I=torch.where(active, dt, st.dtilde_I),
        dtilde=torch.where(active, dt, st.dtilde),
        dtilde0=torch.where(active, dt0, st.dtilde0),
        done=st.done | (active & ~any_valid),
    )
    return pre2, st2


def padded_adaptive_solve_batched(
    q: Quadratic,
    seeds,
    *,
    m_max: int,
    method: str = "ihs",
    sketch: str = "gaussian",
    max_iters: int = 100,
    rho: float = 0.5,
    tol: float = 1e-10,
    gram_hvp: bool | None = None,
    init_level: torch.Tensor | None = None,
    guards: bool = True,
    compute_dtype: str = "fp32",
    grams: torch.Tensor | None = None,
    gram_full: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    mesh=None,
    device=None,
):
    """Adaptive solve of a batch of B problems on one device, or row-sharded
    over ``mesh`` (q then this rank's block; ``prepare_padded_solve``).

    ``q`` is a batched ``Quadratic`` with per-problem A (B, n, d) or shared
    A (n, d); ``seeds`` is a (B,) int64 tensor of uint32 seeds (problem b's
    sketch depends only on seeds[b]) or one seed folded per problem.
    Returns (x, stats): x (B, d) and per-problem stats tensors (m_final,
    iters, doublings, δ̃ ``dtilde``, ladder ``level``, ``status``,
    ``converged``, ``stalled``, ``invalid_levels``) plus the scalar loop
    ``trips`` (the trips the problems needed) and ``trips_run`` (an int: the
    trips the host dispatched, the no-op ones after the last problem was
    done included).

    ``grams`` / ``gram_full`` supply the λ-free level Grams (L, B, d, d) and
    the true Gram and skip the sketch pass; ``init_level`` (B,) starts each
    problem's ladder at that level; ``x0`` (B, d) warm-starts the iterate.
    ``guards`` (default on) skips ladder levels whose Gram or inverse is not
    finite and reports truthful statuses. All tensors must lie on
    ``device`` (default cuda).

    This is ``prepare_padded_solve`` → ``padded_solve_segment`` to the trip
    cap → ``finalize_padded_solve``."""
    if not q.batched:
        raise ValueError("use padded_adaptive_solve for single problems")
    if method not in PADDED_METHODS:
        raise ValueError(f"padded engine supports {PADDED_METHODS}, got {method!r}")
    pre, st = prepare_padded_solve(
        q, seeds, m_max=m_max, sketch=sketch, gram_hvp=gram_hvp,
        init_level=init_level, guards=guards, compute_dtype=compute_dtype,
        tol=tol, grams=grams, gram_full=gram_full, x0=x0, mesh=mesh, device=device)
    tally = {"trips_run": 0}
    st = padded_solve_segment(q, pre, st, padded_trip_cap(m_max, max_iters),
                              method=method, max_iters=max_iters, rho=rho,
                              tol=tol, guards=guards, device=device, tally=tally)
    x, stats = finalize_padded_solve(pre, st, m_max=m_max, device=device)
    stats["trips_run"] = tally["trips_run"]
    return x, stats


def prepare_path_ladder(
    q: Quadratic,
    seeds,
    *,
    m_max: int,
    sketch: str = "gaussian",
    gram_hvp: bool | None = None,
    compute_dtype: str = "fp32",
    mesh=None,
    device=None,
):
    """The λ-free precompute of a whole regularization path: the one-touch
    ladder pass and the optional true Gram. Neither reads ν or Λ (the ν²Λ
    shift enters only at factorization), so the returned ``(grams,
    gram_full)`` serves every ν of a grid through ``grams=`` /
    ``gram_full=``; it is also the unit the service's ladder cache stores.
    ``gram_full`` is None when the hvp stays matrix-free. Under ``mesh`` q
    is this rank's block and both come back all-reduced, replicated."""
    if not q.batched:
        raise ValueError("prepare_path_ladder expects a batched Quadratic")
    dev = resolve_device(device)
    require_on(dev, A=q.A, seeds=seeds if torch.is_tensor(seeds) else None,
               row_weights=q.row_weights)
    check_fp32_matmul()
    seeds = batch_seeds(seeds, q.batch, dev)
    grams = _compute_ladder_grams(q, seeds, m_max=m_max, sketch=sketch,
                                  compute_dtype=canonical_compute_dtype(compute_dtype),
                                  mesh=mesh)
    return grams, _gram_precompute(q, gram_hvp, mesh)


def path_nus(nus, B: int, dtype, device) -> torch.Tensor:
    """A λ grid as (P, B): a (P,) grid is shared by every problem."""
    nus = torch.as_tensor(nus, dtype=dtype, device=device)
    if nus.dim() == 1:
        nus = nus[:, None].expand(nus.shape[0], B)
    if nus.dim() != 2 or nus.shape[1] != B:
        raise ValueError(f"nus must be (P,) or (P, {B}), got {tuple(nus.shape)}")
    return nus


def padded_path_solve_batched(
    q: Quadratic,
    seeds,
    nus,
    *,
    m_max: int,
    method: str = "ihs",
    sketch: str = "gaussian",
    max_iters: int = 100,
    rho: float = 0.5,
    tol: float = 1e-10,
    gram_hvp: bool | None = None,
    init_level: torch.Tensor | None = None,
    guards: bool = True,
    compute_dtype: str = "fp32",
    warm_start: bool = True,
    mesh=None,
    device=None,
):
    """A regularization path: the whole ν grid off ONE sketch pass (under
    ``mesh``, of this rank's row block, all-reduced once).

    ``q`` is a batched Quadratic whose own ν is ignored; ``nus`` is the grid,
    (P,) shared by the batch or (P, B) per problem. The ladder Grams and the
    true Gram come from ``prepare_path_ladder`` once; each point pays only
    its ν²Λ-shifted factorizations and its solve, through
    ``padded_adaptive_solve_batched`` with ``grams=`` / ``gram_full=``, so a
    point is bitwise a single-ν solve handed the same ladder, warm start and
    init level. ``warm_start`` (default on) starts point p+1 at point p's x
    and final ladder level; ``init_level`` seeds the first point.

    Returns ``(xs, stats)``: xs (P, B, d), the per-point stats stacked to
    (P, B) (``trips`` to (P,)), ``trips_run`` summed over the path, and
    ``sketch_passes`` = 1."""
    if not q.batched:
        raise ValueError("padded_path_solve_batched expects a batched Quadratic")
    dev = resolve_device(device)
    nus = path_nus(nus, q.batch, q.b.dtype, dev)
    seeds = batch_seeds(seeds, q.batch, dev)
    grams, gram_full = prepare_path_ladder(
        q, seeds, m_max=m_max, sketch=sketch, gram_hvp=gram_hvp,
        compute_dtype=compute_dtype, mesh=mesh, device=dev)
    xs, per_point = [], []
    x_prev, lvl = None, init_level
    for p in range(nus.shape[0]):
        q_p = dataclasses.replace(q, nu=nus[p])
        x, stats = padded_adaptive_solve_batched(
            q_p, seeds, m_max=m_max, method=method, sketch=sketch,
            max_iters=max_iters, rho=rho, tol=tol, gram_hvp=gram_hvp,
            init_level=lvl, guards=guards, compute_dtype=compute_dtype,
            grams=grams, gram_full=gram_full, x0=x_prev, mesh=mesh, device=dev)
        xs.append(x)
        per_point.append(stats)
        if warm_start:
            x_prev, lvl = x, stats["level"]
    out = {k: torch.stack([s[k] for s in per_point]) for k in per_point[0] if k != "trips_run"}
    out["trips_run"] = sum(s["trips_run"] for s in per_point)
    out["sketch_passes"] = 1
    return torch.stack(xs), out


def padded_adaptive_solve(
    q: Quadratic,
    seed,
    *,
    m_max: int,
    method: str = "ihs",
    sketch: str = "gaussian",
    max_iters: int = 100,
    rho: float = 0.5,
    tol: float = 1e-10,
    compute_dtype: str = "fp32",
    device=None,
):
    """Adaptive solve of one problem as a batch through the padded engine.
    A vector RHS (d,) is a B = 1 batch whose sketch seed is ``seed`` itself,
    and gets scalar stats; a (d, c) matrix RHS is a shared-A batch over its
    columns, with ``seed`` a (c,) tensor of per-column seeds or one seed
    folded per column, and gets per-column stats. A batched ``q`` goes to
    ``padded_adaptive_solve_batched``."""
    kw = dict(m_max=m_max, method=method, sketch=sketch, max_iters=max_iters,
              rho=rho, tol=tol, compute_dtype=compute_dtype, device=device)
    if q.batched:
        return padded_adaptive_solve_batched(q, seed, **kw)
    dev = resolve_device(device)
    matrix_rhs = q.b.dim() == 2
    if matrix_rhs:
        B, b = q.b.shape[1], q.b.T.contiguous()
        seeds = batch_seeds(seed, B, dev)
    else:
        B, b = 1, q.b[None, :]
        seeds = torch.as_tensor(seed, dtype=torch.int64, device=dev).reshape(1)
    nu = torch.as_tensor(q.nu, dtype=q.b.dtype, device=dev).reshape(-1).expand(B)
    qb = Quadratic(A=q.A, b=b, nu=nu.clone(), lam_diag=q.lam_diag.expand(B, q.d).clone(),
                   batched=True,
                   row_weights=None if q.row_weights is None
                   else q.row_weights.expand(B, q.n))
    x, stats = padded_adaptive_solve_batched(qb, seeds, **kw)
    if matrix_rhs:
        return x.T, stats
    return x[0], {k: v[0] if torch.is_tensor(v) and v.dim() else v
                  for k, v in stats.items()}
