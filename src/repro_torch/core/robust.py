"""Retry / fallback / deadline driver over the padded adaptive engine.

Port of ``repro.core.robust``. The guarded engine ends every problem with a
truthful verdict; this layer turns engine failures (STALLED / LEVEL_INVALID
/ NAN_POISONED) into finished answers, and bounds a solve in wall time:

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
3. **Segmented execution** (``segmented_padded_solve_batched``): the same
   solve as segments of ``segment_trips`` loop trips, the host checking the
   wall clock between them. A segment is the monolithic loop under a trip
   limit and the whole ``PaddedState`` crosses each boundary, so a
   segmented solve is bitwise the monolithic one. ``deadline_s`` stops
   dispatching once the budget is spent and finalizes the paused state:
   unfinished problems return their best finite iterate, its real δ̃ and
   ``DEADLINE_EXCEEDED``; problems that finished in time keep their
   verdicts. ``on_segment`` may hand back replacement level Grams, and the
   driver repreconditions mid-solve (elastic shard loss).
   **Preemption and crashes:** ``preempt=`` (an ``ft.PreemptionHandler``)
   is polled between segments; when it is set, the state is checkpointed
   through ``ft.checkpoint.CheckpointManager`` (``checkpoint=``) and
   ``PreemptedError`` is raised. A restarted process (``resume=True``)
   restores the last committed segment and goes on: the precompute is
   deterministic given (q, seeds) and is recomputed, not stored, so the
   resumed solve is bitwise the uninterrupted one. Saves every
   ``checkpoint_every`` segments bound what a kill -9 loses.

``robust_path_solve_batched`` runs this policy at every point of a ν grid
off one shared λ-free ladder.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import trace
from repro_torch.device import resolve_device

from .adaptive_padded import (
    PaddedState,
    batch_seeds,
    doubling_ladder,
    finalize_padded_solve,
    padded_adaptive_solve_batched,
    padded_solve_segment,
    padded_trip_cap,
    path_nus,
    prepare_padded_solve,
    prepare_path_ladder,
    reprecondition_padded,
)
from .level_grams import fold_seeds
from .quadratic import Quadratic, direct_solve
from .status import CONVERGED_STATUSES, ENGINE_FAILURES, SolveStatus

DEFAULT_SEGMENT_TRIPS = 32

_STAT_KEYS = ("status", "dtilde", "m_final", "iters", "doublings", "level",
              "invalid_levels")
_PATH_STAT_KEYS = _STAT_KEYS + ("retries", "fell_back", "converged", "stalled")


class PreemptedError(RuntimeError):
    """A solve was preempted between segments. Its state was checkpointed
    first (when a checkpoint manager was attached), so a restarted process
    resumes from ``segment`` exactly."""

    def __init__(self, segment: int, checkpoint_dir=None):
        self.segment = segment
        self.checkpoint_dir = checkpoint_dir
        where = f" (checkpointed to {checkpoint_dir})" if checkpoint_dir else ""
        super().__init__(f"solve preempted at segment {segment}{where}; "
                         f"re-run with resume=True to continue")


def _as_checkpoint_manager(checkpoint):
    """A ready CheckpointManager (duck-typed) or a directory path. The ft
    import stays inside the function: ft is built on core, not core on ft."""
    if checkpoint is None or hasattr(checkpoint, "latest_step"):
        return checkpoint
    if isinstance(checkpoint, (str, os.PathLike)):
        from repro_torch.ft.checkpoint import CheckpointManager

        return CheckpointManager(checkpoint)
    raise TypeError(f"checkpoint must be a CheckpointManager or a path, got "
                    f"{type(checkpoint).__name__}")


def _solve_fingerprint(q: Quadratic, n: int, *, m_max, method, sketch, max_iters) -> str:
    """Guards a resume against a checkpoint of another solve: a restored
    state means something only under the same shapes and the same
    (recomputed) precompute. The reference's string, with ``n`` the global
    row count, so a checkpoint moves between the packages."""
    sk = getattr(sketch, "name", None) or str(sketch)
    return f"{q.batch}x{n}x{q.d}:m{m_max}:{method}:{sk}:mi{max_iters}"


def _gather_quadratic(q: Quadratic, idx: torch.Tensor,
                      dead_mask: torch.Tensor | None = None) -> Quadratic:
    """Sub-batch q[idx]; slots where ``dead_mask`` is True get b = 0 so the
    engine converges on them at x₀ (padding lanes of a retry batch)."""
    b = q.b[idx]
    if dead_mask is not None:
        b = torch.where(dead_mask[:, None], torch.zeros_like(b), b)
    return Quadratic(
        A=q.A if q.shared_A else q.A[idx], b=b, nu=q.nu[idx],
        lam_diag=q.lam_diag[idx], batched=True,
        row_weights=None if q.row_weights is None else q.row_weights[idx])


def segmented_padded_solve_batched(
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
    guards: bool = True,
    compute_dtype: str = "fp32",
    segment_trips: int = DEFAULT_SEGMENT_TRIPS,
    deadline_s: float | None = None,
    checkpoint=None,
    checkpoint_every: int = 1,
    resume: bool = True,
    preempt=None,
    on_segment=None,
    grams: torch.Tensor | None = None,
    gram_full: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    mesh=None,
    device=None,
):
    """The segmented host driver: ``prepare`` once, then run the loop
    ``segment_trips`` trips at a time, checking preemption and the deadline
    between segments, and ``finalize`` whatever state the loop ends in.

    Same contract and return value as ``padded_adaptive_solve_batched``
    (bitwise equal when nothing fires), plus:

    * ``deadline_s`` — wall-clock budget from entry. The first segment
      always runs; after it no segment starts past the deadline. The card
      is synchronized after each segment, so the clock measures solve time,
      not enqueue time. Unfinished problems are finalized with
      ``DEADLINE_EXCEEDED``, their best finite iterate and its real δ̃.
    * ``checkpoint`` — a CheckpointManager (or a directory) that stores
      ``PaddedState._asdict()`` every ``checkpoint_every`` segments, and on
      preemption; each save is blocking, so a COMMITTED marker never leads
      its data.
    * ``resume`` — restore the last committed segment of ``checkpoint``
      before solving (nothing happens when there is none). The caller
      presents the same problem and seeds; a fingerprint in the
      checkpoint's ``extra`` refuses another solve's state with a
      ValueError.
    * ``preempt`` — an object with a ``should_stop`` attribute
      (``ft.PreemptionHandler``), polled before each segment; when it is
      set, the state is saved and ``PreemptedError`` raised.
    * ``on_segment`` — ``fn(segment, state) -> grams | None``; replacement
      (L, B, d, d) level Grams trigger ``reprecondition_padded``, with the
      ladder's length of extra trips for the re-climb.
    * ``grams`` / ``gram_full`` / ``x0`` — forwarded to ``prepare``.

    Extra stats: ``segments`` (segments run in this call), ``resumed``,
    ``deadline_hit``, and ``verdicts`` / ``verdict_s`` (the host verdicts a
    sharded solve took and their seconds); ``trips_run`` counts the trips
    the segments dispatched.

    ``mesh``: q is this rank's row block (``core.distributed``), and every
    host decision reads replicated values. The loop state is replicated
    (its Grams are all-reduced), so the done mask and the trip count agree
    on every rank; a deadline or a preemption flag is read through one
    ``host_verdict`` per segment boundary, and only there: each rank's flag
    counts (one preempted rank stops them all, at the same segment), and
    only the lead rank's clock. The lead rank alone writes the checkpoint,
    and every rank waits at a barrier until it is committed. Every rank
    resumes the lead rank's latest step (one ``lead_values``), from a
    directory every rank must see: a rank that cannot read that step, or
    whose fingerprint differs, fails one more verdict, and then every rank
    raises ValueError. The fingerprint carries the global n
    (q.n times the data shards), so a checkpoint moves between the
    packages, and a resume onto another shard count passes it. Such a
    resume recomputes ``prepare`` with the new blocks' sketches, so it
    answers within the solve's tolerance, not bitwise."""
    if int(segment_trips) < 1:
        raise ValueError(f"segment_trips must be at least 1, got {segment_trips}")
    t0 = time.perf_counter()
    dev = resolve_device(device)
    pre, st = prepare_padded_solve(
        q, seeds, m_max=m_max, sketch=sketch, gram_hvp=gram_hvp,
        init_level=init_level, guards=guards, compute_dtype=compute_dtype,
        tol=tol, grams=grams, gram_full=gram_full, x0=x0, mesh=mesh, device=dev)
    trip_budget = padded_trip_cap(m_max, max_iters)
    ladder_len = len(doubling_ladder(m_max))
    ckpt = _as_checkpoint_manager(checkpoint)
    n_global = q.n
    if mesh is not None:
        from .distributed import (
            barrier,
            data_index,
            host_verdict,
            is_lead,
            lead_values,
            n_data_shards,
        )

        n_global *= n_data_shards(mesh)
    fingerprint = _solve_fingerprint(q, n_global, m_max=m_max, method=method,
                                     sketch=sketch, max_iters=max_iters)
    # seg numbers segments across restarts, seg_ran those of this call
    seg = seg_ran = 0
    resumed = False
    step = ckpt.latest_step() if ckpt is not None and resume else None
    if mesh is not None and ckpt is not None and resume:
        # one decision for every rank: the lead rank's latest step (-1: none)
        (lead_step,) = lead_values(mesh, -1 if step is None else step)
        step = None if lead_step < 0 else int(lead_step)
    if step is not None:
        err = None
        try:
            restored, extra = ckpt.restore(st._asdict(), step=step)
            got = extra.get("fingerprint")
            if got != fingerprint:
                raise ValueError(
                    f"checkpoint fingerprint mismatch: checkpoint is for {got!r}, this "
                    f"solve is {fingerprint!r}; refusing to resume onto another problem")
        except Exception as e:
            if mesh is None:
                raise
            err = e
        if mesh is not None:
            # every rank restores the lead rank's step, or every rank raises
            failed, _ = host_verdict(mesh, stop=err is not None, expired=False)
            if failed:
                raise ValueError(
                    f"rank {data_index(mesh)} cannot resume step {step} of {ckpt.dir}: "
                    f"{err if err is not None else 'another rank cannot read it'}") from err
        st = PaddedState(**restored)
        seg = int(extra.get("segment", step))
        trip_budget = int(extra.get("trip_budget", trip_budget))
        resumed = True

    def save(segment: int):
        # sharded: the state is replicated, so the lead rank writes it and
        # every rank waits until it is committed
        if mesh is None or is_lead(mesh):
            ckpt.save(segment, st._asdict(), blocking=True,
                      extra={"segment": segment, "fingerprint": fingerprint,
                             "trip_budget": trip_budget})
        if mesh is not None:
            barrier(mesh)

    deadline_hit = False
    verdicts, verdict_s = 0, 0.0
    tally = {"trips_run": 0}
    while True:
        with trace.span("engine.host_read"):
            trips_now = int(st.trips)
            finished = bool(st.done.all())
        if finished or trips_now >= trip_budget:
            break
        stop = preempt is not None and bool(getattr(preempt, "should_stop", False))
        late = deadline_s is not None and time.perf_counter() - t0 >= deadline_s
        if mesh is not None and (preempt is not None or deadline_s is not None):
            tv = time.perf_counter()
            stop, late = host_verdict(mesh, stop=stop, expired=late)
            verdicts += 1
            verdict_s += time.perf_counter() - tv
        if stop:
            if ckpt is not None:
                save(seg)
            raise PreemptedError(seg, getattr(ckpt, "dir", None))
        if late and seg_ran > 0:            # the first segment always runs
            deadline_hit = True
            break
        limit = min(trip_budget, trips_now + int(segment_trips))
        st = padded_solve_segment(q, pre, st, limit, method=method,
                                  max_iters=max_iters, rho=rho, tol=tol,
                                  guards=guards, device=dev, tally=tally)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seg += 1
        seg_ran += 1
        if on_segment is not None:
            new_grams = on_segment(seg, st)
            if new_grams is not None:
                pre, st = reprecondition_padded(q, pre, st, new_grams,
                                                guards=guards, device=dev)
                trip_budget += ladder_len   # re-anchored problems may re-climb
        if ckpt is not None and seg_ran % max(1, checkpoint_every) == 0:
            save(seg)

    x, stats = finalize_padded_solve(pre, st, m_max=m_max, device=dev)
    if deadline_hit:
        # a problem that is not done has not converged: its verdict is the
        # deadline; finished problems keep theirs bit for bit
        status = torch.where(st.done, stats["status"], int(SolveStatus.DEADLINE_EXCEEDED))
        stats.update(status=status, stalled=status == int(SolveStatus.STALLED))
    stats.update(segments=seg_ran, resumed=resumed, deadline_hit=deadline_hit,
                 verdicts=verdicts, verdict_s=verdict_s, trips_run=tally["trips_run"])
    return x, stats


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
    checkpoint_every: int = 1,
    resume: bool = True,
    preempt=None,
    on_segment=None,
    grams: torch.Tensor | None = None,
    gram_full: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    mesh=None,
    device=None,
):
    """Solve a batch with engine guards + sketch-redraw retries + fallback.

    Same contract as ``padded_adaptive_solve_batched`` (called with
    ``guards=True``), plus the recovery policy above. Returns ``(x, stats)``:
    x (B, d) on the device, and CPU tensors per problem: ``status``,
    ``retries``, ``fell_back``, ``converged``, ``stalled``, and the engine
    certificates ``dtilde`` (NaN on fallen-back slots), ``m_final``,
    ``iters`` (summed over attempts), ``doublings``, ``level``,
    ``invalid_levels``; ``trips``, ``trips_run`` (the trips dispatched, an
    int) and ``segments`` sum over all attempts, and ``resumed`` /
    ``deadline_hit`` are the first attempt's.

    Setting any of ``deadline_s``, ``segment_trips``, ``checkpoint``,
    ``preempt`` or ``on_segment`` routes attempts through
    ``segmented_padded_solve_batched``; with none set the path, and the
    numbers, are the monolithic ones. ``deadline_s`` is a budget over the
    WHOLE call: the first attempt gets all of it, each retry what remains,
    and retries and the fallback are skipped once it is spent. A
    ``DEADLINE_EXCEEDED`` slot is never retried, and a retry that itself
    runs out of time keeps the previous verdict. ``grams`` / ``gram_full``
    / ``x0`` / ``on_segment`` bind to the first attempt only: a retry
    redraws its sketch. So do ``checkpoint`` / ``resume`` / ``preempt``: a
    retry is another solve, which must neither overwrite nor resume from
    the first attempt's checkpoint.

    ``mesh``: q is this rank's row block (``core.distributed``); every
    attempt runs sharded and the fallback's Gram is all-reduced. Under a
    deadline the lead rank's remaining budget is broadcast before each
    attempt and before the fallback (``lead_values``), so every rank
    retries, falls back and stops on the same clock."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    B = q.batch
    seeds = batch_seeds(seeds, B, dev)
    segmented = any(v is not None for v in (deadline_s, segment_trips, checkpoint,
                                            preempt, on_segment))
    seg_trips = DEFAULT_SEGMENT_TRIPS if segment_trips is None else int(segment_trips)

    def remaining():
        if deadline_s is None:
            return None
        left = deadline_s - (time.perf_counter() - t0)
        if mesh is not None:
            from .distributed import lead_values

            (left,) = lead_values(mesh, left)
        return left

    def solve(qq, ss, lvl, attempt, *, budget=None, **first):
        kw = dict(m_max=m_max, method=method, sketch=sketch, max_iters=max_iters,
                  rho=rho, tol=tol, gram_hvp=gram_hvp, init_level=lvl, guards=True,
                  compute_dtype=compute_dtype, mesh=mesh, device=dev)
        with trace.span("robust.attempt", attempt=attempt):
            if not segmented:
                return padded_adaptive_solve_batched(qq, ss, **kw, **first)
            return segmented_padded_solve_batched(qq, ss, **kw, **first,
                                                  segment_trips=seg_trips,
                                                  deadline_s=budget,
                                                  checkpoint_every=checkpoint_every)

    first = dict(grams=grams, gram_full=gram_full, x0=x0)
    if segmented:
        first.update(on_segment=on_segment, checkpoint=checkpoint, resume=resume,
                     preempt=preempt)
    x, st_dev = solve(q, seeds, init_level, 0, budget=remaining(), **first)
    x = x.clone()
    with trace.span("robust.to_host"):
        st = {k: st_dev[k].cpu().numpy().copy() for k in _STAT_KEYS}
        trips = int(st_dev["trips"])
    trips_run = st_dev["trips_run"]
    segments = int(st_dev.get("segments", 0))
    resumed = bool(st_dev.get("resumed", False))
    deadline_hit = bool(st_dev.get("deadline_hit", False))

    retries = np.zeros(B, dtype=np.int64)
    fell_back = np.zeros(B, dtype=bool)
    failure_codes = [int(s) for s in ENGINE_FAILURES]
    converged_codes = [int(s) for s in CONVERGED_STATUSES]
    failed = np.isin(st["status"], failure_codes)

    for attempt in range(1, max_retries + 1):
        fidx = np.flatnonzero(failed)
        if fidx.size == 0:
            break
        budget = remaining()
        if budget is not None and budget <= 0:
            break                       # deadline spent: the verdicts stand
        # same-shape padded gather: dead lanes repeat the first failed slot
        pad = np.full(B, fidx[0], dtype=np.int64)
        pad[: fidx.size] = fidx
        live = np.zeros(B, dtype=bool)
        live[: fidx.size] = True
        idx = torch.as_tensor(pad, device=dev)
        q_sub = _gather_quadratic(q, idx, torch.as_tensor(~live, device=dev))
        x_sub, s_dev = solve(q_sub, fold_seeds(seeds[idx], attempt),
                             torch.as_tensor(st["level"][pad], device=dev), attempt,
                             budget=budget)
        with trace.span("robust.to_host"):
            sub = {k: s_dev[k].cpu().numpy() for k in _STAT_KEYS}
            trips += int(s_dev["trips"])
        trips_run += s_dev["trips_run"]
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
            # a retry that ran out of budget keeps the previous verdict
            if int(sub["status"][j]) != int(SolveStatus.DEADLINE_EXCEEDED):
                st["status"][g] = (int(SolveStatus.RETRIED) if adopted
                                   else int(sub["status"][j]))
            failed[g] = not adopted
        if take_g:
            x[torch.as_tensor(take_g, device=dev)] = x_sub[
                torch.as_tensor(take_j, device=dev)]
        segments += int(s_dev.get("segments", 0))

    fidx = np.flatnonzero(failed)
    budget = remaining()
    if fallback and fidx.size and (budget is None or budget > 0):
        g_idx = torch.as_tensor(fidx, device=dev)
        reduce = None
        if mesh is not None:
            from .distributed import all_reduce_sum

            def reduce(G):
                return all_reduce_sum(G.contiguous(), mesh)
        with trace.span("robust.fallback"):
            x_fb = direct_solve(_gather_quadratic(q, g_idx), reduce=reduce)
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
        trips=trips, trips_run=trips_run, segments=segments, resumed=resumed,
        deadline_hit=deadline_hit)
    return x, stats


def robust_path_solve_batched(
    q: Quadratic,
    seeds,
    nus,
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
    warm_start: bool = True,
    grams: torch.Tensor | None = None,
    gram_full: torch.Tensor | None = None,
    mesh=None,
    device=None,
):
    """A regularization path with the full recovery policy at every point
    (under ``mesh``, on this rank's row block).

    The λ-free ladder (and the true Gram) is paid once through
    ``prepare_path_ladder``, or supplied as ``grams=`` / ``gram_full=`` (the
    service's ladder cache), and every grid point runs
    ``robust_padded_solve_batched`` off it, warm-starting x and the ladder
    level from the previous point. Retries and the fallback act per point:
    a retry redraws the sketch of that point's failed slots (one more sketch
    pass on the gathered sub-batch), and a fallen-back slot still
    warm-starts the next point (its x is finite).

    ``nus`` is (P,) shared or (P, B) per problem; ``q.nu`` is ignored.
    Returns ``(xs, stats)``: xs (P, B, d); the per-problem stats stacked to
    (P, B); ``trips``, ``trips_run`` and ``segments`` summed over the path; and
    ``sketch_passes``, 1 for the path plus 1 per retry attempt."""
    if not q.batched:
        raise ValueError("robust_path_solve_batched expects a batched Quadratic")
    dev = resolve_device(device)
    B = q.batch
    seeds = batch_seeds(seeds, B, dev)
    nus = path_nus(nus, B, q.b.dtype, dev)
    if grams is None:
        grams, gram_full = prepare_path_ladder(
            q, seeds, m_max=m_max, sketch=sketch, gram_hvp=gram_hvp,
            compute_dtype=compute_dtype, mesh=mesh, device=dev)
    xs, per_point = [], []
    x_prev, lvl = None, init_level
    sketch_passes = 1
    for p in range(nus.shape[0]):
        q_p = dataclasses.replace(q, nu=nus[p])
        x, stats = robust_padded_solve_batched(
            q_p, seeds, m_max=m_max, method=method, sketch=sketch,
            max_iters=max_iters, rho=rho, tol=tol, gram_hvp=gram_hvp,
            init_level=lvl, max_retries=max_retries, fallback=fallback,
            compute_dtype=compute_dtype, grams=grams, gram_full=gram_full,
            x0=x_prev, mesh=mesh, device=dev)
        # each retry attempt that ran redrew a sketch on the sub-batch
        sketch_passes += int(stats["retries"].max())
        xs.append(x)
        per_point.append(stats)
        if warm_start:
            x_prev, lvl = x, stats["level"].to(dev)
    out = {k: torch.stack([s[k] for s in per_point]) for k in _PATH_STAT_KEYS}
    out["trips"] = sum(int(s["trips"]) for s in per_point)
    out["trips_run"] = sum(s["trips_run"] for s in per_point)
    out["segments"] = sum(int(s["segments"]) for s in per_point)
    out["sketch_passes"] = sketch_passes
    return torch.stack(xs), out
