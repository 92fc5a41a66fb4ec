"""Comparison ``ridge``: answers to ridge problems against the float64
reference (``bench.reference.ridge``).

Every answer that the timed loop produced is judged after the window has
closed against the reference worked out from the generator's A, y and ν
alone, by two errors:

* the relative error in the energy norm, ‖x − x*‖_H / ‖x*‖_H, the norm that
  the solvers' δ̃ certificates bound. What float32 attains in it falls with
  ν by orders of magnitude, so it is judged in strata of ν, each against a
  limit of its own;
* the normwise backward error ‖b − Hx‖ / (‖H‖_F‖x‖ + ‖b‖), which a solver
  that is stable in float32 keeps near float32's rounding unit however ill
  conditioned H is. It stays sharp at the smallest ν, where float32's
  energy-norm error comes near the control's; it too is judged in strata,
  each with a limit of its own.

The configuration's ``check`` gives:

* ``err_by_nu``, ``backward_by_nu``: [[ν_lo, ν_hi, limit], ...]; the
  number ``err.nu<ν_lo>`` (``bwd.nu<ν_lo>``) is the largest energy-norm
  (backward) error of the answers whose ν lies in [ν_lo, ν_hi]; a
  non-finite error counts as infinite, a stratum with no answer reads 0.
  A list leaves out the ν where the program's readings and the control's
  do not lie apart (``PERF.md``), but every answer has to lie in a
  stratum of one of them, else the comparison stops: the configuration
  is at fault;
* ``limits``: those of ``missing_answers`` and ``uncertified_share``
  (``bench.check``).

Each limit is set from the readings of the program and of the control
(``PERF.md``). The control is the reference's solve in TF32
(``ridge.solve_tf32``).
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

import torch

from bench import check
from bench.reference import ridge


def errors(pool, answers) -> tuple[list[float], list[float]]:
    """(energy-norm errors, backward errors) of the answers, the reference
    worked out once per problem of the pool; a non-finite error is
    infinite."""
    err, bwd = [math.inf] * len(answers), [math.inf] * len(answers)
    by = defaultdict(list)
    for k, a in enumerate(answers):
        by[a.index].append(k)
    if not by:
        return err, bwd
    for i, ks in by.items():
        x_star, H, b = ridge.solve(pool.A[i], pool.y[i], pool.nu[i])
        X = torch.stack([answers[k].x.to(x_star.device) for k in ks])
        e = ridge.h_norm_errors(H, x_star, X).tolist()
        w = ridge.backward_errors(H, b, X).tolist()
        for k, ek, wk in zip(ks, e, w):
            err[k] = ek if math.isfinite(ek) else math.inf
            bwd[k] = wk if math.isfinite(wk) else math.inf
    return err, bwd


def _judge(prefix: str, strata, nus, values):
    """({name: (worst, limit)}, per value: its stratum's index or None, and
    whether it lies within that stratum's limit)."""
    strata = [tuple(map(float, s)) for s in strata]
    worst, where, ok = [0.0] * len(strata), [], []
    for nu, v in zip(nus, values):
        s = next((k for k, (lo, hi, _) in enumerate(strata) if lo <= nu <= hi), None)
        where.append(s)
        if s is not None:
            worst[s] = max(worst[s], v)
        ok.append(s is None or v <= strata[s][2])
    return {f"{prefix}.nu{lo:.3g}": (w, lim) for (lo, _, lim), w in zip(strata, worst)}, where, ok


def compare(pool, answers, attempted: int, spec: dict) -> check.Verdict:
    err, bwd = errors(pool, answers)
    nus = [pool.nu[a.index] for a in answers]
    e_nums, e_in, e_ok = _judge("err", spec.get("err_by_nu", []), nus, err)
    b_nums, b_in, b_ok = _judge("bwd", spec.get("backward_by_nu", []), nus, bwd)
    for nu, e, b in zip(nus, e_in, b_in):
        if e is None and b is None:
            raise ValueError(f"ν = {nu} lies in no stratum of the configuration's check")
    nums = {**e_nums, **b_nums, **check.numbers(answers, attempted, spec["limits"])}
    return check.verdict(answers, nums, [a and b for a, b in zip(e_ok, b_ok)])


def control(pool, answers) -> list:
    """The control in the program's place: each answer replaced by the TF32
    solve of its problem."""
    xs = {i: ridge.solve_tf32(pool.A[i], pool.y[i], pool.nu[i]) for i in {a.index for a in answers}}
    return [dataclasses.replace(a, x=xs[a.index]) for a in answers]
