"""Behavioral checks: the rebuild sentinel and the segment state audit.

Port of ``repro.analysis.audit.retrace``. Eager torch has no trace cache
and no buffer donation, so the two checks translate:

* **Rebuild sentinel.** A second call of the engine's whole lifecycle
  (prepare, a segment, a reprecondition, finalize, and the monolithic
  solve) with fresh same-shape inputs compiles and opens no kernel library:
  ``kernels._build.COUNTS`` does not move. On the CPU no library is ever
  opened, so it holds trivially; its negative control opens one per call.
* **Segment state audit** (on the card only): a segment's peak allocation
  above its entry, ``padded_solve_segment`` at the top service class, stays
  below the bytes of ``pre.pinvs``: no segment copies the ladder. This is
  the port's counterpart of "the 20-field state is donated".
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.adaptive_padded import (
    doubling_ladder,
    finalize_padded_solve,
    padded_adaptive_solve_batched,
    padded_solve_segment,
    prepare_padded_solve,
    reprecondition_padded,
)
from repro_torch.kernels import _build

from .entrypoints import problem
from .op_trace import provenance, repo_relative
from .rules import Violation

# the reference's tiny but faithful lifecycle: batched, n not a power of two
_B, _N, _D, _M = 2, 48, 6, 8
# the state audit's class: the top service class at the service's batch
STATE_CLASS = dict(b=16, n=4096, d=256, m_max=512)
STATE_TRIPS = 8


def engine_cycle(device, seed: int) -> None:
    """The whole segmented lifecycle and the monolithic solve, once."""
    q, seeds = problem(device, b=_B, n=_N, d=_D, seed=seed)
    pre, st = prepare_padded_solve(q, seeds, m_max=_M, device=device)
    st = padded_solve_segment(q, pre, st, 4, method="pcg", device=device)
    grams = torch.eye(_D, device=device).expand(len(doubling_ladder(_M)), _B, _D, _D)
    pre2, st = reprecondition_padded(q, pre, st, grams.contiguous(), device=device)
    finalize_padded_solve(pre2, st, m_max=_M, device=device)
    padded_adaptive_solve_batched(q, seeds, m_max=_M, method="pcg", device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def check_rebuild_sentinel(device, cycle: Callable = engine_cycle,
                           name: str = "engine:lifecycle") -> list[Violation]:
    """No library is compiled or opened when ``cycle`` runs a second time
    with fresh same-shape inputs; a violation names where it happened."""
    cycle(device, 0)                     # the first call may build and load
    where: list[str] = []
    build_all, open_library = _build.build_all, _build.open_library

    def counted_build(*args, **kwargs):
        where.append(provenance("build_all", depth=2))
        return build_all(*args, **kwargs)

    def counted_open(*args, **kwargs):
        where.append(provenance("open_library", depth=2))
        return open_library(*args, **kwargs)

    before = dict(_build.COUNTS)
    _build.build_all, _build.open_library = counted_build, counted_open
    try:
        cycle(device, 1)
    finally:
        _build.build_all, _build.open_library = build_all, open_library
    grew = {k: _build.COUNTS[k] - before[k] for k in before if _build.COUNTS[k] != before[k]}
    if not grew:
        return []
    return [Violation("retrace_sentinel", name,
                      f"a second call with fresh same-shape inputs compiled or opened "
                      f"kernel libraries {grew}", where[0] if where else "")]


def _code_location(fn) -> str:
    code = getattr(fn, "__code__", None)
    if code is None:
        return ""
    return f"{repo_relative(code.co_filename)}:{code.co_firstlineno}"


def check_segment_state(device, segment: Callable = padded_solve_segment,
                        name: str = "engine:segment:state") -> tuple[list[Violation], dict]:
    """On the card: an ``STATE_TRIPS``-trip segment at ``STATE_CLASS``
    allocates less above its entry than ``pre.pinvs`` holds. Returns the
    violations and the measurement (peak and pinvs bytes)."""
    from repro_torch.analysis.memscan import peak_bytes_above_entry

    c = STATE_CLASS
    q, seeds = problem(device, b=c["b"], n=c["n"], d=c["d"])
    pre, st = prepare_padded_solve(q, seeds, m_max=c["m_max"], device=device)
    peak, _ = peak_bytes_above_entry(
        lambda: segment(q, pre, st, STATE_TRIPS, method="pcg", device=device), device)
    pinvs = pre.pinvs.numel() * pre.pinvs.element_size()
    found = {"peak_bytes": peak, "pinvs_bytes": pinvs, "trips": STATE_TRIPS}
    if peak < pinvs:
        return [], found
    return [Violation("retrace_sentinel", name,
                      f"a {STATE_TRIPS}-trip segment allocated {peak} B above its entry, "
                      f"not below the {pinvs} B of pre.pinvs: the segment copies the "
                      f"ladder", _code_location(segment))], found


def run_behavioral_checks(device) -> tuple[list[Violation], dict]:
    """The rebuild sentinel on any device, the state audit on the card;
    returns the violations and the state audit's measurement."""
    out = check_rebuild_sentinel(device)
    found: dict = {}
    if torch.device(device).type == "cuda":
        vs, found = check_segment_state(device)
        out += vs
    return out, found
