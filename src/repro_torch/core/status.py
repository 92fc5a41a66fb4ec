"""Per-problem solve statuses: the failure lattice.

An own copy of ``repro.core.status`` (same names, same integer values), so
certificates from the two packages compare directly. From best to worst:
OK, RETRIED, FELL_BACK, STALLED, LEVEL_INVALID, NAN_POISONED, REJECTED,
DEADLINE_EXCEEDED; see the reference module for what each means.
"""

from __future__ import annotations

from enum import IntEnum


class SolveStatus(IntEnum):
    OK = 0
    STALLED = 1
    LEVEL_INVALID = 2
    NAN_POISONED = 3
    RETRIED = 4
    FELL_BACK = 5
    REJECTED = 6
    DEADLINE_EXCEEDED = 7


#: Engine-level terminal failures — retryable with a redrawn sketch, then
#: eligible for the direct-solve fallback (core.robust).
ENGINE_FAILURES = (
    SolveStatus.STALLED,
    SolveStatus.LEVEL_INVALID,
    SolveStatus.NAN_POISONED,
)

#: Statuses whose solution converged under an adaptive sketch and carries a
#: trustworthy δ̃ certificate.
CONVERGED_STATUSES = (SolveStatus.OK, SolveStatus.RETRIED)


def status_name(code) -> str:
    """Human-readable name for a status code (int or 0-d tensor)."""
    return SolveStatus(int(code)).name
