"""Collective accounting from op traces: the collective term of the roofline.

Counterpart of ``repro.analysis.collectives``, which reads compiled HLO. The
port's collectives are eager ``torch.distributed`` calls that the op
recorder sees as ``c10d.*`` sites (``analysis.audit.op_trace``); their
payloads, summed, give ``analysis.roofline.collective_ms`` its bytes.
``collective_bytes_by_op`` gives a dry-run record the reference's layout:
each collective's output bytes (a functional collective's ``wait_tensor``
is its completion, not a second collective, and is not counted).
"""

from __future__ import annotations

import math

from .audit.op_trace import OpSite, OpTrace


def collective_sites(trace: OpTrace) -> list[OpSite]:
    """Every ``c10d.*`` (or functional collective) site, in order."""
    return [s for s in trace.sites if s.is_collective]


def collective_count(trace: OpTrace) -> int:
    return len(collective_sites(trace))


def collective_bytes(trace: OpTrace) -> int:
    """Payload bytes of every collective: the bytes of its tensor inputs."""
    return sum(s.in_bytes() for s in collective_sites(trace))


def collective_bytes_by_op(trace: OpTrace) -> dict:
    """``{"total_bytes", "by_op": {op: {"bytes", "count"}}}``: the summed
    output bytes of each collective, as the reference's
    ``collective_bytes_from_hlo`` reports a compiled program's."""
    by_op: dict[str, dict[str, int]] = {}
    for s in collective_sites(trace):
        if s.base.endswith("wait_tensor"):
            continue
        cell = by_op.setdefault(s.base, {"bytes": 0, "count": 0})
        cell["bytes"] += sum(math.prod(shape) * dt.itemsize
                             for shape, dt in zip(s.out_shapes, s.out_dtypes))
        cell["count"] += 1
    return {"total_bytes": sum(c["bytes"] for c in by_op.values()), "by_op": by_op}
