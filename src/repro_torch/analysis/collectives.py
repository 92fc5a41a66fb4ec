"""Collective accounting from op traces: the collective term of the roofline.

Counterpart of ``repro.analysis.collectives``, which reads compiled HLO. The
port's collectives are eager ``torch.distributed`` calls that the op
recorder sees as ``c10d.*`` sites (``analysis.audit.op_trace``); their
payloads, summed, give ``analysis.roofline.collective_ms`` its bytes.
"""

from __future__ import annotations

from .audit.op_trace import OpSite, OpTrace


def collective_sites(trace: OpTrace) -> list[OpSite]:
    """Every ``c10d.*`` (or functional collective) site, in order."""
    return [s for s in trace.sites if s.is_collective]


def collective_count(trace: OpTrace) -> int:
    return len(collective_sites(trace))


def collective_bytes(trace: OpTrace) -> int:
    """Payload bytes of every collective: the bytes of its tensor inputs."""
    return sum(s.in_bytes() for s in collective_sites(trace))
