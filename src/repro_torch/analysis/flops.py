"""Dot FLOPs of a traced callable: the port's counterpart of
``repro.analysis.hloflops``.

The reference counts every ``dot`` of the partitioned HLO, 2·|out|·|contracted|
per device, because ``cost_analysis()`` mis-counts large SPMD programs. The
port has no compiled program to read: a per-rank program runs (under
``FakeTensorMode`` in the dry-run, so nothing is allocated) inside
``torch.utils.flop_counter.FlopCounterMode``, which counts the same
quantity for every matrix product (``mm``, ``bmm``, ``addmm``,
``baddbmm``; convolutions and attention too). Like the reference it counts
dots only: factorizations (Cholesky), triangular solves, scatter-adds and
elementwise work are not counted, and callers add them analytically, as
``analysis.roofline.solver_model_flops`` does.

``dot_flops_by_dtype`` splits the same count by the operands' dtype from an
op trace (``analysis.audit.op_trace``), so a roofline can take each part at
its own peak; its total equals ``FlopCounterMode``'s.
"""

from __future__ import annotations

import math
from typing import Callable

from .audit.op_trace import OpTrace

_DOTS = {"aten.mm": 0, "aten.addmm": 1, "aten.bmm": 0, "aten.baddbmm": 1}


def dot_flops(fn: Callable[[], object]) -> tuple[int, object]:
    """(dot FLOPs of one call of ``fn``, its result), from ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn()
    return int(counter.get_total_flops()), out


def dot_flops_by_dtype(trace: OpTrace) -> dict[str, int]:
    """{operand dtype: FLOPs} of the trace's matrix products, 2·|out|·k for
    each (k the contracted length), as ``FlopCounterMode`` counts them."""
    out: dict[str, int] = {}
    for s in trace.sites:
        first = _DOTS.get(s.base)
        if first is None:
            continue
        lhs = s.in_shapes[first]
        flops = 2 * math.prod(s.out_shapes[0]) * lhs[-1]
        key = str(s.in_dtypes[first]).replace("torch.", "")
        out[key] = out.get(key, 0) + flops
    return out

