"""Dot FLOPs of a traced callable: the port's counterpart of
``repro.analysis.hloflops``.

The reference counts every ``dot`` of the partitioned HLO, 2·|out|·|contracted|
per device, because ``cost_analysis()`` mis-counts large SPMD programs. The
port has no compiled program to read: a per-rank program runs (under
``FakeTensorMode`` in the dry-run, so nothing is allocated) under the op
recorder (``analysis.audit.op_trace``), and ``dot_flops`` counts the same
quantity from its sites, 2·|out|·k for every matrix product (``mm``,
``addmm``, ``bmm``, ``baddbmm``; einsums reach these). That is what
``torch.utils.flop_counter.FlopCounterMode`` counts for them, and the tests
hold the two equal. The trace is not run inside ``FlopCounterMode``: its
module tracker's hooks keep activations alive in reference cycles, so the
trace's live peak would no longer be the step's. Like the reference it
counts dots only: factorizations (Cholesky), triangular solves,
scatter-adds and elementwise work are not counted, and callers add them
analytically, as ``analysis.roofline.solver_model_flops`` does.

``dot_flops_by_dtype`` splits the count by the operands' dtype, so a
roofline can take each part at its own peak. ``bytes_accessed`` is the
same trace's traffic: every computing op's tensor inputs and outputs,
views excluded, the eager program's bytes with nothing fused.
"""

from __future__ import annotations

import math

from .audit.op_trace import OpTrace

DOTS = {"aten.mm": 0, "aten.addmm": 1, "aten.bmm": 0, "aten.baddbmm": 1}
_VIEWS = frozenset({"aten.view", "aten._unsafe_view", "aten.permute", "aten.t",
                    "aten.transpose", "aten.slice", "aten.select", "aten.expand",
                    "aten.alias", "aten.unsqueeze", "aten.squeeze", "aten.as_strided",
                    "aten.detach", "prim.device", "_c10d_functional.wait_tensor"})


def dot_flops(trace: OpTrace) -> int:
    """Dot FLOPs of the trace's matrix products (``dot_flops_by_dtype``
    summed)."""
    return sum(dot_flops_by_dtype(trace).values())


def dot_flops_by_dtype(trace: OpTrace) -> dict[str, int]:
    """{operand dtype: FLOPs} of the trace's matrix products, 2·|out|·k for
    each (k the contracted length), as ``FlopCounterMode`` counts them."""
    out: dict[str, int] = {}
    for s in trace.sites:
        first = DOTS.get(s.base)
        if first is None:
            continue
        lhs = s.in_shapes[first]
        flops = 2 * math.prod(s.out_shapes[0]) * lhs[-1]
        key = str(s.in_dtypes[first]).replace("torch.", "")
        out[key] = out.get(key, 0) + flops
    return out


def bytes_accessed(sites) -> int:
    """Bytes every non-view op of ``sites`` (a trace's ``sites``) read and
    wrote: its tensor inputs and outputs, each counted once an op."""
    return sum(s.in_bytes() + sum(math.prod(sh) * dt.itemsize
                                  for sh, dt in zip(s.out_shapes, s.out_dtypes))
               for s in sites if s.base not in _VIEWS)
