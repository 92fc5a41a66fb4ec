"""Invariant auditor for the port: op-trace rules over its entry points.

Port of ``repro.analysis.audit``. The paper's complexity claims rest on a
few structural facts: each sketch family touches A once and never builds
the (B, m_max, n) sketch, the sharded ladder combines in exactly one
all-reduce, the factorizations, the loop state and the δ̃ certificates stay
fp32 whatever the sketch precision, a second call builds nothing, and the
seeds reaching sketches carry distinct tags. torch is eager, so every
public entry point is run at small shapes under an op recorder, and a
registry of rules reads the recorded ops.

    PYTHONPATH=src python -m repro_torch.analysis.audit --device cpu [--quick]
    python -m repro_torch.analysis.audit                 # on the card

Layout:

* ``op_trace``    — the one recorder (a ``TorchDispatchMode``): op sites,
  new storage, loop trips, A's consumers, kernel launches, provenance.
* ``entrypoints`` — the audited surface (the reference's 55 names).
* ``rules``       — one-touch, collective inventory, precision boundary.
* ``ast_rules``   — source lints: seed hygiene, status-lattice handling.
* ``retrace``     — the rebuild sentinel and the segment state audit.
* ``fixtures``    — the negative controls every rule must fail on.
* ``runner``      — rules × entry points and fixtures; the report and JSON.
"""

from .entrypoints import EntryPoint, build_targets  # noqa: F401
from .op_trace import (  # noqa: F401
    OpSite,
    OpTrace,
    count_a_consumers,
    count_op,
    find_new_tensors,
    iter_sites,
    max_new_tensor_bytes,
    record,
)
from .rules import RULES, Rule, RuleResult, Violation  # noqa: F401
from .runner import AuditReport, run_audit  # noqa: F401
