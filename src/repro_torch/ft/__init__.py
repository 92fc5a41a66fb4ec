"""Fault tolerance: checkpoints, preemption, straggler detection and the
fault-injection harness (port of ``repro.ft``; the elastic re-meshing plan
waits for the port's collectives)."""

from .checkpoint import CheckpointManager
from .faults import (
    AdversarialKeyProvider,
    ShardLossInjector,
    dropout_provider,
    ill_conditioned_matrix,
    inject_inf_entry,
    inject_nan_row,
    rank_deficient_matrix,
)
from .resilience import PreemptionHandler, StragglerWatchdog, run_with_restarts
