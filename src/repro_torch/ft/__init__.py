"""Fault tolerance: checkpoints, elastic re-meshing plans, preemption,
straggler detection and the fault-injection harness (port of ``repro.ft``)."""

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
from .resilience import (
    ElasticPlan,
    PreemptionHandler,
    StragglerWatchdog,
    plan_elastic,
    plan_mesh_shape,
    run_with_restarts,
)
