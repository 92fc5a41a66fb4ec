"""The port's solver core: problem container, factorizations, the paper's
adaptive solvers (Alg. 4.1/4.2) on functional sketches, effective
dimension, sketch ladders (one device, emulated shards, or row-sharded over
``torch.distributed``), the padded adaptive engine and its path mode, the
retry/fallback/deadline/preemption driver, GLM objectives and the
sketched-Newton driver."""

from .adaptive import AdaptiveConfig, AdaptiveResult, adaptive_solve, k_max
from .adaptive_padded import (
    PaddedPrecompute,
    PaddedState,
    finalize_padded_solve,
    padded_adaptive_solve,
    padded_adaptive_solve_batched,
    padded_path_solve_batched,
    padded_solve_segment,
    padded_trip_cap,
    prepare_padded_solve,
    prepare_path_ladder,
    reprecondition_padded,
)
from .effective_dim import (
    effective_dimension,
    effective_dimension_exact,
    effective_dimension_weighted_exact,
    exp_decay_singular_values,
    m_delta_gaussian,
    m_delta_sjlt,
    m_delta_srht,
)
from .newton import (
    adaptive_newton_solve,
    adaptive_newton_solve_batched,
    irls_reference,
    newton_cg_reference,
)
from .objectives import GLM_FAMILIES, GLMObjective, get_objective
from .precond import (
    SketchedPrecond,
    factorize,
    factorize_shared,
    shifted_ladder_inverses,
)
from .quadratic import (
    Quadratic,
    direct_solve,
    from_least_squares,
    from_least_squares_batch,
    lambda_sweep,
    stack_quadratics,
    weighted_gram,
)
from .robust import (
    PreemptedError,
    robust_padded_solve_batched,
    robust_path_solve_batched,
    segmented_padded_solve_batched,
)
from .sketches import Sketch, fwht, make_sketch, sketch_cost_flops
from .solvers import cg_solve, newton_solve, run_fixed
from .status import (
    CONVERGED_STATUSES,
    ENGINE_FAILURES,
    SolveStatus,
    status_name,
)

__all__ = [
    "AdaptiveConfig",
    "AdaptiveResult",
    "adaptive_solve",
    "padded_adaptive_solve",
    "padded_adaptive_solve_batched",
    "PaddedState",
    "PaddedPrecompute",
    "prepare_padded_solve",
    "prepare_path_ladder",
    "padded_path_solve_batched",
    "padded_solve_segment",
    "finalize_padded_solve",
    "reprecondition_padded",
    "padded_trip_cap",
    "k_max",
    "effective_dimension",
    "effective_dimension_exact",
    "effective_dimension_weighted_exact",
    "exp_decay_singular_values",
    "m_delta_gaussian",
    "m_delta_sjlt",
    "m_delta_srht",
    "SketchedPrecond",
    "factorize",
    "factorize_shared",
    "shifted_ladder_inverses",
    "Quadratic",
    "direct_solve",
    "from_least_squares",
    "from_least_squares_batch",
    "lambda_sweep",
    "stack_quadratics",
    "weighted_gram",
    "GLM_FAMILIES",
    "GLMObjective",
    "get_objective",
    "adaptive_newton_solve",
    "adaptive_newton_solve_batched",
    "irls_reference",
    "newton_cg_reference",
    "Sketch",
    "fwht",
    "make_sketch",
    "sketch_cost_flops",
    "cg_solve",
    "newton_solve",
    "run_fixed",
    "robust_padded_solve_batched",
    "robust_path_solve_batched",
    "segmented_padded_solve_batched",
    "PreemptedError",
    "SolveStatus",
    "ENGINE_FAILURES",
    "CONVERGED_STATUSES",
    "status_name",
]
