"""The port's solver core: problem container, factorizations, the paper's
adaptive solvers (Alg. 4.1/4.2) on functional sketches, effective
dimension, sketch ladders (one device, emulated shards, or row-sharded over
``torch.distributed``), the padded adaptive engine and its path mode, the
retry/fallback/deadline/preemption driver, GLM objectives and the
sketched-Newton driver."""

from .adaptive import AdaptiveConfig, AdaptiveResult, adaptive_solve, k_max
from .effective_dim import (
    effective_dimension,
    effective_dimension_exact,
    effective_dimension_weighted_exact,
    exp_decay_singular_values,
    m_delta_gaussian,
    m_delta_sjlt,
    m_delta_srht,
)
from .robust import PreemptedError
from .sketches import Sketch, fwht, make_sketch, sketch_cost_flops
from .solvers import newton_solve

__all__ = [
    "AdaptiveConfig",
    "AdaptiveResult",
    "adaptive_solve",
    "k_max",
    "effective_dimension",
    "effective_dimension_exact",
    "effective_dimension_weighted_exact",
    "exp_decay_singular_values",
    "m_delta_gaussian",
    "m_delta_sjlt",
    "m_delta_srht",
    "PreemptedError",
    "Sketch",
    "fwht",
    "make_sketch",
    "sketch_cost_flops",
    "newton_solve",
]
