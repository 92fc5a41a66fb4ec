"""Serving layer of the port: the ridge ``SolverService`` and the LM
serving steps."""
from .solver_service import (
    DEFAULT_SHAPE_CLASSES,
    RidgeRequest,
    RidgeSolution,
    ShapeClass,
    SolverService,
)
from .step import decode_step, greedy_generate, prefill_step
