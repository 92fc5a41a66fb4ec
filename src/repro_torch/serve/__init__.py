"""Serving layer of the port: the ridge ``SolverService`` and the LM
serving steps."""
from .step import decode_step, greedy_generate, prefill_step
