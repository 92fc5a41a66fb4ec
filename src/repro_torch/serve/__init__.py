"""Serving layer of the port: the ridge ``SolverService``."""
