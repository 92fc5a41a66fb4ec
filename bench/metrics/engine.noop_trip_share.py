"""engine.noop_trip_share: the share of the PCG trips the host dispatched
over the window that no problem needed, 1 − trips_needed / trips_run
(``SolverService.stats``: the engine's ``trips`` and the ``_trip`` calls
dispatched, summed over segments and attempts). None where the program
does not count ``trips_run``."""


def read(ctx):
    run = ctx.counters.get("trips_run", 0)
    return 1.0 - ctx.counters["trips_needed"] / run if run else None
