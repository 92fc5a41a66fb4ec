"""robust.retries_per_batch: the service's sketch redraws over the window,
per packed batch (``SolverService.stats``)."""


def read(ctx):
    batches = ctx.counters.get("batches", 0)
    return ctx.counters["retries"] / batches if batches else None
