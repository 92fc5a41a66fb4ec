"""engine.iters_mean: mean accepted iterations of the window's answers."""

from bench.readers import mean


def read(ctx):
    return mean(ctx.records.get("iters", []))
