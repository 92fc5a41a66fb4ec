"""service.fill.poisson: requests a flush carried in the open loop, mean
over the window's flushes (at most the batch; fewer when arrivals are
sparse, more waiting when they bunch)."""

from bench.readers import mean


def read(ctx):
    return mean(ctx.records.get("fill", []))
