"""service.wait_ms.poisson: milliseconds from a request's arrival to the
start of its submit, mean over the window's requests: how far the one
caller ran behind the open loop's schedule."""

from bench.readers import mean


def read(ctx):
    m = mean(ctx.records.get("wait_s", []))
    return None if m is None else m * 1e3
