"""service.submit_ms: host milliseconds of a flush's submit calls, from the
first one's start to the last one's return, mean over the window's flushes."""

from bench.readers import mean


def read(ctx):
    m = mean(ctx.records.get("submit_s", []))
    return None if m is None else m * 1e3
