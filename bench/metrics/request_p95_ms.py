"""request_p95_ms: the 95th percentile, over every request answered in the
measured window, of the time from the request's arrival in the open loop
(its scheduled Poisson arrival, not the start of its submit) to its
flush's return once the device is done."""

from bench.readers import percentile


def read(ctx):
    lat = ctx.records.get("latencies_s")
    return percentile(lat, 95) * 1e3 if lat else None
