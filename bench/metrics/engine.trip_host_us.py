"""engine.trip_host_us: host µs a dispatched PCG trip, in the traced slice:
the self time of the ``engine.loop`` spans (their ``engine.host_read``
children left out) over the trips they dispatched (``trips``). None
without the program's spans (``bench.attribution.SpanSlice``)."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    if spans is None:
        return None
    trips = sum(s.attrs.get("trips", 0) for s in spans.named("engine.loop"))
    return spans.self_ns("engine.loop") * 1e-3 / trips if trips else None
