"""engine.prepare_ms: host ms in ``engine.prepare`` (the ladder's sketch
pass and factorizations, the true Gram, the initial state) a chunk, in the
traced slice. None without the program's spans."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    if spans is None or not spans.count("service.chunk"):
        return None
    return spans.host_ns("engine.prepare") * 1e-6 / spans.count("service.chunk")
