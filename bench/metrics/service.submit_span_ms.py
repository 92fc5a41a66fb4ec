"""service.submit_span_ms: host ms in the ``service.submit`` spans a flush,
in the traced slice: the program's own count of what ``service.submit_ms``
times around the calls. None without the program's spans."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    if spans is None or not spans.count("service.flush"):
        return None
    return spans.host_ns("service.submit") * 1e-6 / spans.count("service.flush")
