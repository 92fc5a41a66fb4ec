"""service.pack_ms: host ms in ``service.pack`` (padding and stacking a
chunk's requests on the device, their seeds) a chunk, in the traced slice.
None without the program's spans."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    if spans is None or not spans.count("service.chunk"):
        return None
    return spans.host_ns("service.pack") * 1e-6 / spans.count("service.chunk")
