"""The device's idle share of the traced slice while no span of the program
was open on the host: the caller's own code. None without the program's
spans."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    return None if spans is None else spans.share(spans.idle_self_ns(None))
