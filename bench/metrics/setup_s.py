"""setup_s: process start to the first timed step (imports, the card, the
kernels' build or load, the traffic's pool, one warm step)."""


def read(ctx):
    return ctx.setup_s
