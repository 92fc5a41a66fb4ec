"""The device's idle share over the traced slice: 1 − the union of its
busy intervals over the slice's length."""

from bench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
