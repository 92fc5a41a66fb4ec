"""The device's idle share of the traced slice while the host was in the
PCG loop (``engine.loop`` and its host reads). None without the program's
spans."""

from bench.attribution import idle_in


def read(ctx):
    return idle_in(ctx, "engine.loop")
