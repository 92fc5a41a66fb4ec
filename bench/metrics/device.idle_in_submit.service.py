"""The device's idle share of the traced slice while the host was in
``service.submit`` (staging, bucketing, the admission checks' host reads).
None without the program's spans."""

from bench.attribution import idle_in


def read(ctx):
    return idle_in(ctx, "service.submit")
