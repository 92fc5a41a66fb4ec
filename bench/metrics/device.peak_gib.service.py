"""The device memory peak inside the measured window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""

from bench.readers import peak_gib


def read(ctx):
    return peak_gib(ctx)
