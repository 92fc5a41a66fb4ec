"""Data movement of the port: int8 quantization (``compress``: per row for
the sketch passes, error-feedback per tensor) and the placements of the LM
over a mesh (``sharding``)."""
