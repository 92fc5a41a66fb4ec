"""Token pipelines for LM training (port of ``repro.data``)."""
