"""Analyses of the port: its invariant audit (``audit``), the H100 roofline
terms (``roofline``), memory scans and peak device memory (``memscan``) and
the collective inventory (``collectives``)."""
