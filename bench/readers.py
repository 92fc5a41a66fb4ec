"""Arithmetic that more than one metric's reader shares."""

from __future__ import annotations

import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile of ``values``, linear between the two nearest
    ranks (numpy's default), over every value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values):
    """The mean, or None where there is nothing to read."""
    return statistics.fmean(values) if values else None


def idle_share(ctx):
    """1 − the device's busy seconds over the traced slice's length."""
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 1.0 - ctx.trace.busy_s / ctx.trace.window_s


def peak_gib(ctx):
    """The device memory peak inside the measured window, GiB."""
    return ctx.window_peak_bytes / 2 ** 30 if ctx.window_peak_bytes else None
