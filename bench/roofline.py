"""The yardstick of the kernels' roofline shares, frozen with the benchmark.

A copy of the operation and byte counts of ``repro_torch.analysis.roofline``
(``gauss_sa_terms``, ``fwht_terms``, ``sjlt_terms``) and of its peaks, kept
here so that a change to the program cannot move the yardstick it is
measured by. Every peak is a value of NVIDIA's H100 SXM data sheet (dense
rates at the full 700 W power limit), not a measurement: a card set below
that limit reads lower shares. The least time a call could take is the
larger of its bytes over ``PEAK_BYTES`` and its operations over the peak;
each input is counted read once and each output written once.
"""

from __future__ import annotations

import math

PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # HBM3


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """(the least seconds of an fp32 call, "operations" or "bytes",
    whichever bounds it)."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def gauss_sa_terms(B: int, n: int, d: int, m: int) -> tuple[float, float]:
    """The Gaussian sketch-times-A kernel at (B, n, d, m) in fp32:
    2·B·m·n·d FLOPs; the (B, n, d) A read once, the (B,) int64 seeds, the
    (B, m, d) SA written."""
    return 2.0 * B * m * n * d, float(4 * B * n * d + 4 * B * m * d + 8 * B)


def fwht_terms(B: int, n: int, d: int) -> tuple[float, float]:
    """The fp32 FWHT of a (B, n, d) stack: log2(n) butterfly stages of one
    add each per element; X read and the transform written once."""
    return float(B * d * n * int(math.log2(n))), float(8 * B * n * d)


def sjlt_terms(B: int, n: int, d: int, M: int, *, shared: bool = False) -> tuple[float, float]:
    """The fp32 SJLT's segment sum (B = 1 with ``shared``): one signed add
    per element of A, counted as 2·B·n·d FLOPs; A read once, the (B, n)
    int32 targets and fp32 signs, the (B, M, d) SA written."""
    return 2.0 * B * n * d, float(4 * (1 if shared else B) * n * d + 8 * B * n + 4 * B * M * d)
