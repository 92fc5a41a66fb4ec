"""The H100 SXM roofline terms of the port's kernels and collectives.

Port-side counterpart of ``repro.analysis.roofline``, whose constants are a
TPU's and stay there. Every peak below is a value of NVIDIA's H100 SXM data
sheet (dense rates, 700 W), not a measurement. The least time the card
could take for a call is the larger of its bytes over ``PEAK_BYTES`` and
its operations over the peak of their type (``bound_ms``); each input is
counted read once and each output written once.

One function per Pallas body of the reference returns (FLOPs, bytes) of
one call at given shapes and dtype leg; ``chip_smoke.py`` phase 3 takes its
bounds from them. ``solver_model_flops`` and ``SOLVER_SHAPES`` are the
reference's analytic useful-work count, unchanged.
"""

from __future__ import annotations

import math

# H100 SXM (NVIDIA data sheet): fp32 outside the tensor cores, bf16 on the
# tensor cores (the reduced legs multiply bf16 values into fp32 sums), HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Issue rate: 132 SMs × 4 schedulers × 32 lanes at the 1.98 GHz boost clock
# (the clock of PEAK_FP32_FLOPS = 132·128·2·1.98e9), thread instructions/s
PEAK_INSTR = 132 * 4 * 32 * 1.98e9
# NVLink 4 (data sheet): 900 GB/s a card in both directions, 450 GB/s each
# way; the rate a ring all-reduce's per-rank traffic crosses at best
NVLINK_BYTES = 450e9


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """(the least time in ms, "operations" or "bytes", whichever bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def gauss_sa_terms(B: int, n: int, d: int, m: int, *, a_itemsize: int = 4,
                   shared: bool = False, scaled: bool = False) -> tuple[float, float]:
    """``_gauss_sa_kernel`` (``scaled``: ``_gauss_sa_kernel_scaled``) at
    (B, n, d, m): 2·B·m·n·d multiply-adds' FLOPs, plus one product per S
    entry for the column scale; A read once (shared: one (n, d)), the (B, n)
    fp32 scale, the (B,) int64 seeds, the (B, m, d) fp32 SA written."""
    flops = 2.0 * B * m * n * d + (B * m * n if scaled else 0)
    nbytes = (a_itemsize * (1 if shared else B) * n * d + (4 * B * n if scaled else 0)
              + 4 * B * m * d + 8 * B)
    return flops, float(nbytes)


def fwht_terms(B: int, n: int, d: int, *, x_itemsize: int = 4, out_itemsize: int = 4,
               scaled: bool = False) -> tuple[float, float]:
    """``_fwht_kernel`` (``scaled``: ``_fwht_kernel_scaled``) of a (B, n, d)
    stack: log2(n) butterfly stages of one add each per element, plus the
    fused row scale's product; X read and the transform written once, and
    the (B, n) fp32 row scale. The adds run at the fp32 peak."""
    lg = int(math.log2(n))
    flops = float(B * d * n * (lg + (1 if scaled else 0)))
    nbytes = (x_itemsize + out_itemsize) * B * n * d + (4 * B * n if scaled else 0)
    return flops, float(nbytes)


def sjlt_terms(B: int, n: int, d: int, M: int, *, a_itemsize: int = 4,
               shared: bool = False, index_itemsize: int = 4) -> tuple[float, float]:
    """``_sjlt_kernel_batched`` (B = 1 with ``shared``: ``_sjlt_kernel``):
    one signed add per element of A, counted as 2·B·n·d FLOPs; A read once,
    the (B, n) targets and fp32 signs, the (B, M, d) fp32 SA written."""
    flops = 2.0 * B * n * d
    nbytes = (a_itemsize * (1 if shared else B) * n * d + (index_itemsize + 4) * B * n
              + 4 * B * M * d)
    return flops, float(nbytes)


def allreduce_bytes(payload_bytes: int, world: int) -> float:
    """Bytes each rank sends in a ring all-reduce of ``payload_bytes``:
    2·(K − 1)/K of the payload (a reduce-scatter, then an all-gather)."""
    return 2.0 * (world - 1) / world * payload_bytes


def collective_ms(payload_bytes: int, world: int) -> float:
    """The least time of a ring all-reduce over NVLink (the collective term
    of a sharded pass: ``analysis.collectives`` gives its payloads)."""
    return allreduce_bytes(payload_bytes, world) / NVLINK_BYTES * 1e3


# the ridge-probe dims every solver dry-run cell uses (the reference's
# launch/dryrun_solver.py)
SOLVER_SHAPES = {
    "probe_2m_8k": dict(n=1 << 21, d=8192, c=1024, m=16384, pcg_iters=10),
}


def solver_model_flops(arch: str, shape: str) -> float:
    """Analytic FLOPs of one adaptive phase of the paper's solver at the
    probe dims: sketch + Gram + Cholesky + PCG iterations (the reference's
    count, unchanged)."""
    dims = SOLVER_SHAPES[shape]
    n, d, c, m, iters = (dims["n"], dims["d"], dims["c"], dims["m"],
                         dims["pcg_iters"])
    if "gaussian" in arch:
        sketch = 2.0 * m * n * d          # dense S @ A
    else:
        sketch = 2.0 * n * d              # SJLT: each row touched once
    gram = 2.0 * m * d * d                # SAᵀ SA
    chol = d ** 3 / 3.0
    # per PCG iteration: Hv = Aᵀ(Av) on the (d, c) RHS block + the
    # two (d, d)-triangular preconditioner solves on (d, c)
    pcg = iters * (4.0 * n * d * c + 2.0 * d * d * c)
    return sketch + gram + chol + pcg
