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

The record-reading half reads the dry-run's records
(``launch.dryrun_solver``, the reference's record layout) into the three
per-device terms, each a data-sheet time, not a measurement:

    compute    = Σ_dtype FLOPs / the dtype's peak (fp32 67, bf16 989 TFLOP/s)
    memory     = bytes accessed / PEAK_BYTES
    collective = collective bytes / NVLINK_BYTES

The records are per rank, as the reference's per-device ones are, so the
chip count cancels. ``mfu`` divides the useful work by the chips' bf16
peak over the step's bound. The model cells' branch of ``model_flops_for``
waits for the port of the reference's model configs.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

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


def lm_train_terms(n_params: int, tokens: int) -> tuple[float, float]:
    """One LM train step's forward and backward under remat (no optimizer):
    2·N·T FLOPs forward, 4·N·T backward, and 2·N·T for the forward that
    remat runs again inside the backward, so 8·N·T and not the usual 6·N·T
    (attention's own products left out); the parameters read once in fp32
    and their grads written once."""
    return 8.0 * n_params * tokens, 8.0 * n_params


def adamw_terms(n_params: int) -> tuple[float, float]:
    """One fp32 AdamW update: p, g, m and v read once and p, m and v
    written once (28 B a parameter), about 15 operations a parameter."""
    return 15.0 * n_params, 28.0 * n_params


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


def peak_for(dtype: str) -> float:
    """The data-sheet peak of a dtype's products: bf16 and fp16 on the
    tensor cores, anything else at the fp32 rate."""
    return PEAK_BF16_FLOPS if dtype in ("bfloat16", "float16") else PEAK_FP32_FLOPS


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    step_kind: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_total: float
    useful_ratio: float
    bottleneck: str
    step_time_s: float       # max of the three terms (no-overlap bound)
    roofline_frac: float     # compute_s / step_time_s
    mfu: float               # model_flops / (chips · bf16 peak · step_time)
    per_device_bytes: dict

    def row(self) -> dict:
        return dataclasses.asdict(self)


def model_flops_for(arch: str, shape: str) -> float:
    """Useful FLOPs of a dry-run record: analytic for the solver cells
    (``solver_model_flops``). A model cell raises KeyError: its branch waits
    for the port of the reference's model configs."""
    if arch.startswith("solver"):
        return solver_model_flops(arch, shape)
    raise KeyError(f"no useful-FLOPs count for {arch!r}: the port has no model configs yet")


def analyze_record(rec: dict) -> Roofline | None:
    """The three terms of one record, or None when it did not run or names
    a cell without a useful-FLOPs count."""
    if rec.get("status") != "ok":
        return None
    chips = rec["n_devices"]
    flops_dev = max(rec.get("hlo_dot_flops") or 0.0, rec.get("flops") or 0.0)
    by_dtype = rec.get("flops_by_dtype") or {"float32": flops_dev}
    compute_s = sum(f / peak_for(dt) for dt, f in by_dtype.items())
    memory_s = (rec.get("bytes_accessed") or 0.0) / PEAK_BYTES
    collective_s = rec["collectives"]["total_bytes"] / NVLINK_BYTES
    try:
        mf = model_flops_for(rec["arch"], rec["shape"])
    except KeyError:
        return None
    hlo_total = flops_dev * chips
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step_time = max(terms.values())
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        step_kind=rec.get("step_kind", "?"), compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, model_flops=mf, hlo_flops_total=hlo_total,
        useful_ratio=mf / hlo_total if hlo_total else 0.0, bottleneck=bottleneck,
        step_time_s=step_time,
        roofline_frac=compute_s / step_time if step_time else 0.0,
        mfu=mf / (chips * PEAK_BF16_FLOPS * step_time) if step_time else 0.0,
        per_device_bytes=rec.get("memory", {}))


def load_all(results_dir: str | Path = "results/dryrun_torch") -> list[Roofline]:
    """Every analyzable record under ``results_dir/<mesh>/*.json``."""
    out = []
    for f in sorted(Path(results_dir).glob("*/*.json")):
        r = analyze_record(json.loads(f.read_text()))
        if r:
            out.append(r)
    return out


def markdown_table(rows: list[Roofline]) -> str:
    hdr = ("| arch | shape | mesh | step | compute (s) | memory (s) | collective (s) "
           "| bottleneck | useful FLOPs | MFU bound |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    return hdr + "".join(
        f"| {r.arch} | {r.shape} | {r.mesh} | {r.step_kind} | {r.compute_s:.3e} "
        f"| {r.memory_s:.3e} | {r.collective_s:.3e} | **{r.bottleneck}** "
        f"| {r.useful_ratio:.2f} | {r.mfu:.3f} |\n" for r in rows)
