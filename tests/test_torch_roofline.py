"""The port's H100 roofline terms (``repro_torch.analysis.roofline``).

Every bound that ``chip_smoke.py`` phase 3 prints, and PERF.md §6's kernel
table keeps, comes back from the per-Pallas-body (FLOPs, bytes) functions
to 4 digits, and the analytic solver FLOPs equal the reference's exactly
(``repro.analysis.roofline`` imports no JAX)."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import roofline as ref  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
P32, P16 = rl.PEAK_FP32_FLOPS, rl.PEAK_BF16_FLOPS
B, N, D, M = 16, 4096, 256, 512          # the main path's top class
FN, PN, PD = 16384, 8192, 1024            # the FWHT's SRHT class; the paper-literal shapes

# (row, (FLOPs, bytes), peak, PERF.md §6's bound in ms)
BOUNDS = [
    ("gauss fp32", rl.gauss_sa_terms(B, N, D, M), P32, 0.2564),
    ("gauss fp32 shared A", rl.gauss_sa_terms(B, N, D, M, shared=True), P32, 0.2564),
    ("gauss fp32 B=1 paper", rl.gauss_sa_terms(1, PN, PD, 1024, shared=True), P32, 0.2564),
    ("gauss bf16", rl.gauss_sa_terms(B, N, D, M), P16, 0.0225),
    ("gauss bf16, bf16 A", rl.gauss_sa_terms(B, N, D, M, a_itemsize=2), P16, 0.0174),
    ("gauss fp32 weighted", rl.gauss_sa_terms(B, N, D, M, scaled=True), P32, 0.2569),
    ("gauss bf16 weighted", rl.gauss_sa_terms(B, N, D, M, scaled=True), P16, 0.0226),
    ("gauss int8", rl.gauss_sa_terms(B, N, D, M, a_itemsize=1, scaled=True), P16, 0.0174),
    ("fwht fp32", rl.fwht_terms(B, FN, D), P32, 0.1603),
    ("fwht fp32 paper", rl.fwht_terms(1, PN, PD), P32, 0.0200),
    ("fwht bf16", rl.fwht_terms(B, FN, D, out_itemsize=2), P32, 0.1202),
    ("fwht fp32 scaled", rl.fwht_terms(B, FN, D, scaled=True), P32, 0.1606),
    ("fwht bf16 scaled", rl.fwht_terms(B, FN, D, out_itemsize=2, scaled=True), P32, 0.1205),
    ("fwht int8 scaled", rl.fwht_terms(B, FN, D, x_itemsize=1, out_itemsize=2, scaled=True),
     P32, 0.0604),
    ("sjlt B=1", rl.sjlt_terms(1, N, D, M, shared=True), P32, 0.0014),
    ("sjlt B=1 paper", rl.sjlt_terms(1, PN, PD, 1024, shared=True, index_itemsize=8), P32,
     0.0113),
    ("sjlt bf16 B=1", rl.sjlt_terms(1, N, D, M, shared=True), P16, 0.0014),
    ("sjlt int8 B=1", rl.sjlt_terms(1, N, D, M, a_itemsize=1, shared=True), P16, 0.0005),
    ("sjlt", rl.sjlt_terms(B, N, D, M), P32, 0.0227),
    ("sjlt shared A", rl.sjlt_terms(B, N, D, M, shared=True), P32, 0.0039),
    ("sjlt bf16", rl.sjlt_terms(B, N, D, M), P16, 0.0227),
    ("sjlt bf16, bf16 A", rl.sjlt_terms(B, N, D, M, a_itemsize=2), P16, 0.0127),
    ("sjlt int8", rl.sjlt_terms(B, N, D, M, a_itemsize=1), P16, 0.0077),
]


@pytest.mark.parametrize("row,terms,peak,want", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_phase3_bounds_to_4_digits(row, terms, peak, want):
    got, _ = rl.bound_ms(*terms, peak)
    assert f"{got:.4f}" == f"{want:.4f}", (row, got)


@pytest.mark.parametrize("arch", ["solver-ridge-gaussian", "solver-ridge-baseline"])
def test_solver_model_flops_equal_reference(arch):
    assert rl.SOLVER_SHAPES == ref.SOLVER_SHAPES
    assert rl.solver_model_flops(arch, "probe_2m_8k") == ref.solver_model_flops(
        arch, "probe_2m_8k")


def test_peaks_and_collective_term():
    """The data-sheet peaks and the ring all-reduce's
    per-rank bytes: 0 alone, 2·(K−1)/K of the payload among K ranks."""
    assert (rl.PEAK_FP32_FLOPS, rl.PEAK_BF16_FLOPS, rl.PEAK_BYTES) == (67e12, 989e12, 3.35e12)
    payload = 10 * 16 * 256 * 256 * 4
    assert rl.allreduce_bytes(payload, 1) == 0
    assert rl.allreduce_bytes(payload, 4) == 1.5 * payload
    assert rl.collective_ms(payload, 4) == pytest.approx(1.5 * payload / 450e9 * 1e3)


def test_chip_smoke_takes_its_peaks_from_roofline():
    """``chip_smoke.py`` keeps no peaks of its own: its bound is the module's."""
    spec = importlib.util.spec_from_file_location("chip_smoke_module", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.bound_ms is rl.bound_ms
    assert mod.PEAK_FP32_FLOPS is rl.PEAK_FP32_FLOPS and mod.PEAK_INSTR == rl.PEAK_INSTR


def test_lm_train_terms_of_phase_11():
    """chip_smoke.py phase 11's bounds at qwen2-0.5b (494,032,768 parameters
    with the qkv biases), B·S = 1024 tokens: 8·N·T FLOPs with remat, about
    60 ms at the fp32 peak and 4.1 ms at the bf16 one; AdamW's 28 B a
    parameter, 4.1 ms at the HBM rate."""
    n, tokens = 494_032_768, 8 * 128
    flops, nbytes = rl.lm_train_terms(n, tokens)
    assert flops == 8 * n * tokens and nbytes == 8 * n
    assert rl.bound_ms(flops, nbytes) == (pytest.approx(60.40, abs=0.01), "operations")
    assert rl.bound_ms(flops, nbytes, P16)[0] == pytest.approx(4.092, abs=1e-3)
    assert rl.bound_ms(*rl.adamw_terms(n)) == (pytest.approx(4.129, abs=1e-3), "bytes")
