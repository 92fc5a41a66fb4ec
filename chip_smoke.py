#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is passed over:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every CUDA kernel of ``src/repro_torch/kernels/csrc`` with
   nvcc, one process per source, all started together, and count each
   library's tensor-core instructions in its SASS (the bf16/int8 Gaussian
   leg must have some);
3. kernels against plain: at the main path's shapes, hold each kernel and
   each compute-dtype leg (fp32, bf16, int8) against its plain PyTorch
   version and time both (CUDA events, warm, median, with the wrapper's host
   time in; the kernel's and its yardstick's also with the host's enqueue
   hidden, ``card_ms``), beside the least time the card could take for the
   same work and a one-call PyTorch yardstick where one exists; the Gaussian and SJLT kernels also run twice and must
   repeat bitwise, and the Gaussian kernel's Box–Muller factors must equal
   the CUDA math library's on all 2^24 values of each uniform; every SJLT
   leg must also equal the plain version on the CPU bitwise, and the SJLT's
   bucket pass must equal its CPU model (``sjlt_buckets_ref``) exactly;
4. main path: a default ``SolverService`` on the card answers ridge
   requests of every default shape class (two full batches of the top
   Gaussian class, one of the SRHT class, and the three smaller classes);
   then five more services, one per (sketch, compute_dtype) in
   {gaussian, sjlt} × {fp32, bf16, int8} other than (gaussian, fp32), each
   answer two full batches of the top class and one of the SRHT class. Every
   answer is held against an fp64 direct solve; the launch counts are set to
   0 before each run and read after it, every kernel leg must have been
   launched, and each FWHT call of the SRHT class must be one launch;
5. main path under deadlines, at the top class (4096, 256, 512) and the
   SRHT class (16384, 256, 512) with B = 16 and phase 4's traffic: (a) a
   generous deadline (``segment_trips=8``, ``flush_deadline_s=3600``) gives
   answers bitwise equal to the monolithic service's, x and every
   certificate, for gaussian/fp32 (both classes) and sjlt/bf16 (top class);
   (b) ``deadline_s=0.0`` runs exactly one 8-trip segment: unfinished slots
   come back DEADLINE_EXCEEDED with finite x and δ̃, finished ones keep
   their verdicts, and x is bitwise ``finalize(prepare → segment(8))``;
   (c) an urgent request submitted after a patient backlog dispatches first,
   and one whose deadline has passed comes back expired without a solve;
   (d) the card's time per segment (CUDA events, medians) at 8 and 32 trips
   a segment, and the segmented service's wall time beside the monolithic
   one's. The launch counts are set to 0 before the phase and read after
   it; each kernel leg it runs must have been launched;
6. GLM and λ-path traffic on the main path: (a) logistic batches of 16
   (``synthetic_logistic_problem``, ν uniform in [0.1, 0.5]) at the top class
   in gaussian/fp32, gaussian/bf16 and sjlt/int8, and one SRHT-class batch in
   srht/fp32, by sketched Newton: every answer converged, its decrement
   within the service's ``newton_tol`` and its x within 1e-3 of an fp64 IRLS
   answer; (b) 16 top-class ridge requests over 8 values of ν
   (geomspace(1, 1e-2, 8)) in gaussian/fp32 and sjlt/bf16: every point
   within the ridge gate of phase 4, one sketch pass per chunk; (c) the same
   path traffic four times under ``ladder_cache=True``, cold, repeat, repeat
   on one service, then cold on a new one: each repeat round hits the cache,
   pays no sketch pass and launches no kernel, and every round answers
   bitwise as the first did; (d) wall times per GLM batch (with its Newton steps and
   inner solves), per path chunk (its prepare and per-point solves) and per
   fingerprint, and the launch counts of every leg over the phase, the
   Gaussian kernel's weighted fp32 and bf16 legs included;
7. preemption and chaos at full width, the top class and the SRHT class
   with B = 16 and phase 4's traffic: (a) in gaussian/fp32 (top),
   srht/fp32 (SRHT) and sjlt/int8 (top), a service with a checkpoint
   directory and ``segment_trips=8`` whose preemption flag turns on after
   its second poll raises ``PreemptedError`` with a committed checkpoint,
   and a new service with the same seed and submissions resumes it to
   answers bitwise an uninterrupted checkpointing run's, x and every
   certificate (ms per save and restore, bytes per checkpoint, the
   recomputed ``prepare``); (b) ``python -m repro_torch.launch.serve
   --preempt-after`` on the card: SIGTERM mid-flush, exit 75, a clean
   ``--resume``, every answer finite and audited; (c) one batch each in
   gaussian/fp32, gaussian/bf16, sjlt/int8 (top) and srht/fp32 (SRHT) with
   a NaN row, an Inf target and an adversarial seed: the faulty slots not
   OK (the adversarial one RETRIED), the clean neighbours OK and within
   1e-6 of the clean batch's answers (bitwise is printed), retries within
   the budget, every x finite; in gaussian/fp32 also a 4-shard dropout
   provider that lost shard 1 and a shard lost at segment 2 (a
   ``ShardLossInjector`` on an emulated ``ShardLadderCache``), every answer
   within the ridge gate; (d) every kernel leg at phase 3's shapes: a NaN
   in one problem's A, row weight or row scale leaves that problem's output
   non-finite and every other problem's bitwise the clean launch's. The
   launch counts are set to 0 before (a) and before (c) and read after
   each;
8. the paper's solvers and the sharded pass: (a) adaptive IHS and PCG
   (``core.adaptive``, Alg. 4.1/4.2) on fig1's scaled problem (n = 8192,
   d = 1024, σ_j = 0.995^(7000 j/d), ν ∈ {1e-1, 1e-2, 1e-3}, tol 1e-8) in
   sjlt, srht and gaussian, each answer within the ridge gate of an fp64
   direct solve, printed with m_final beside d_e, iterations, doublings,
   wall time and the fp32 Cholesky direct solve's time; the launch counts
   set to 0 just before each solve and read just after it, and summed over
   the solves per Pallas body: the B = 1 SJLT (sjlt.py:72), the scaled FWHT
   (fwht.py:43, SRHT ``apply``) and the shared-A Gaussian must be nonzero.
   The solver never calls ``apply_t``, in the reference either, so the
   unscaled FWHT (fwht.py:30) is off this path; after each solve the final
   sketch's ``apply_t`` is checked as the adjoint of ``apply`` (launches
   not counted). The B = 1 SJLT and shared-A Gaussian legs are then held
   against their plain versions through the wrappers the path calls, at the
   path's shapes and on its sketch data, and so is the unscaled FWHT at
   ``apply_t``'s shape; (b) 4 gloo
   ranks on the one card (``launch.mesh.run_ranks``): ``shard_level_grams``
   at the top class (B = 16, n = 4096, d = 256, m_max = 512) in
   gaussian/fp32, sjlt/int8 and srht/bf16 against the one-process
   ``BlockEmulationProvider(inner, 4)``, the per-shard form and
   ``ShardLadderCache.from_mesh`` bitwise ``from_emulation``, the
   all-reduce's bytes and ms, and 16 requests of the pod-scale class
   (65536, 256, 512, srht) through the sharded service under the ridge
   gate; in the same ranks, deadlines, checkpoints and preemption under
   the mesh at the top class (gaussian/fp32, 8-trip segments of the
   segmented driver): a generous deadline bitwise the no-deadline answer,
   a zero deadline that binds after the first segment, with the
   same statuses, DEADLINE_EXCEEDED slots and segments on every rank and
   each OK slot within the ridge gate, a zero deadline on every rank but
   the lead (never binds: bitwise the no-deadline answer, each slot within
   the ridge gate) and on the lead alone (binds every rank after the first
   segment, bitwise the all-ranks zero deadline), a preemption flag on rank 3 only
   that stops every rank at segment 2 with rank 0 alone writing the
   checkpoint and a resume bitwise the uninterrupted answer, the host
   verdict's ms a segment boundary per rank, and the pod-scale class again
   under per-request deadlines with a checkpoint directory (every answer
   OK under the ridge gate, the same EDF order and answers on every rank);
   each rank counts its kernel launches per task from 0, and the Gaussian,
   scaled FWHT and batched SJLT must have launched on the sharded tasks;
   (c) a one-rank NCCL group, its pass bitwise the one-device provider's;
   (d) the solver's pod-scale dry-run (``launch.dryrun_solver``): all six
   variants on the 16×16 and 2×16×16 fake meshes with status ok, their
   per-rank dot FLOPs, collective bytes and H100 data-sheet roofline
   terms;
9. the port's invariant audit on the card (``analysis.audit``): (a) the full
   registry (the reference's 55 entry points, the sharded ones in a
   one-rank NCCL group) passes every rule, every negative control fails
   under its own rule, and the kernel launches each entry point's run
   counted are printed; (b) at the top class (16, 4096, 256, 512) and the
   SRHT class (16, 16384, 256, 512), phase 4's traffic packed by the
   service, every family × compute dtype × {unweighted, weighted}
   one-touch pass's peak device memory above its entry (after a warm call
   of the same pass), beside the dense
   S's bytes and the Gaussian budget of the one-touch rule, the Gaussian's
   fp32 and bf16 passes gated under that budget (int8's quantization
   temporaries are the rule's documented allowance: printed, gated under
   the budget plus them), and the ``gaussian_dense`` passes under
   1.25 × (dense S + SA), its bf16 and int8 legs plus one A-sized fp32
   copy (4·B·n·d); the launch counts set
   to 0 before (b) and read
   after it, every leg launched; (c) the peak of one whole top-class flush
   in gaussian/fp32 and one SRHT-class flush in srht/fp32; (d) the segment
   state audit (an 8-trip segment at the top class allocates less than
   ``pre.pinvs``), the rebuild sentinel on a second flush of each class
   (nothing compiled or opened), and ``torch.cuda.memory_reserved()``'s
   growth over that second flush (printed, no gate);
10. LM serving and the ridge probe (``models``, ``serve.step``,
   ``launch.ridge_probe``): (a) at qwen2-0.5b's full width, seeded
   parameters, ``greedy_generate`` of B = 4 prompts of 32 tokens, 16 new, in
   fp32 and bf16: prefill ms, the median ms of a decode step, tokens/s, peak
   device memory of a warm call, the device's busy share of an 8-step
   decode window and the device activities it ran (``torch.profiler``;
   a window with no device time fails), the torch ops a step dispatches,
   and its device time against the bytes bound; the bf16 prefill logits
   against the fp32 ones, and one bf16 decode step scanned op by op
   (matmuls bf16, softmax and norm means fp32, the cache bf16); (b) fp32
   step-by-step decode of a
   12-token prompt against the uncached forward (rtol = atol = 2e-3, the
   reference's bound), and the cached greedy ids against an uncached
   argmax wherever the top-2 margin exceeds 1e-3; (c) one fp32 forward of a
   (2, 16) prompt on the card and on the CPU with the same parameters,
   within 1e-4 of the logits' scale; (d) the ten configs reduced, and
   recurrentgemma with a remainder layer: a forward, decode against
   prefill, gemma2's ring at prompts 40 and 20 around its window of 32;
   (e) the ridge probe at full width: features (8192, 896), the adaptive
   PCG/SJLT fit against an fp64 direct solve under phase 8's energy-norm
   gate, held-out MSE under 0.05 × mean(y²), the B = 1 SJLT (Pallas row 5)
   launched by the solve (counts set to 0 before it) and held against its
   plain version at the probe's shape;
11. LM training on one device (``train``, ``data.pipeline``,
   ``launch.train``; no kernel of the port is on this path, in the
   reference none either): (a) qwen2-0.5b at its full width, seeded
   parameters, B = 8 × S = 128 tokens of ``SyntheticLM``, 2 microbatches,
   remat, in fp32 and bf16: 10 steps on one batch, the last loss under
   TRAIN_GATE × the first, the median ms of the warm steps, tokens/s, the
   split between forward + backward and AdamW, the peak device memory of a
   warm step, the device's busy share and activities over one step
   (``torch.profiler``; a window with no device time fails), beside the
   8·N·T FLOPs bound and AdamW's 28 B a parameter; (b) every config
   reduced (and recurrentgemma with a remainder layer): one fp32 train step
   from the same parameters and batch on the card and on the CPU, loss
   and grad norm within 1e-4, every grad within 1e-3 of max |g|; (c) the
   blocked cross-entropy at the full vocab in 8 chunks against ``lm_loss``
   on the card, loss and every grad, and its peak device memory above
   entry at (8, 512) under ``lm_loss``'s; (d) the launcher on the card
   (reduced qwen2-0.5b, deterministic algorithms): 20 steps then a resume
   to 30, and a SIGTERM after step 10's log line then a resume to 30,
   every checkpointed leaf bitwise the uninterrupted 30 steps'; ``serve
   --ckpt-dir`` from that checkpoint, and ``launch.train_lm`` for a few
   steps;
12. sharded LM training and decode (``dist.sharding``,
   ``make_train_step(mesh=)``, ``serve.step`` under a mesh, ``launch.train
   --mesh``) on gloo ranks sharing the card (no kernel of the port is on
   this path, in the reference none either): (a) phase 11's qwen2-0.5b,
   seed, batch and AdamW on 4 ranks, mesh (2, 2), fsdp, the batch over
   data, SHARD_STEPS fp32 steps: loss and grad norm of each step within
   1e-4 relative of phase 11's fp32 steps; per rank the ms a step (CUDA
   events), the bytes a step gathers and reduces, one gather of every
   weight and one reduction of the full grads timed alone, the bytes of
   placed state against 16 B × N / 4, and the peak device memory of a warm
   step; (b) every config reduced (and recurrentgemma with a remainder
   layer) on 2 ranks, mesh (2, 1), fsdp, a ragged mask split over data:
   one fp32 step against the single-device step on the card, loss and
   grad norm within 1e-4, every parameter within 1e-4; (c) greedy decode
   at qwen2-0.5b's full width on (2, 2), B = 4 prompts of 32, 8 tokens:
   every step's logits within 2e-4 of the single-device decode, the ids
   equal, each cache placed as it went in and left unchanged; (d)
   ``launch.train --mesh 4 --deterministic`` at reduced qwen2-0.5b: 10
   steps then a relaunch to 15, and a SIGTERM to rank 2 after step 5's log
   line (every rank exits 75 having committed one step) then a relaunch to
   15, every checkpointed leaf bitwise the uninterrupted 15 steps';
13. the quickstart leg and the model dry-run (``launch.quickstart``,
   ``launch.dryrun``, ``analysis.report``): (a) ``examples/quickstart.py``'s
   sizes on the card: the ridge leg (n = 8192, d = 1024, ν = 1e-2, the
   0.99^i spectrum) with its direct and adaptive PCG/SJLT answers within
   phase 8's energy-norm gate of an fp64 direct solve, CG's rel_err
   printed (it has no stop, as in the reference), m_final ≤ 2d, printed
   beside d_e, the B = 1 SJLT (Pallas row 5) launched; the logistic leg
   (B = 8, n = 2048, d = 64, m_max = 128, ν = 0.3) every answer within 1e-3
   of an fp64 IRLS, all converged, the weighted fp32 Gaussian leg (Pallas
   row 2) launched and held against its plain version at the Newton
   systems' shape; each solver's ms (CUDA events), each leg run twice (a
   first call and a repeat); launch counts set to 0 just before each
   leg's two runs and read just after; (b) on the host, qwen2-0.5b
   × every shape traced on the 16×16 fake mesh (ok, or skipped by
   ``skip_reason``), then phase 12 (a)'s configuration on a fake (2, 2)
   mesh, its per-rank argument bytes beside phase 12's measured placed
   state and its arguments + temp beside phase 12's measured warm-step
   peak (printed, not gated), and the report's table of these records;
14. summary: one ``{"kernels": [...]}`` line, then the device line last.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM peaks and each Pallas body's (FLOPs, bytes) at given shapes
from repro_torch.analysis.roofline import (  # noqa: E402
    PEAK_BF16_FLOPS,
    PEAK_FP32_FLOPS,
    PEAK_INSTR,
    bound_ms,
    fwht_terms,
    gauss_sa_terms,
    sjlt_terms,
)

# Operations the Gaussian kernel spends on one S entry, counted by hand in
# its source (csrc/gaussian_sa.cu: mix32, uniforms, radius, cosine), taken
# as one instruction each: the counter and two murmur3 finalizers 18, the
# two uniforms 7, logf 18, sqrtf 7, cosf 22, the product and the column
# scale 2. An estimate, not a count of the compiled code, so it is printed
# with its derivation and kept out of the kernels line.
GEN_INSTR_PER_ENTRY = 74
# kernel vs plain: fp32 sums of n products taken in two orders differ by
# about sqrt(n)·2^-24 of the result's scale; an indexing fault shows as O(1)
GAUSSIAN_REL_TOL = 1e-4
# Gaussian bf16/int8 legs: besides the order of the sums, an S entry that the
# kernel's logf/cosf and torch's log/cos put on two sides of a bf16 rounding
# boundary differs by one bf16 ulp, 2^-8 of the entry, which moves its output
# entry by about 2^-8·|S|·|A| ≈ 3e-4 of max|SA| at these shapes
GAUSSIAN_REDUCED_REL_TOL = 1e-3
# FWHT: both run the same butterfly stages in the same order: exact, in fp32
# and in bf16
FWHT_REL_TOL = 0.0
# SJLT: exact products (±1 signs, or bf16 × bf16), fp32 sums of about n/M
# terms; the plain version's index_add_ adds them in another order on the
# card
SJLT_REL_TOL = 1e-5
# main path: each solution against an fp64 direct solve, in the energy norm
# ‖e‖_H / ‖x‖_H that the δ̃ certificate measures, within 1e-3 or within
# 2^-24·κ(H)·√k where that is larger, k the answer's PCG iterations. The
# engine's PCG, like the JAX reference's, runs in fp32 with a recursively
# updated residual; the gap between it and the true residual grows by about
# 2^-24·‖H‖·‖x‖ per iteration, so the attainable accuracy is about
# 2^-24·κ(H)·√k whatever the δ̃ tolerance, and κ(H) reaches 1e6 at ν = 1e-3
# on this spectrum. The error against the fp64 solve of the fp32-rounded
# normal equations is printed beside it: it is the same, so the fp32 Gram
# is not what limits the accuracy.
SOLVE_REL_TOL = 1e-3
FP32_UNIT = 2.0 ** -24


def time_ms(fn, reps: int, warm: int = 2, hide_host: bool = False) -> float:
    """``launch/anatomy.py``'s timing: the median time of one call on the
    card, with its host time in unless ``hide_host``."""
    from repro_torch.launch import anatomy

    return anatomy.time_ms(fn, reps, warm, hide_host)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    return smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} libraries compiled in "
          f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    # tensor-core instructions (wgmma: HGMMA; mma.sync: HMMA) in each
    # library's SASS
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    for name in _build.SIGNATURES:
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build._target(name))],
                              capture_output=True, text=True, check=True).stdout
        counts = {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HGMMA", "HMMA")}
        print(f"[build] {name}: tensor-core instructions in SASS {counts}")
        if name == "gaussian_sa" and not counts["HGMMA"] + counts["HMMA"]:
            raise SystemExit("chip_smoke: the bf16/int8 Gaussian leg has no tensor-core "
                             "instruction")


def _compare(name, got, want, tol):
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel = err / scale if scale else err
    ok = bool(torch.isfinite(got).all()) and rel <= tol
    print(f"[kernel] {name}: max_abs_err {err:.3e}, rel {rel:.3e} "
          f"(tolerance {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: kernel {name} disagrees with its plain version")
    return err


def _measure(label, kern, plain, terms, tol, peak=PEAK_FP32_FLOPS,
             library=None, library_ms=None):
    """Hold a kernel call against its plain version and time both, and the
    one-call PyTorch yardstick ``library`` where there is one (or take its
    time, ``library_ms``, measured once for several rows)."""
    err = _compare(label, kern(), plain(), tol)
    ms, pms = time_ms(kern, reps=10), time_ms(plain, reps=3, warm=1)
    card_ms = time_ms(kern, reps=10, hide_host=True)
    lms = library_ms if library is None else time_ms(library, reps=10)
    lcard = None if library is None else time_ms(library, reps=10, hide_host=True)
    bms, by = bound_ms(*terms, peak)
    print(f"[kernel] {label}: {ms:.4f} ms ({card_ms:.4f} ms on the card alone), "
          f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by})"
          + ("" if lms is None else f", library yardstick {lms:.4f} ms")
          + ("" if lcard is None else f" ({lcard:.4f} ms on the card alone)"))
    return {"variant": label, "max_abs_err": err, "ms": ms, "card_ms": card_ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by, "library_ms": lms,
            "library_card_ms": lcard}


def signed_onehot(tgt, signs, M):
    """The SJLT's dense (B, M, n) sketch: signs[b, i] at (b, tgt[b, i], i),
    targets outside [0, M) dropped; the one-hot product's yardstick S."""
    import torch

    B, n = tgt.shape
    t = torch.where((tgt >= 0) & (tgt < M), tgt.long(), M)
    S = torch.zeros((B, M + 1, n), device=tgt.device)
    S.scatter_(1, t[:, None, :], signs[:, None, :].float())
    return S[:, :M].contiguous()


def _repeats(name, fn):
    """Two launches of ``fn`` must give bitwise equal results."""
    import torch

    first, again = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise SystemExit(f"chip_smoke: {name} does not repeat bitwise")
    print(f"[kernel] {name}: two launches bitwise equal")


def _row(name, source, replaces, recs, **extra):
    """One entry of the kernels line: the first measurement is the row's,
    the others are its variants."""
    head = {k: recs[0][k] for k in ("max_abs_err", "ms", "card_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library_card_ms")}
    return dict(name=name, route="cuda", source=source, replaces=replaces, **head,
                **extra, variants=recs[1:])


def phase_kernels():
    import torch

    from repro_torch.dist.compress import quantize_rows
    from repro_torch.kernels import ops
    from repro_torch.kernels import sjlt as ksj
    from repro_torch.kernels.fwht import (
        active_clusters,
        cluster_plan,
        fwht_ref,
        hadamard_dense,
        split_plan,
    )
    from repro_torch.kernels.gaussian_gram import (
        entry_mismatches,
        gaussian_s_dense,
        gaussian_sa_cuda,
        gaussian_sa_ref,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    src = "src/repro_torch/kernels/csrc/"
    ref_g = "src/repro/kernels/gaussian_gram.py"
    ref_s = "src/repro/kernels/sjlt.py"

    # Gaussian sketch→SA at the top Gaussian class: B=16, n=4096, d=256, m=512
    B, n, d, m = 16, 4096, 256, 512
    A = torch.randn((B, n, d), generator=g, device=dev) / n ** 0.5
    A_sh = torch.randn((n, d), generator=g, device=dev) / n ** 0.5
    seeds = torch.randint(0, 2 ** 32, (B,), generator=g, device=dev, dtype=torch.int64)
    w = torch.rand((B, n), generator=g, device=dev) + 0.5
    ws = torch.sqrt(w)
    bad = entry_mismatches()
    print(f"[kernel] gaussian_sa Box–Muller: {bad} of the 2·2^24 values of u1 and u2 "
          f"give another radius sqrt(-2·log u1) or cosine cos(2π·u2) than the CUDA "
          f"math library's logf/sqrtf and cosf")
    if bad:
        raise SystemExit("chip_smoke: the Gaussian kernel's Box–Muller differs from libm's")
    # what generating S would cost at the card's issue rate, beside the bound
    gen_ms = B * m * n * GEN_INSTR_PER_ENTRY / PEAK_INSTR * 1e3
    print(f"[kernel] gaussian_sa generation floor (estimate): {B}·{m}·{n} entries × "
          f"{GEN_INSTR_PER_ENTRY} operations an entry (counted in the source, one "
          f"instruction each) / {PEAK_INSTR:.4g} instructions/s "
          f"(132 SMs × 4 schedulers × 32 lanes × 1.98 GHz) = {gen_ms:.4f} ms")

    # yardsticks: one bmm of the dense S, materialized outside the timing
    # (pre-scaled for the scaled rows), in the leg's operand dtype
    bf = torch.bfloat16
    S = gaussian_s_dense(seeds, m, n)
    S_w = S * ws[:, None, :]
    _repeats("gaussian_sa", lambda: ops.gaussian_sa(A, seeds, m))
    recs = [
        _measure("gaussian_sa per-problem A", lambda: ops.gaussian_sa(A, seeds, m),
                 lambda: gaussian_sa_ref(A, seeds, m), gauss_sa_terms(B, n, d, m),
                 GAUSSIAN_REL_TOL, library=lambda: torch.bmm(S, A)),
        _measure("gaussian_sa shared A", lambda: ops.gaussian_sa(A_sh, seeds, m),
                 lambda: gaussian_sa_ref(A_sh, seeds, m), gauss_sa_terms(B, n, d, m, shared=True),
                 GAUSSIAN_REL_TOL, library=lambda: torch.matmul(S.reshape(B * m, n), A_sh)),
    ]
    rows.append(_row("gaussian_sa", src + "gaussian_sa.cu", ref_g + ":210", recs))
    recs = [_measure("gaussian_sa.weighted (row weights, Pallas row 2)",
                     lambda: ops.gaussian_sa(A, seeds, m, row_weights=w),
                     lambda: gaussian_sa_ref(A, seeds, m, scale=ws),
                     gauss_sa_terms(B, n, d, m, scaled=True), GAUSSIAN_REL_TOL,
                     library=lambda: torch.bmm(S_w, A))]
    rows.append(_row("gaussian_sa.weighted", src + "gaussian_sa.cu", ref_g + ":234", recs))
    # bf16 leg as the service calls it: fp32 A rounded to bf16 on load; and
    # with A stored in bf16
    A_bf = A.to(bf)
    S_bf, S_w_bf = S.to(bf), S_w.to(bf)
    _repeats("gaussian_sa.bf16", lambda: gaussian_sa_cuda(A, seeds, m, compute_dtype="bf16"))
    recs = [
        _measure("gaussian_sa.bf16 (fp32 A)",
                 lambda: gaussian_sa_cuda(A, seeds, m, compute_dtype="bf16"),
                 lambda: gaussian_sa_ref(A, seeds, m, compute_dtype="bf16"),
                 gauss_sa_terms(B, n, d, m), GAUSSIAN_REDUCED_REL_TOL, PEAK_BF16_FLOPS,
                 library=lambda: torch.bmm(S_bf, A_bf)),
        _measure("gaussian_sa.bf16 (bf16 A)",
                 lambda: gaussian_sa_cuda(A_bf, seeds, m, compute_dtype="bf16"),
                 lambda: gaussian_sa_ref(A_bf, seeds, m, compute_dtype="bf16"),
                 gauss_sa_terms(B, n, d, m, a_itemsize=2), GAUSSIAN_REDUCED_REL_TOL,
                 PEAK_BF16_FLOPS,
                 library=lambda: torch.bmm(S_bf, A_bf)),
    ]
    recs_w = [_measure("gaussian_sa.bf16.weighted (row weights, Pallas row 2)",
                       lambda: gaussian_sa_cuda(A, seeds, m, scale=ws, compute_dtype="bf16"),
                       lambda: gaussian_sa_ref(A, seeds, m, scale=ws, compute_dtype="bf16"),
                       gauss_sa_terms(B, n, d, m, scaled=True),
                       GAUSSIAN_REDUCED_REL_TOL, PEAK_BF16_FLOPS,
                       library=lambda: torch.bmm(S_w_bf, A_bf))]
    # the same bmm with S generated inside the timing by the plain hash
    gen_incl = time_ms(lambda: torch.bmm(gaussian_s_dense(seeds, m, n).to(bf), A_bf), reps=3)
    print(f"[kernel] gaussian_sa.bf16 yardstick with generation: bmm(gaussian_s_dense(...)"
          f".to(bf16), A_bf16) {gen_incl:.4f} ms, S generated by the plain hash inside "
          f"the timing")
    del S_bf, S_w_bf
    rows.append(_row("gaussian_sa.bf16", src + "gaussian_sa.cu", ref_g + ":210", recs,
                     library_with_generation_ms=gen_incl))
    rows.append(_row("gaussian_sa.bf16.weighted", src + "gaussian_sa.cu", ref_g + ":234",
                     recs_w))
    # int8 leg: the codes stream, their row scales fold into the column scale
    codes, a_scales = quantize_rows(A)
    S_a = (S * a_scales[:, None, :]).to(bf)
    codes_bf = codes.to(bf)
    _repeats("gaussian_sa.int8", lambda: gaussian_sa_cuda(codes, seeds, m, scale=a_scales,
                                                          compute_dtype="int8"))
    recs = [_measure("gaussian_sa.int8",
                     lambda: gaussian_sa_cuda(codes, seeds, m, scale=a_scales,
                                              compute_dtype="int8"),
                     lambda: gaussian_sa_ref(codes, seeds, m, scale=a_scales,
                                             compute_dtype="int8"),
                     gauss_sa_terms(B, n, d, m, a_itemsize=1, scaled=True),
                     GAUSSIAN_REDUCED_REL_TOL, PEAK_BF16_FLOPS,
                     library=lambda: torch.bmm(S_a, codes_bf))]
    del S, S_w, S_a, codes_bf
    rows.append(_row("gaussian_sa.int8", src + "gaussian_sa.cu", ref_g + ":234", recs))

    # SJLT at the top class under sketch="sjlt": B=16, n=4096, d=256, M=512
    M = 512
    tgt = torch.randint(0, M, (B, n), generator=g, device=dev, dtype=torch.int32)
    sg = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    for t_, s_ in ((tgt, sg), (tgt[:1], sg[:1])):
        got = ksj.sjlt_launch_buckets(A_sh, t_, s_, M)
        want = ksj.sjlt_buckets_ref(t_.cpu(), s_.cpu(), M)
        if not all(torch.equal(x.cpu(), y) for x, y in zip(got, want)):
            raise SystemExit(f"chip_smoke: the SJLT bucket pass at B = {len(t_)} differs "
                             f"from sjlt_buckets_ref")
        print(f"[kernel] sjlt bucket pass at B = {len(t_)}: offsets, order and order_s "
              f"equal sjlt_buckets_ref")
    print("[kernel] sjlt yardstick: the dense signed one-hot S (B, M, n) times A, S built "
          "outside the timing; bf16 operands with an fp32 result")

    def sjlt_leg(label, A_in, t_, s_, cd, a_itemsize, peak):
        # the stream the kernel reads: int8 quantizes A and folds the scales
        # into the signs, bf16 rounds the signs; A_in itself stays as it is
        A_s, s_s = ksj.fold_stream(A_in, s_, cd)
        Bq = t_.shape[0]
        kern = lambda: ksj.sjlt_launch(A_s, t_, s_s, M, compute_dtype=cd)  # noqa: E731
        _repeats(label, kern)
        if not torch.equal(kern().cpu(), ksj.sjlt_ref_batched(A_in.cpu(), t_.cpu(), s_.cpu(),
                                                               M, cd)):
            raise SystemExit(f"chip_smoke: {label} is not bitwise the plain version on the CPU")
        print(f"[kernel] {label}: bitwise the plain version on the CPU")
        S, A_y, kw = signed_onehot(t_, s_s, M), A_s, {}
        if cd != "fp32":
            S, A_y = S.to(torch.bfloat16), A_s.to(torch.bfloat16)
            kw = {"out_dtype": torch.float32}
        if A_y.dim() == 3:
            library = lambda: torch.bmm(S, A_y, **kw)  # noqa: E731
        else:
            library = lambda: torch.mm(S.reshape(Bq * M, n), A_y, **kw).view(Bq, M, d)  # noqa: E731
        plain = lambda: ksj.sjlt_ref_batched(A_s, t_, s_s, M, cd)  # noqa: E731
        want = plain()
        lerr = float((library().float() - want).abs().max()) / float(want.abs().max())
        print(f"[kernel] {label} yardstick: rel err {lerr:.3e} against the plain version")
        terms = sjlt_terms(Bq, n, d, M, a_itemsize=a_itemsize, shared=A_in.dim() == 2)
        return _measure(label, kern, plain, terms, SJLT_REL_TOL, peak, library=library)

    rows.append(_row("sjlt", src + "sjlt.cu", ref_s + ":140", [
        sjlt_leg("sjlt", A, tgt, sg, "fp32", 4, PEAK_FP32_FLOPS),
        sjlt_leg("sjlt shared A", A_sh, tgt, sg, "fp32", 4, PEAK_FP32_FLOPS),
        sjlt_leg("sjlt single problem (sjlt.py:72)", A_sh, tgt[:1], sg[:1], "fp32",
                 4, PEAK_FP32_FLOPS)]))
    rows.append(_row("sjlt.bf16", src + "sjlt.cu", ref_s + ":140", [
        sjlt_leg("sjlt.bf16", A, tgt, sg, "bf16", 4, PEAK_BF16_FLOPS),
        sjlt_leg("sjlt.bf16 (bf16 A)", A_bf, tgt, sg, "bf16", 2, PEAK_BF16_FLOPS),
        sjlt_leg("sjlt.bf16 single problem (sjlt.py:72)", A_sh, tgt[:1], sg[:1], "bf16",
                 4, PEAK_BF16_FLOPS)]))
    rows.append(_row("sjlt.int8", src + "sjlt.cu", ref_s + ":140", [
        sjlt_leg("sjlt.int8", A, tgt, sg, "int8", 1, PEAK_BF16_FLOPS),
        sjlt_leg("sjlt.int8 single problem (sjlt.py:72)", A_sh, tgt[:1], sg[:1], "int8",
                 1, PEAK_BF16_FLOPS)]))
    del A, A_sh, A_bf, w, codes, a_scales

    # FWHT at the SRHT class: B=16, n=16384, d=256, with the SRHT signs fused
    B, n, d = 16, 16384, 256
    X = torch.randn((B, n, d), generator=g, device=dev)
    s = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    print(f"[kernel] fwht at n={n}: {len(split_plan(n))} launch, clusters of "
          f"{cluster_plan(n)[1]} blocks of {cluster_plan(n)[0]} rows; resident clusters "
          f"{active_clusters(n)} (fp32 tile), "
          f"{active_clusters(n, torch.float32, torch.bfloat16)} (bf16 tile)")
    # yardstick for every leg: one fp32 matmul by the dense Hadamard matrix,
    # built outside the timing (the row scale is O(n·d) beside it)
    H = hadamard_dense(n, device=dev)
    dense_ms = time_ms(lambda: torch.matmul(H, X), reps=5, warm=1)
    del H
    print(f"[kernel] fwht yardstick: torch.matmul(hadamard_dense({n}), X) fp32 "
          f"{dense_ms:.4f} ms")
    recs = [
        _measure("fwht signs fused", lambda: ops.fwht_cols(X, row_scale=s),
                 lambda: fwht_ref(X * s[:, :, None]), fwht_terms(B, n, d, scaled=True),
                 FWHT_REL_TOL, library_ms=dense_ms),
        _measure("fwht unscaled", lambda: ops.fwht_cols(X), lambda: fwht_ref(X),
                 fwht_terms(B, n, d), FWHT_REL_TOL, library_ms=dense_ms),
    ]
    rows.append(_row("fwht", src + "fwht.cu", "src/repro/kernels/fwht.py:43", recs))
    # bf16 leg: fp32 A in, every stage rounded to bf16, a bf16 stack out; the
    # plain version is the one-pass bf16 butterfly
    bf = torch.bfloat16
    recs = [_measure("fwht.bf16 signs fused",
                     lambda: ops.fwht_cols(X, row_scale=s, compute_dtype="bf16"),
                     lambda: fwht_ref(X.to(bf) * s.to(bf)[:, :, None]),
                     fwht_terms(B, n, d, out_itemsize=2, scaled=True),
                     FWHT_REL_TOL, library_ms=dense_ms),
            _measure("fwht.bf16 unscaled", lambda: ops.fwht_cols(X, compute_dtype="bf16"),
                     lambda: fwht_ref(X.to(bf)), fwht_terms(B, n, d, out_itemsize=2),
                     FWHT_REL_TOL, library_ms=dense_ms)]
    rows.append(_row("fwht.bf16", src + "fwht.cu", "src/repro/kernels/fwht.py:43", recs))
    # int8 leg: the codes in, their row scales fused with the signs
    codes, a_scales = quantize_rows(X)
    s8 = s * a_scales
    recs = [_measure("fwht.int8 signs·scales fused",
                     lambda: ops.fwht_cols(codes, row_scale=s8, compute_dtype="int8"),
                     lambda: fwht_ref(codes.to(bf) * s8.to(bf)[:, :, None]),
                     fwht_terms(B, n, d, x_itemsize=1, out_itemsize=2, scaled=True),
                     FWHT_REL_TOL, library_ms=dense_ms)]
    rows.append(_row("fwht.int8", src + "fwht.cu", "src/repro/kernels/fwht.py:43", recs))
    del X, s, codes, a_scales, s8
    torch.cuda.empty_cache()
    return rows


# main-path traffic: (count, n range, d range) per shape class of the
# default service; ν is log-uniform in [1e-3, 1e-1]
TRAFFIC = [
    (6, (64, 256), (8, 32)),             # class (256, 32, 64)
    (5, (257, 1024), (33, 64)),          # class (1024, 64, 128)
    (5, (1025, 2048), (65, 128)),        # class (2048, 128, 256)
    (32, (2049, 4096), (129, 256)),      # class (4096, 256, 512): two batches
    (16, (8193, 16384), (129, 256)),     # class (16384, 256, 512, srht)
]
# the (sketch, compute_dtype) runs after the default one: two full batches
# of the top class (under the run's sketch) and one of the SRHT class (whose
# FWHT runs in the run's dtype)
MODES = [("gaussian", "bf16"), ("gaussian", "int8"), ("sjlt", "fp32"),
         ("sjlt", "bf16"), ("sjlt", "int8")]
MODE_TRAFFIC = TRAFFIC[-2:]
DECAY = 0.95


def _request(g, dev, n_rng, d_rng):
    """A = U·diag(0.95^i)·Vᵀ with orthonormal U, V (ill-conditioned, so the
    ladders climb), y ~ N(0, I), ν log-uniform in [1e-3, 1e-1]."""
    from repro_torch.launch.sharded import ridge_request

    return ridge_request(g, dev, n_rng, d_rng, DECAY)


def phase_main_path(dev="cuda", sketch="gaussian", compute_dtype="fp32",
                    traffic=TRAFFIC, seed=1):
    """A SolverService with this default sketch family and sketch-pass
    dtype answers the traffic; returns the kernel legs' launch counts over
    the run, which are set to 0 just before it."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.solver_service import SolverService

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    requests = [_request(g, dev, n_rng, d_rng)
                for count, n_rng, d_rng in traffic for _ in range(count)]
    svc = SolverService(sketch=sketch, compute_dtype=compute_dtype, device=dev)
    tag = f"[main {sketch}/{compute_dtype}]"
    per_class = {}
    solve_chunk = svc._solve_chunk

    def timed_chunk(cls, reqs, **kw):     # per-class wall time and launches
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        out = solve_chunk(cls, reqs, **kw)
        rec = per_class.setdefault(cls, {"seconds": 0.0, "requests": 0,
                                         "launches": dict.fromkeys(before, 0)})
        rec["seconds"] += time.perf_counter() - t0
        rec["requests"] += len(reqs)
        for k in before:
            rec["launches"][k] += ops.LAUNCHES[k] - before[k]
        return out

    svc._solve_chunk = timed_chunk
    # sketch passes of the SRHT class: each ops.fwht_cols call is one
    fwht_cols, fwht_calls = ops.fwht_cols, [0]

    def counted_fwht(*args, **kwargs):
        fwht_calls[0] += 1
        return fwht_cols(*args, **kwargs)

    ops.fwht_cols = counted_fwht
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        ids = [svc.submit(A, y, nu) for A, y, nu in requests]
        sols = svc.flush()
    finally:
        ops.fwht_cols = fwht_cols
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    fwht_launches = launches[ops.leg("fwht", compute_dtype)]
    print(f"{tag} FWHT: {fwht_launches} launches over {fwht_calls[0]} sketch passes of "
          f"the SRHT class")
    if fwht_launches != fwht_calls[0]:
        raise SystemExit(f"chip_smoke: the FWHT took {fwht_launches} launches for "
                         f"{fwht_calls[0]} sketch passes; one each expected")
    print(f"{tag} {len(ids)} requests answered in {wall:.3f} s "
          f"({len(ids) / wall:.2f} req/s, first-call set-up included); "
          f"{svc.stats['batches']} batches of {svc.batch_size}, "
          f"{svc.stats['padded_slots']} padded slots; launches {launches}")

    worst, failures = 0.0, []
    by_class = {}
    for rid, (A, y, nu) in zip(ids, requests):
        s = sols[rid]
        A64 = A.double()
        H = A64.T @ A64 + nu ** 2 * torch.eye(A.shape[1], dtype=torch.float64, device=dev)
        x64 = torch.linalg.solve(H, A64.T @ y.double())
        e = s.x.double() - x64
        err = float(torch.sqrt((e @ H @ e) / (x64 @ H @ x64)))
        err2 = float(torch.linalg.norm(e) / torch.linalg.norm(x64))
        # the fp32-rounded normal equations, solved in fp64
        H32 = (A.T @ A).double() + nu ** 2 * torch.eye(
            A.shape[1], dtype=torch.float64, device=dev)
        x32 = torch.linalg.solve(H32, (A.T @ y).double())
        e32 = s.x.double() - x32
        err32 = float(torch.sqrt((e32 @ H32 @ e32) / (x32 @ H32 @ x32)))
        ev = torch.linalg.eigvalsh(H)
        tol = max(SOLVE_REL_TOL,
                  FP32_UNIT * float(ev[-1] / ev[0]) * max(s.iters, 1) ** 0.5)
        worst = max(worst, err / tol)
        by_class.setdefault(s.shape_class, []).append((s, err, err2, err32, err / tol))
        if s.status not in ("OK", "RETRIED") or not err <= tol:
            failures.append((rid, s.status, err, tol))
    for cls, rows in by_class.items():
        rec = per_class[cls]
        hist = {}
        for s, *_ in rows:
            hist[s.status] = hist.get(s.status, 0) + 1
        m = sorted(s.m_final for s, *_ in rows)
        dts = [s.delta_tilde for s, *_ in rows if s.converged]
        print(f"{tag} class n={cls.n} d={cls.d} m_max={cls.m_max} "
              f"sketch={cls.sketch or svc.sketch} dtype={cls.compute_dtype or svc.compute_dtype}: "
              f"{rec['requests']} requests, "
              f"{rec['requests'] / rec['seconds']:.2f} req/s, statuses {hist}, "
              f"m_final min/median/max {m[0]}/{m[len(m) // 2]}/{m[-1]}, "
              f"max δ̃ {max(dts) if dts else float('nan'):.3e}, "
              f"max rel err vs fp64: H-norm {max(r[1] for r in rows):.3e}, "
              f"2-norm {max(r[2] for r in rows):.3e}, against the fp64 solve of "
              f"the fp32 normal equations: H-norm {max(r[3] for r in rows):.3e}; "
              f"worst share of tolerance {max(r[4] for r in rows):.3f}, "
              f"launches {({k: v for k, v in rec['launches'].items() if v})}")
    print(f"{tag} worst H-norm rel err vs fp64 direct solve, as a share of its "
          f"tolerance max({SOLVE_REL_TOL:g}, 2^-24·κ(H)·√k): {worst:.3f}")
    if failures:
        raise SystemExit(f"chip_smoke: main path failures (id, status, rel err, "
                         f"tolerance): {failures[:10]}")
    family = {"gaussian": "gaussian_sa", "sjlt": "sjlt"}[sketch]
    missing = [k for k in (ops.leg(family, compute_dtype), ops.leg("fwht", compute_dtype))
               if launches[k] <= 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernel legs {missing} were never launched "
                         f"by the {sketch}/{compute_dtype} service run")
    return launches


def _ridge_gate(x, A, y, nu, iters, rhs=None):
    """(H-norm rel error vs the fp64 direct solve, its tolerance) of one
    answer: phase 4's gate, for a λ-path point or a phase 7 answer; ``rhs``
    replaces Aᵀy for a problem given as (A, b, ν)."""
    import torch

    A64 = A.double()
    H = A64.T @ A64 + nu ** 2 * torch.eye(A.shape[1], dtype=torch.float64, device=A.device)
    x64 = torch.linalg.solve(H, A64.T @ y.double() if rhs is None else rhs.double())
    e = x.double() - x64
    err = float(torch.sqrt((e @ H @ e) / (x64 @ H @ x64)))
    ev = torch.linalg.eigvalsh(H)
    tol = FP32_UNIT * float(ev[-1] / ev[0]) * max(int(iters), 1) ** 0.5
    return err, max(SOLVE_REL_TOL, tol)


def _same_answer(a, b) -> bool:
    """x bitwise equal and every certificate equal (a NaN δ̃ equals NaN)."""
    import torch

    dt_same = a.delta_tilde == b.delta_tilde or (a.delta_tilde != a.delta_tilde
                                                 and b.delta_tilde != b.delta_tilde)
    return (torch.equal(a.x, b.x) and dt_same
            and (a.m_final, a.iters, a.doublings, a.status)
            == (b.m_final, b.iters, b.doublings, b.status))


def phase_deadlines(smi, seed=20):
    """The main path under deadlines (phase 5); returns the kernel legs'
    launch counts over its runs, which are set to 0 just before them."""
    import torch

    from repro_torch.core import adaptive_padded as ap
    from repro_torch.core.robust import robust_padded_solve_batched
    from repro_torch.core.status import SolveStatus
    from repro_torch.kernels import ops
    from repro_torch.serve.solver_service import RidgeRequest, SolverService

    dev = torch.device("cuda")
    tag = "[deadline]"
    g = torch.Generator(device=dev).manual_seed(seed)
    (_, top_n, top_d), (_, srht_n, srht_d) = TRAFFIC[-2], TRAFFIC[-1]
    top = [_request(g, dev, top_n, top_d) for _ in range(16)]
    srht = [_request(g, dev, srht_n, srht_d) for _ in range(16)]
    ops.reset_launches()

    def serve(reqs, sketch, cd, **kw):
        svc = SolverService(sketch=sketch, compute_dtype=cd, device=dev, **kw)
        ids = [svc.submit(A, y, nu) for A, y, nu in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sols = svc.flush()
        torch.cuda.synchronize()
        return [sols[i] for i in ids], time.perf_counter() - t0, svc

    # (a) a generous deadline is bitwise the monolithic service
    for label, reqs, sketch, cd in (("gaussian/fp32, top + SRHT class", top + srht,
                                     "gaussian", "fp32"),
                                    ("sjlt/bf16, top class", top, "sjlt", "bf16")):
        mono, t_mono, _ = serve(reqs, sketch, cd)
        seg, t_seg, svc = serve(reqs, sketch, cd, segment_trips=8, flush_deadline_s=3600.0)
        # the same again in the other order, so neither side always runs first
        seg2, t_seg2, _ = serve(reqs, sketch, cd, segment_trips=8, flush_deadline_s=3600.0)
        mono2, t_mono2, _ = serve(reqs, sketch, cd)
        bad = [i for i, (a, b, c, e) in enumerate(zip(mono, seg, seg2, mono2))
               if not (_same_answer(a, b) and _same_answer(a, c) and _same_answer(a, e))]
        hist = {}
        for s in seg:
            hist[s.status] = hist.get(s.status, 0) + 1
        print(f"{tag} (a) {label}: {len(reqs)} answers, segmented (8 trips a segment, "
              f"{svc.stats['segments']} segments, deadline 3600 s) vs monolithic: "
              f"{len(reqs) - len(bad)} bitwise equal in x, δ̃, m_final, iters, doublings "
              f"and status; statuses {hist}; wall monolithic {t_mono:.4f} / {t_mono2:.4f} s, "
              f"segmented {t_seg:.4f} / {t_seg2:.4f} s ({smi})")
        if bad or svc.stats["segments"] <= 0 or svc.stats["deadline_exceeded"]:
            raise SystemExit(f"chip_smoke: the segmented service differs from the "
                             f"monolithic one ({label}) at requests {bad[:10]}, or did not "
                             f"segment, or expired")

    # (b) deadline_s = 0.0 runs exactly one 8-trip segment
    svc = SolverService(device=dev)
    cls = svc.bucket_for(*top[0][0].shape)
    q, seeds = svc._pack(cls, [RidgeRequest(i, A, y, nu) for i, (A, y, nu) in enumerate(top)])
    kw = dict(m_max=cls.m_max, method=svc.method, max_iters=svc.max_iters, rho=svc.rho,
              tol=svc.tol, device=dev)
    x, s = robust_padded_solve_batched(q, seeds, deadline_s=0.0, segment_trips=8, **kw)
    pre, st = ap.prepare_padded_solve(q, seeds, m_max=cls.m_max, tol=svc.tol, device=dev)
    st = ap.padded_solve_segment(q, pre, st, 8, method=svc.method, max_iters=svc.max_iters,
                                 rho=svc.rho, tol=svc.tol, device=dev)
    x8, s8 = ap.finalize_padded_solve(pre, st, m_max=cls.m_max, device=dev)
    done = st.done.cpu()
    status, want = s["status"], torch.where(done, s8["status"].cpu(),
                                            int(SolveStatus.DEADLINE_EXCEEDED))
    not_retried = (s["retries"] == 0).to(dev)
    ok = (s["deadline_hit"] and s["trips"] == 8 and s["segments"] == 1
          and torch.equal(status, want) and bool(torch.isfinite(x).all())
          and bool(torch.isfinite(s["dtilde"][~done]).all())
          and torch.equal(x[not_retried], x8[not_retried]))
    print(f"{tag} (b) deadline_s=0.0, segment_trips=8, top class: deadline_hit "
          f"{s['deadline_hit']}, trips {s['trips']}, segments {s['segments']}; "
          f"{int((~done).sum())} slots DEADLINE_EXCEEDED, {int(done.sum())} done in time; "
          f"x finite, bitwise finalize(prepare → segment(8)) on "
          f"{int(not_retried.sum())} unretried slots: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: the tight deadline did not pause honestly after one "
                         f"segment (statuses {status.tolist()}, expected {want.tolist()})")

    # (c) earliest deadline first; a spent deadline expires without a solve
    svc = SolverService(device=dev)
    order = []
    solve_chunk = svc._solve_chunk

    def recorded(cls, reqs, **kw):
        order.append((cls.n, [r.req_id for r in reqs]))
        return solve_chunk(cls, reqs, **kw)

    svc._solve_chunk = recorded
    backlog = [svc.submit(*_request(g, dev, TRAFFIC[1][1], TRAFFIC[1][2]), deadline_s=3600.0)
               for _ in range(32)]
    late = svc.submit(*_request(g, dev, TRAFFIC[2][1], TRAFFIC[2][2]), deadline_s=0.0)
    urgent = svc.submit(*_request(g, dev, TRAFFIC[0][1], TRAFFIC[0][2]), deadline_s=600.0)
    sols = svc.flush()
    e = sols[late]
    ok = (order[0][1] == [urgent] and len(order) == 3
          and all(sols[i].status in ("OK", "RETRIED") for i in backlog + [urgent])
          and e.status == "DEADLINE_EXCEEDED" and e.iters == 0 and bool((e.x == 0).all())
          and all(late not in ids for _, ids in order) and svc.stats["deadline_exceeded"] == 1)
    print(f"{tag} (c) dispatch order (class n, request ids): "
          f"{[(n, ids if len(ids) < 3 else f'{len(ids)} ids') for n, ids in order]}; the "
          f"urgent request {urgent} first; request {late}, deadline spent, "
          f"{e.status} with {e.iters} iterations and x = 0: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: the service's EDF dispatch or chunk expiry is wrong")

    # (d) the card's time per segment, and the monolithic loop's per trip
    cap = ap.padded_trip_cap(cls.m_max, svc.max_iters)
    seg_kw = dict(method=svc.method, max_iters=svc.max_iters, rho=svc.rho, tol=svc.tol,
                  device=dev)

    def card_ms(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), out

    for k in (8, 32):
        times = []
        for _ in range(3):
            pre, st = ap.prepare_padded_solve(q, seeds, m_max=cls.m_max, tol=svc.tol,
                                              device=dev)
            while not bool(st.done.all()) and int(st.trips) < cap:
                t0 = int(st.trips)
                ms, st = card_ms(lambda: ap.padded_solve_segment(
                    q, pre, st, min(cap, t0 + k), **seg_kw))
                if int(st.trips) - t0 == k:            # full segments only
                    times.append(ms)
        times.sort()
        med = times[len(times) // 2]
        print(f"{tag} (d) top class gaussian/fp32, {k} trips a segment: card time per "
              f"segment median {med:.4f} ms over {len(times)} full segments "
              f"(min {times[0]:.4f}, max {times[-1]:.4f}), {med / k:.4f} ms a trip ({smi})")
    mono = []
    for _ in range(3):
        pre, st = ap.prepare_padded_solve(q, seeds, m_max=cls.m_max, tol=svc.tol, device=dev)
        ms, st = card_ms(lambda: ap.padded_solve_segment(q, pre, st, cap, **seg_kw))
        mono.append(ms)
    trips = int(st.trips)
    run = min(cap, -(-trips // ap.CHECK_TRIPS) * ap.CHECK_TRIPS)
    med = sorted(mono)[1]
    print(f"{tag} (d) top class gaussian/fp32, the monolithic loop: card time median "
          f"{med:.4f} ms (min {min(mono):.4f}, max {max(mono):.4f}) for {trips} trips with a "
          f"problem active and {run} trips run (done is read every {ap.CHECK_TRIPS}), "
          f"{med / run:.4f} ms a trip run ({smi})")
    launches = dict(ops.LAUNCHES)
    missing = [leg for leg in ("gaussian_sa", "fwht", "sjlt.bf16") if launches[leg] <= 0]
    print(f"{tag} launches over phase 5: {launches}")
    if missing:
        raise SystemExit(f"chip_smoke: kernel legs {missing} were never launched under "
                         "deadlines")
    return launches


# phase 6: GLM runs (sketch, compute_dtype) at the top class, then one SRHT
# batch; path runs at the top class; the path grid
GLM_MODES = [("gaussian", "fp32"), ("gaussian", "bf16"), ("sjlt", "int8")]
PATH_MODES = [("gaussian", "fp32"), ("sjlt", "bf16")]
PATH_NUS = tuple(float(v) for v in (10.0 ** (-2.0 * k / 7.0) for k in range(8)))
# the GLM answers against the port's fp64 IRLS answer, relative
GLM_REL_TOL = 1e-3


def _glm_request(g, dev, n_rng, d_rng):
    """A logistic request of phase 4's sizes: ``synthetic_logistic_problem``
    on the card, ν uniform in [0.1, 0.5]."""
    import torch

    from repro_torch.core.objectives import synthetic_logistic_problem

    n = int(torch.randint(n_rng[0], n_rng[1] + 1, (), generator=g, device=dev))
    d = int(torch.randint(d_rng[0], d_rng[1] + 1, (), generator=g, device=dev))
    A, y = synthetic_logistic_problem(g, n, d)
    return A, y, 0.1 + 0.4 * float(torch.rand((), generator=g, device=dev))


class _CardTimer:
    """Wall time of a function's calls, the card synchronized on both sides,
    set around ``module.name`` for the length of a ``with``."""

    def __init__(self, module, name):
        self.module, self.name, self.times, self.outputs = module, name, [], []

    def __enter__(self):
        import torch

        fn = self.original = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.times.append((time.perf_counter() - t0) * 1e3)
            self.outputs.append(out)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


def _summary(ms):
    ms = sorted(ms)
    return (f"{len(ms)} × median {ms[len(ms) // 2]:.2f} ms "
            f"(min {ms[0]:.2f}, max {ms[-1]:.2f}), total {sum(ms):.2f} ms")


def phase_glm_path(smi, dev="cuda", seed=30):
    """GLM and λ-path traffic on the main path (phase 6); returns the kernel
    legs' launch counts over its runs, which are set to 0 just before them."""
    import torch

    from repro_torch.core import newton, robust
    from repro_torch.core.adaptive_padded import CHECK_TRIPS
    from repro_torch.kernels import ops
    from repro_torch.serve import solver_service as service

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    (_, top_n, top_d), (_, srht_n, srht_d) = TRAFFIC[-2], TRAFFIC[-1]
    ops.reset_launches()

    # (a) logistic GLM batches of 16 by sketched Newton
    glm_runs = [(sk, cd, [_glm_request(g, dev, top_n, top_d) for _ in range(16)])
                for sk, cd in GLM_MODES]
    glm_runs.append(("gaussian", "fp32",
                     [_glm_request(g, dev, srht_n, srht_d) for _ in range(16)]))
    for sketch, cd, reqs in glm_runs:
        svc = service.SolverService(sketch=sketch, compute_dtype=cd, device=dev)
        ids = [svc.submit_glm(A, y, nu) for A, y, nu in reqs]
        before = dict(ops.LAUNCHES)
        with _CardTimer(svc, "_solve_glm_chunk") as chunk, \
                _CardTimer(newton, "padded_adaptive_solve_batched") as inner:
            sols = svc.flush()
        legs = {k: ops.LAUNCHES[k] - before[k] for k in before if ops.LAUNCHES[k] > before[k]}
        worst, bad = 0.0, []
        for rid, (A, y, nu) in zip(ids, reqs):
            s = sols[rid]
            x64 = newton.irls_reference("logistic", A.double(), y.double()[None], nu,
                                        device=dev)[0]
            err = float(torch.linalg.norm(s.x.double() - x64) / torch.linalg.norm(x64))
            worst = max(worst, err)
            if not (s.converged and s.status == "OK" and s.decrement <= svc.newton_tol
                    and err <= GLM_REL_TOL):
                bad.append((rid, s.status, s.decrement, err))
        cls = sols[ids[0]].shape_class
        steps = max(sols[i].newton_iters for i in ids)
        print(f"[glm] {sketch if cls.sketch is None else cls.sketch}/{cd}, class n={cls.n} "
              f"d={cls.d} m_max={cls.m_max}: {len(ids)} logistic requests, "
              f"{sum(sols[i].converged for i in ids)} converged, Newton steps "
              f"{min(sols[i].newton_iters for i in ids)}-{steps}, max decrement "
              f"{max(sols[i].decrement for i in ids):.3e} (tolerance {svc.newton_tol:g}), "
              f"m trajectory of request {ids[0]} {sols[ids[0]].m_trajectory}; max rel err "
              f"vs fp64 IRLS {worst:.3e} (tolerance {GLM_REL_TOL:g}); launches {legs}")
        print(f"[glm]   wall per batch {_summary(chunk.times)}; {len(inner.times)} inner "
              f"weighted solves, {_summary(inner.times)} ({smi})")
        if bad:
            raise SystemExit(f"chip_smoke: GLM answers not converged or off fp64 IRLS "
                             f"(id, status, decrement, rel err): {bad[:10]}")

    # (b) λ paths, 8 points each, one sketch pass per chunk
    top = [_request(g, dev, top_n, top_d) for _ in range(16)]
    for sketch, cd in PATH_MODES:
        svc = service.SolverService(sketch=sketch, compute_dtype=cd, device=dev)
        ids = [svc.submit_path(A, y, PATH_NUS) for A, y, _ in top]
        before = dict(ops.LAUNCHES)
        with _CardTimer(svc, "_solve_path_chunk") as chunk, \
                _CardTimer(robust, "prepare_path_ladder") as prep, \
                _CardTimer(robust, "robust_padded_solve_batched") as point:
            sols = svc.flush()
        legs = {k: ops.LAUNCHES[k] - before[k] for k in before if ops.LAUNCHES[k] > before[k]}
        worst, bad = 0.0, []
        for rid, (A, y, _) in zip(ids, top):
            s = sols[rid]
            for pt in s.points:
                err, tol = _ridge_gate(pt.x, A, y, pt.nu, pt.iters)
                worst = max(worst, err / tol)
                if pt.status not in ("OK", "RETRIED") or not err <= tol:
                    bad.append((rid, pt.nu, pt.status, err, tol))
            if s.sketch_passes != 1:
                bad.append((rid, "sketch_passes", s.sketch_passes))
        m = [tuple(p.m_final for p in sols[i].points) for i in ids[:2]]
        print(f"[path] {sketch}/{cd}, top class: {len(ids)} requests × {len(PATH_NUS)} "
              f"points (ν = geomspace(1, 1e-2, 8)), sketch passes per chunk "
              f"{sorted({sols[i].sketch_passes for i in ids})}; worst H-norm rel err vs fp64 "
              f"as a share of max({SOLVE_REL_TOL:g}, 2^-24·κ(H)·√k): {worst:.3f}; warm m "
              f"trajectories {m}; launches {legs}")
        print(f"[path]   wall per chunk {_summary(chunk.times)}: prepare (one sketch pass "
              f"and true Gram) {_summary(prep.times)}; per-point robust solves "
              f"{_summary(point.times)} ({smi})")
        # the no-op tail: a monolithic solve reads done every CHECK_TRIPS trips
        active = [int(out[1]["trips"]) for out in point.outputs]
        run = [-(-t // CHECK_TRIPS) * CHECK_TRIPS for t in active]
        tail_ms = [ms * (r - t) / r for ms, r, t in zip(point.times, run, active)]
        print(f"[path]   trips per point with a problem active {active}, run {run} (done "
              f"read every {CHECK_TRIPS}); the no-op tail, at each point's ms per trip run: "
              f"{_summary(tail_ms)}, {sum(tail_ms) / sum(point.times):.3f} of the "
              f"per-point time")
        if bad:
            raise SystemExit(f"chip_smoke: path points off the ridge gate or more than one "
                             f"sketch pass: {bad[:10]}")

    # (c) the ladder cache: the same path traffic again and again, in turns
    # cold, repeat, repeat on one service, then cold on a new one
    services = [service.SolverService(ladder_cache=True, device=dev) for _ in range(2)]
    rounds = []
    for svc in (services[0], services[0], services[0], services[1]):
        ids = [svc.submit_path(A, y, PATH_NUS) for A, y, _ in top]
        before = dict(ops.LAUNCHES)
        with _CardTimer(svc, "_ladder_fingerprint") as fp, \
                _CardTimer(svc, "_solve_path_chunk") as chunk:
            sols = svc.flush()
        rounds.append(([sols[i] for i in ids], fp.times, chunk.times[0],
                       sum(ops.LAUNCHES[k] - before[k] for k in before)))
    cold = rounds[0][0]

    def same(sols):
        return sum(all(torch.equal(a.x, b.x) and a.delta_tilde == b.delta_tilde
                       and (a.m_final, a.iters, a.status) == (b.m_final, b.iters, b.status)
                       for a, b in zip(c.points, w.points)) for c, w in zip(cold, sols))

    ok = True
    for k, (sols, _, ms, launched) in enumerate(rounds):
        hit = k in (1, 2)
        good = (same(sols) == len(cold) and (launched == 0 if hit else launched > 0)
                and all(s.cache_hit == hit and s.sketch_passes == (0 if hit else 1)
                        for s in sols))
        ok = ok and good
        print(f"[cache] gaussian/fp32, top class, {len(sols)} path requests, round {k + 1} "
              f"({'repeat' if hit else 'cold'}, service {'AAAB'[k]}): chunk {ms:.2f} ms, "
              f"cache_hit {sum(s.cache_hit for s in sols)}/{len(sols)}, sketch_passes "
              f"{sorted({s.sketch_passes for s in sols})}, {launched} kernel launches, "
              f"{same(sols)}/{len(cold)} answers bitwise round 1's (x, δ̃, m_final, iters, "
              f"status at every point): {'ok' if good else 'FAIL'}")
    stats = services[0].stats
    fps = [t for r in rounds for t in r[1]]
    print(f"[cache]   service A: {stats['ladder_cache_hits']} hits, "
          f"{stats['ladder_cache_misses']} misses, {stats['sketch_passes_saved']} passes "
          f"saved; fingerprint (SHA-1 of A's and Λ's bytes after one copy to the host) per "
          f"request: {_summary(fps)} ({smi})")
    if not ok:
        raise SystemExit("chip_smoke: a ladder-cache round is not a bitwise copy of the "
                         "cold round, or a repeat paid a sketch pass")

    # (d) every kernel leg this phase runs, the weighted legs included
    launches = dict(ops.LAUNCHES)
    print(f"[glm/path] launches over phase 6: {launches}")
    want = [*ops.WEIGHTED_LEGS, "sjlt.int8", "fwht", "gaussian_sa", "sjlt.bf16"]
    missing = [k for k in want if launches[k] <= 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernel legs {missing} were never launched by the "
                         "GLM and path runs")
    return launches


# phase 7: the (sketch, compute_dtype, class) of the preempt-and-resume runs
# and of the chaos batches; the chaos batches' faulty slots; the signal
# cycle's traffic and the seconds after its flush began that SIGTERM lands
FT_RESUME = [("gaussian", "fp32", "top"), ("srht", "fp32", "srht"), ("sjlt", "int8", "top")]
FT_CHAOS = [("gaussian", "fp32", "top"), ("gaussian", "bf16", "top"), ("sjlt", "int8", "top"),
            ("srht", "fp32", "srht")]
NAN_SLOT, INF_SLOT, ADVERSARIAL_SLOT = 3, 7, 11
NEIGHBOR_TOL = 1e-6
CYCLE_REQUESTS, CYCLE_AFTER_S = 160, 0.5


class _StopAfterPolls:
    """A preemption flag whose ``should_stop`` turns on after its ``n``-th
    poll: the driver polls once before each segment."""

    def __init__(self, n):
        self.n, self.polls = n, 0

    @property
    def should_stop(self):
        self.polls += 1
        return self.polls > self.n


def _nan_isolation(smi):
    """Phase 7 (d): every kernel leg at phase 3's shapes confines a NaN to
    its own problem; not counted as main-path launches."""
    import torch

    from repro_torch.dist.compress import quantize_rows
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    bad = 5
    B, n, d, m = 16, 4096, 256, 512
    A = torch.randn((B, n, d), generator=g, device=dev) / n ** 0.5
    seeds = torch.randint(0, 2 ** 32, (B,), generator=g, device=dev, dtype=torch.int64)
    w = torch.rand((B, n), generator=g, device=dev) + 0.5
    tgt = torch.randint(0, m, (B, n), generator=g, device=dev, dtype=torch.int32)
    sg = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    nf = 16384
    X = torch.randn((B, nf, d), generator=g, device=dev)
    s = torch.where(torch.rand((B, nf), generator=g, device=dev) < 0.5, -1.0, 1.0)

    def nan_row(t):
        t = t.clone()
        t[bad, 17] = float("nan")
        return t

    legs = []
    for cd in ("fp32", "bf16", "int8"):
        name = ops.leg("gaussian_sa", cd)
        legs.append((f"{name} (NaN row of A)",
                     lambda A_, cd=cd: ops.gaussian_sa(A_, seeds, m, compute_dtype=cd), A))
        if cd != "int8":
            legs.append((f"{ops.leg('gaussian_sa', cd, weighted=True)} (NaN row weight)",
                         lambda w_, cd=cd: ops.gaussian_sa(A, seeds, m, row_weights=w_,
                                                           compute_dtype=cd), w))
        legs.append((f"{ops.leg('sjlt', cd)} (NaN row of A)",
                     lambda A_, cd=cd: ops.sjlt_apply_batched(A_, tgt, sg, m, compute_dtype=cd),
                     A))
        legs.append((f"{ops.leg('fwht', cd)} (NaN row scale)",
                     lambda s_, cd=cd: ops.fwht_cols(X, row_scale=s_, compute_dtype=cd), s))
    # the int8 FWHT leg as the SRHT pass runs it: A's codes, their scales in
    # the row scale (a NaN row of A quantizes to a NaN scale)
    codes, a_scales = quantize_rows(X)
    legs.append(("fwht.int8 codes (NaN row scale)",
                 lambda s_: ops.fwht_cols(codes, row_scale=s_, compute_dtype="int8"),
                 s * a_scales))
    legs.append(("fwht unscaled (NaN row of X)", lambda X_: ops.fwht_cols(X_), X))
    for label, fn, clean_in in legs:
        clean, out = fn(clean_in), fn(nan_row(clean_in))
        torch.cuda.synchronize()
        keep = [i for i in range(B) if i != bad]
        ok = (bool(torch.isfinite(clean).all()) and not bool(torch.isfinite(out[bad]).all())
              and torch.equal(out[keep], clean[keep]))
        print(f"[ft] (d) {label}: problem {bad} non-finite, the other {len(keep)} bitwise the "
              f"clean launch's: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: {label} does not confine a NaN to its problem")
    del A, X, codes


def phase_ft(smi, dev="cuda", seed=40):
    """Preemption, the signal cycle, chaos and NaN isolation at full width
    (phase 7); returns the kernel legs' launch counts over (a) and (c), each
    set to 0 just before it and read just after."""
    import tempfile

    import torch

    from repro_torch.core import robust
    from repro_torch.core.adaptive_padded import doubling_ladder
    from repro_torch.core.distributed import ShardLadderCache
    from repro_torch.core.quadratic import Quadratic
    from repro_torch.core.status import SolveStatus
    from repro_torch.ft import checkpoint as ckpt_module
    from repro_torch.ft import faults
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.serve.solver_service import RidgeRequest, SolverService

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    (_, top_n, top_d), (_, srht_n, srht_d) = TRAFFIC[-2], TRAFFIC[-1]
    traffic = {"top": [_request(g, dev, top_n, top_d) for _ in range(16)],
               "srht": [_request(g, dev, srht_n, srht_d) for _ in range(16)]}

    # (a) preempt after two segments, resume on a new service
    ops.reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ck_") as tmp:
        for sketch, cd, which in FT_RESUME:
            reqs, label = traffic[which], f"{sketch}/{cd}, {which} class"

            def serve(ckdir, preempt=None):
                # the SRHT class carries its own family; the service's is the default
                svc = SolverService(sketch="gaussian" if sketch == "srht" else sketch,
                                    compute_dtype=cd, segment_trips=8, device=dev,
                                    checkpoint_dir=Path(tmp) / ckdir, preempt=preempt)
                ids = [svc.submit(A, y, nu) for A, y, nu in reqs]
                torch.cuda.synchronize()
                return svc, ids

            svc, ids = serve(f"{sketch}-{cd}-ref")
            t0 = time.perf_counter()
            with _CardTimer(CheckpointManager, "save") as saves, \
                    _CardTimer(ckpt_module, "_to_host") as copies, \
                    _CardTimer(CheckpointManager, "_write") as writes:
                ref = svc.flush()
            t_ref = time.perf_counter() - t0
            svc, _ = serve(f"{sketch}-{cd}", preempt=_StopAfterPolls(2))
            try:
                svc.flush()
                raise SystemExit(f"chip_smoke: the preempted flush ({label}) ended normally")
            except robust.PreemptedError as e:
                err = e
            step = CheckpointManager(err.checkpoint_dir).latest_step()
            nbytes = (sum(p.stat().st_size for p in (Path(err.checkpoint_dir)
                                                     / f"step_{step:09d}").rglob("*"))
                      if step is not None else 0)
            svc, ids2 = serve(f"{sketch}-{cd}")
            t0 = time.perf_counter()
            with _CardTimer(CheckpointManager, "restore") as restores, \
                    _CardTimer(robust, "prepare_padded_solve") as prep:
                got = svc.flush()
            t_res = time.perf_counter() - t0
            same = sum(_same_answer(got[i], ref[i]) for i in ids)
            ok = (step == err.segment == 2 and ids2 == ids and svc.stats["resumed_chunks"] >= 1
                  and same == len(ids))
            print(f"[ft] (a) {label}: PreemptedError at segment {err.segment}, committed step "
                  f"{step}, {nbytes} bytes a checkpoint; a new service resumed "
                  f"{svc.stats['resumed_chunks']} chunk(s), {same}/{len(ids)} answers bitwise "
                  f"the uninterrupted segmented run's: {'ok' if ok else 'FAIL'}")
            print(f"[ft]   save {_summary(saves.times)}: copies to the host "
                  f"{sum(copies.times) / len(saves.times):.2f} ms a save ({len(copies.times)} "
                  f"leaves in all), files written {_summary(writes.times)}")
            print(f"[ft]   restore {_summary(restores.times)}; "
                  f"prepare recomputed on resume {_summary(prep.times)}; flush uninterrupted "
                  f"{t_ref * 1e3:.2f} ms ({len(saves.times)} saves), resumed "
                  f"{t_res * 1e3:.2f} ms ({smi})")
            if not ok:
                raise SystemExit(f"chip_smoke: preempt and resume ({label}) is not bitwise the "
                                 f"uninterrupted run, or did not resume")
    launches = dict(ops.LAUNCHES)
    print(f"[ft] launches over (a): {launches}")
    missing = [k for k in ("gaussian_sa", "fwht", "sjlt.int8") if launches[k] <= 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernel legs {missing} were never launched by (a)")

    # (b) the real signal cycle, through the launcher, in a subprocess
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--preempt-after",
           str(CYCLE_AFTER_S), "--requests", str(CYCLE_REQUESTS), "--device", dev.type]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=700, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith(("PREEMPTED", "statuses", "audited", "ALL_FINITE", "AUDIT_OK",
                               "preemption cycle"))]
    for ln in lines:
        print(f"[ft] (b) {ln}")
    ok = r.returncode == 0 and "preemption cycle OK" in r.stdout
    print(f"[ft] (b) {' '.join(cmd[1:])}: exit {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: the SIGTERM → 75 → --resume cycle failed:\n"
                         f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")

    # (c) chaos: a NaN row, an Inf target and an adversarial seed in one batch
    ops.reset_launches()
    for sketch, cd, which in FT_CHAOS:
        reqs, label = traffic[which], f"{sketch}/{cd}, {which} class"
        svc = SolverService(sketch="gaussian" if sketch == "srht" else sketch,
                            compute_dtype=cd, device=dev)
        cls = svc.bucket_for(*reqs[0][0].shape)
        q, seeds = svc._pack(cls, [RidgeRequest(i, A, y, nu) for i, (A, y, nu) in
                                   enumerate(reqs)])
        Y = torch.zeros((16, cls.n), device=dev)
        for i, (A, y, _) in enumerate(reqs):
            Y[i, :A.shape[0]] = y
        b_bad = q.b.clone()
        b_bad[INF_SLOT] = q.A[INF_SLOT].T @ faults.inject_inf_entry(Y, INF_SLOT)[INF_SLOT]
        q_bad = Quadratic(A=faults.inject_nan_row(q.A, NAN_SLOT), b=b_bad, nu=q.nu,
                          lam_diag=q.lam_diag, batched=True)
        adv = faults.AdversarialKeyProvider(sketch, seeds[ADVERSARIAL_SLOT])
        kw = dict(m_max=cls.m_max, method=svc.method, max_iters=svc.max_iters, tol=svc.tol,
                  compute_dtype=cd, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_c, s_c = robust.robust_padded_solve_batched(q, seeds, sketch=sketch, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x, s = robust.robust_padded_solve_batched(q_bad, seeds, sketch=adv, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        status = s["status"].tolist()
        faulty = [NAN_SLOT, INF_SLOT, ADVERSARIAL_SLOT]
        keep = [i for i in range(16) if i not in faulty]
        gap = float((x[keep] - x_c[keep]).abs().max())
        bitwise = torch.equal(x[keep], x_c[keep])
        ok = (all(status[i] != int(SolveStatus.OK) for i in faulty[:2])
              and status[ADVERSARIAL_SLOT] == int(SolveStatus.RETRIED)
              and all(status[i] == int(s_c["status"][i]) == int(SolveStatus.OK) for i in keep)
              and gap <= NEIGHBOR_TOL and int(s["retries"].max()) <= svc.max_retries
              and bool(torch.isfinite(x).all()))
        names = {i: SolveStatus(status[i]).name for i in faulty}
        print(f"[ft] (c) {label}: faulty slots {names}, retries "
              f"{[int(s['retries'][i]) for i in faulty]} (at most {svc.max_retries}); "
              f"{len(keep)} clean neighbours OK, max |x - clean| {gap:.3e} "
              f"({'bitwise' if bitwise else 'not bitwise'}, tolerance {NEIGHBOR_TOL:g}); every "
              f"x finite: {'ok' if ok else 'FAIL'}; wall clean {(t1 - t0) * 1e3:.2f} ms, "
              f"faulty {(t2 - t1) * 1e3:.2f} ms ({smi})")
        if not ok:
            raise SystemExit(f"chip_smoke: chaos batch {label} breaks an invariant "
                             f"(statuses {status})")
        if (sketch, cd) != ("gaussian", "fp32"):
            continue
        # shard loss before the solve (a dropout provider) and in the middle
        # of it (a ShardLossInjector on the emulated shard cache)
        ladder = doubling_ladder(cls.m_max)
        cache = ShardLadderCache.from_emulation("gaussian", seeds, q, ladder, 4)
        inj = faults.ShardLossInjector(cache, shard=1, at_segment=2)
        runs = [("dropout_provider(gaussian, 4, (1,))", robust.robust_padded_solve_batched(
                    q, seeds, sketch=faults.dropout_provider("gaussian", 4, (1,)), **kw)),
                ("ShardLossInjector at segment 2", robust.segmented_padded_solve_batched(
                    q, seeds, grams=cache.total(), on_segment=inj, segment_trips=8,
                    gram_hvp=True, **kw))]
        for name, (x_s, s_s) in runs:
            worst, bad_slots = 0.0, []
            for i, (A, y, nu) in enumerate(reqs):
                err, tol = _ridge_gate(x_s[i, :A.shape[1]], A, y, nu, s_s["iters"][i])
                worst = max(worst, err / tol)
                if int(s_s["status"][i]) not in (int(SolveStatus.OK), int(SolveStatus.RETRIED)) \
                        or err > tol:
                    bad_slots.append((i, int(s_s["status"][i]), err, tol))
            print(f"[ft] (c) {label}, {name}: statuses {sorted(set(s_s['status'].tolist()))}, "
                  f"worst H-norm rel err vs fp64 as a share of the ridge gate {worst:.3f}"
                  + (f", fired at segment {inj.fired_at}, shards alive {sorted(cache.alive)}"
                     if "Injector" in name else ""))
            if bad_slots or ("Injector" in name and inj.fired_at != 2):
                raise SystemExit(f"chip_smoke: {name} did not recover: {bad_slots[:5]}")
    run = dict(ops.LAUNCHES)
    print(f"[ft] launches over (c): {run}")
    missing = [k for k in ("gaussian_sa", "gaussian_sa.bf16", "sjlt.int8", "fwht")
               if run[k] <= 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernel legs {missing} were never launched by (c)")
    launches = {k: launches[k] + run[k] for k in launches}

    # (d) the kernels' NaN isolation, leg by leg
    _nan_isolation(smi)
    torch.cuda.empty_cache()
    return launches


# phase 8 (a): fig1's scaled problem (benchmarks/fig1_synthetic.py: n = 8192,
# d = 1024, σ_j = decay^j with decay = 0.995^(7000/d), y ~ N(0, I)), its ν
# grid, methods and tolerance; the three families of the paper
PAPER_N, PAPER_D, PAPER_NUS = 8192, 1024, (1e-1, 1e-2, 1e-3)
PAPER_METHODS, PAPER_SKETCHES = ("ihs", "pcg"), ("sjlt", "srht", "gaussian")
PAPER_TOL, PAPER_MAX_ITERS = 1e-8, 200
# phase 8 (b): K gloo ranks on the one card, the top class at B = 16, and
# the pod-scale class's traffic (n in (16384, 65536], d ≤ 256)
SHARD_K = 4
SHARD_PASSES = (("gaussian", "fp32"), ("sjlt", "int8"), ("srht", "bf16"))
# the summed all-reduce adds the K shard stacks in gloo's order, not in shard
# order: fp32 sums of K terms reordered, a few ulp of the Grams' scale
SHARD_REL_TOL = 1e-6
POD_TRAFFIC = dict(seed=80, count=16, n_range=(40000, 65536), d_range=(128, 256))
# the sharded segmented solves: 8-trip segments; a zero deadline binds after
# the first segment (which always runs), on the lead rank's clock, as phase
# 5 (b)'s does on one device (a deadline measured from an earlier solve's
# wall did not always bind: ranks sharing the card run at varying speed);
# rank 3's preemption flag turns on at its third poll (before segment 3), so
# every rank raises at segment 2; the pod-scale requests' deadlines are
# generous and all different (EDF)
SEG_TRIPS, SEG_PREEMPT = 8, (3, 3)
POD_DEADLINES = tuple(3600.0 - 60.0 * i for i in range(16))


def _paper_problem(dev, nu, seed=0):
    """fig1's scaled problem in the port: A = U·diag(σ)·Vᵀ from QRs of
    Gaussian blocks drawn by a seeded generator on the card."""
    import torch

    from repro_torch.core import exp_decay_singular_values
    from repro_torch.core.quadratic import from_least_squares

    g = torch.Generator(device=dev).manual_seed(seed)
    sv = exp_decay_singular_values(PAPER_D, 0.995 ** (7000.0 / PAPER_D), device=dev)
    U, _ = torch.linalg.qr(torch.randn((PAPER_N, PAPER_D), generator=g, device=dev))
    V, _ = torch.linalg.qr(torch.randn((PAPER_D, PAPER_D), generator=g, device=dev))
    A = ((U * sv[None, :]) @ V.T).contiguous()
    y = torch.randn((PAPER_N,), generator=g, device=dev)
    return from_least_squares(A, y, nu), sv, y


def phase_paper(smi):
    """Phase 8 (a): the paper's adaptive IHS and PCG (``core.adaptive``) at
    fig1's size on the card in every family, each answer against an fp64
    direct solve; then each single-problem kernel leg the path launched,
    held against its plain version through the path's wrapper at the
    path's shapes, and the unscaled FWHT at ``apply_t``'s. Returns (the
    launch counts per Pallas body over the solves, the kernels-line rows)."""
    import math

    import torch

    from repro_torch.core import AdaptiveConfig, adaptive_solve, effective_dimension, make_sketch
    from repro_torch.core.level_grams import fold_seeds
    from repro_torch.core.quadratic import direct_solve
    from repro_torch.core.sketches import _block_seeds
    from repro_torch.kernels import ops
    from repro_torch.kernels import sjlt as ksj
    from repro_torch.kernels.fwht import fwht_ref, hadamard_dense
    from repro_torch.kernels.gaussian_gram import gaussian_s_dense, gaussian_sa_ref

    dev = torch.device("cuda")
    per_leg, last = dict.fromkeys(ops.BODIES, 0), {}
    worst = 0.0
    for nu in PAPER_NUS:
        q, sv, y = _paper_problem(dev, nu)
        d_e = float(effective_dimension(sv, nu))
        H64 = q.A.double().T @ q.A.double() + nu ** 2 * torch.eye(PAPER_D, dtype=torch.float64,
                                                                   device=dev)
        x64 = torch.linalg.solve(H64, q.A.double().T @ y.double())
        ev = torch.linalg.eigvalsh(H64)
        kappa = float(ev[-1] / ev[0])
        # the fp32 Cholesky direct solve (AᵀA, ~17 GFLOP, and a 1024² factor)
        t_direct = time_ms(lambda: direct_solve(q), reps=5)
        for kind in PAPER_SKETCHES:
            for method in PAPER_METHODS:
                sketches = []

                def sampler(phase, m, kind=kind, sketches=sketches):
                    sketches.append(make_sketch(kind, m, q.n, fold_seeds(
                        torch.tensor(1, device=dev), phase), device=dev))
                    return sketches[-1]
                torch.cuda.synchronize()
                ops.reset_launches()
                t0 = time.perf_counter()
                res = adaptive_solve(q, AdaptiveConfig(method=method, sketch=kind,
                                                       max_iters=PAPER_MAX_ITERS, tol=PAPER_TOL),
                                     sampler=sampler, device=dev)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                legs = {k: v for k, v in ops.BODY_LAUNCHES.items() if v}
                e = res.x.double() - x64
                err = float(torch.sqrt((e @ H64 @ e) / (x64 @ H64 @ x64)))
                gate = max(SOLVE_REL_TOL, FP32_UNIT * kappa * max(res.iters, 1) ** 0.5)
                worst = max(worst, err / gate)
                print(f"[paper] ν={nu:g} {kind}/{method}: m_final {res.m_final} "
                      f"(d_e {d_e:.1f}, m_final/d_e {res.m_final / d_e:.2f}), "
                      f"{res.iters} iterations, {res.n_doublings} doublings, "
                      f"{wall:.2f} ms wall ({sum(res.resketch_times) * 1e3:.2f} ms in "
                      f"{len(res.resketch_times)} sketch+factorize, median iteration "
                      f"{sorted(res.iter_times)[len(res.iter_times) // 2] * 1e3:.3f} ms), "
                      f"fp32 Cholesky direct {t_direct:.3f} ms; error {err:.3e} in the "
                      f"H-norm (gate {gate:.3e}, κ(H) {kappa:.3e}); launches {legs}")
                if not (math.isfinite(err) and err <= gate):
                    raise SystemExit(f"chip_smoke: paper-literal {kind}/{method} at ν={nu:g} "
                                     f"misses the ridge gate: {err:.3e} > {gate:.3e}")
                for k, v in legs.items():
                    per_leg[k] = per_leg.get(k, 0) + v
                # the final sketch's adjoint check, ⟨A, Sᵀ(SA)⟩ = ‖SA‖², through
                # apply_t (the SRHT's unscaled FWHT); its launches are not the
                # path's and were read above
                sk = sketches[-1] if sketches else None      # every sketch has m < n
                if sk is not None:
                    SA = sk.apply(q.A)
                    lhs = float(torch.sum(q.A.double() * sk.apply_t(SA).double()))
                    rhs = float(torch.sum(SA.double() ** 2))
                    if abs(lhs - rhs) > 1e-4 * abs(rhs):
                        raise SystemExit(f"chip_smoke: {kind} apply_t is not the adjoint of "
                                         f"apply: {lhs} against {rhs}")
                    last[kind] = sk
        del H64, x64
    launches = per_leg
    print(f"[paper] launches per Pallas body over the phase 8 (a) solves: {launches}; "
          f"worst answer {worst:.3f} of its gate")
    missing = [k for k in ("_gauss_sa_kernel", "_fwht_kernel_scaled", "_sjlt_kernel")
               if launches[k] <= 0]
    if missing:
        raise SystemExit(f"chip_smoke: the paper-literal path never launched {missing}")

    # the single-problem legs at the path's shapes, through the wrappers the
    # path calls, on its final sketches' data: A (8192, 1024) and the largest
    # final sketch below n of each family (the Gaussian's first row block)
    q, _, _ = _paper_problem(dev, PAPER_NUS[-1])
    A, n, d = q.A, PAPER_N, PAPER_D
    src = "src/repro_torch/kernels/csrc/"
    rows = []
    seed, _, m = _block_seeds(last["gaussian"].data["seed"], last["gaussian"].m)[0]
    seeds = seed.reshape(1)
    S = gaussian_s_dense(seeds, m, n)[0]        # the yardstick's S, built outside the timing
    recs = [_measure(f"gaussian_sa single problem, shared A (m={m})",
                     lambda: ops.gaussian_sa(A, seeds, m),
                     lambda: gaussian_sa_ref(A, seeds, m),
                     gauss_sa_terms(1, n, d, m, shared=True), GAUSSIAN_REL_TOL,
                     library=lambda: torch.mm(S, A))]
    del S
    rows.append(_row("gaussian_sa (B = 1, shared A)", src + "gaussian_sa.cu",
                     "src/repro/kernels/gaussian_gram.py:210", recs,
                     launches=launches["_gauss_sa_kernel"]))
    sr = last["srht"]
    Z = torch.zeros((n, d), device=dev)
    Z[sr.data["rows"]] = sr.apply(A)
    H = hadamard_dense(n, dev)
    recs = [_measure(f"fwht unscaled (srht apply_t, n={n}, d={d})",
                     lambda: ops.fwht(Z), lambda: fwht_ref(Z), fwht_terms(1, n, d),
                     FWHT_REL_TOL, library=lambda: H @ Z)]
    del H
    rows.append(_row("fwht (unscaled; srht apply_t, off the adaptive path)", src + "fwht.cu",
                     "src/repro/kernels/fwht.py:30", recs, launches=launches["_fwht_kernel"]))
    sj = last["sjlt"]
    M = sj.m
    tgt, sg = sj.data["rows"][0], sj.data["signs"][0]      # int64 rows, as the path's

    def index_add():
        return torch.zeros((M, d), device=dev).index_add_(0, tgt, A * sg[:, None])
    recs = [_measure(f"sjlt single problem (m={M})", lambda: ops.sjlt_apply(A, tgt, sg, M),
                     lambda: ksj.sjlt_ref(A, tgt, sg, M),
                     sjlt_terms(1, n, d, M, shared=True, index_itemsize=8), SJLT_REL_TOL,
                     library=index_add)]
    rows.append(_row("sjlt (B = 1)", src + "sjlt.cu", "src/repro/kernels/sjlt.py:72", recs,
                     launches=launches["_sjlt_kernel"]))
    del q, A, Z
    torch.cuda.empty_cache()
    return launches, rows


def phase_sharded(smi):
    """Phase 8 (b): K gloo ranks on the one card. The sharded one-touch pass
    at the top class in three (family, mode)s against the one-process block
    emulation (summed: within SHARD_REL_TOL; per shard and ``from_mesh``:
    bitwise), the all-reduce's payload and time, and the pod-scale class
    through the sharded service under the ridge gate."""
    import torch

    from repro_torch.core.adaptive_padded import doubling_ladder
    from repro_torch.core.distributed import ShardLadderCache
    from repro_torch.core.level_grams import BlockEmulationProvider
    from repro_torch.core.quadratic import Quadratic
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.sharded import ridge_requests

    dev = torch.device("cuda")
    B, n, d, m_max = 16, 4096, 256, 512
    ladder = doubling_ladder(m_max)
    g = torch.Generator(device=dev).manual_seed(70)
    A = torch.stack([r[0] for r in ridge_requests(71, B, (n, n), (d, d), dev)])
    q = Quadratic(A=A, b=torch.randn((B, d), generator=g, device=dev),
                  nu=torch.full((B,), 1e-2, device=dev), lam_diag=torch.ones((B, d), device=dev),
                  batched=True)
    seeds = torch.randint(0, 2 ** 32, (B,), generator=g, device=dev, dtype=torch.int64)
    q_cpu = Quadratic(A=A.cpu(), b=q.b.cpu(), nu=q.nu.cpu(), lam_diag=q.lam_diag.cpu(),
                      batched=True)
    tasks = [(f"{f}/{c}", "pass", dict(q=q_cpu, seeds=seeds.cpu(), ladder=ladder, sketch=f,
                                       compute_dtype=c, time_reps=5 if f == "gaussian" else 0))
             for f, c in SHARD_PASSES]
    tasks.append(("pod", "service", dict(requests=POD_TRAFFIC, service=dict(batch_size=16))))
    ck = tempfile.mkdtemp(prefix="chip_smoke_ck_")
    seg = dict(q=q_cpu, seeds=seeds.cpu())
    kw = dict(m_max=m_max, sketch="gaussian", segment_trips=SEG_TRIPS)
    tasks += [
        ("seg", "segmented", dict(seg, kw=kw)),
        ("seg-generous", "segmented", dict(seg, kw=dict(kw, deadline_s=3600.0))),
        ("seg-bind", "segmented", dict(seg, kw=dict(kw, deadline_s=0.0))),
        # only the lead rank's clock counts: spent on the others never binds,
        # spent on the lead alone binds every rank
        ("seg-others-late", "segmented",
         dict(seg, kw=kw, deadlines=[3600.0] + [0.0] * (SHARD_K - 1))),
        ("seg-lead-late", "segmented",
         dict(seg, kw=kw, deadlines=[0.0] + [3600.0] * (SHARD_K - 1))),
        ("seg-preempt", "segmented", dict(seg, kw=kw, checkpoint=f"{ck}/seg",
                                          preempt=SEG_PREEMPT)),
        ("seg-resume", "segmented", dict(seg, kw=kw, checkpoint=f"{ck}/seg")),
        ("pod-ft", "service", dict(requests=POD_TRAFFIC, deadlines=POD_DEADLINES,
                                   service=dict(batch_size=16, checkpoint_dir=f"{ck}/pod"))),
    ]
    t0 = time.perf_counter()
    try:
        res = run_ranks("repro_torch.launch.sharded:run_tasks", SHARD_K,
                        {"tasks": tasks}, backend="gloo", device="cuda",
                        timeout=900)
        writers = sorted({c.relative_to(ck).parts[0] for c in Path(ck).glob("**/COMMITTED")})
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    print(f"[sharded] {SHARD_K} gloo ranks on one card ran their tasks in "
          f"{time.perf_counter() - t0:.1f} s (each process's start included)")
    for f, c in SHARD_PASSES:
        prov = BlockEmulationProvider(f, SHARD_K)
        want = prov.level_grams(prov.sample(seeds, m_max, n), q, ladder, compute_dtype=c).cpu()
        emu = ShardLadderCache.from_emulation(f, seeds, q, ladder, SHARD_K, compute_dtype=c)
        got = res[0][f"{f}/{c}"]
        rel = float((got["grams"] - want).abs().max() / want.abs().max())
        same = all(torch.equal(r[f"{f}/{c}"]["grams"], got["grams"]) for r in res)
        per = torch.equal(got["per_shard"], emu.shard_grams.cpu())
        tot = torch.equal(got["cache_total"], emu.total().cpu())
        print(f"[sharded] shard_level_grams {f}/{c}: rel err {rel:.3e} against the "
              f"one-process BlockEmulationProvider (tolerance {SHARD_REL_TOL:g}), replicated "
              f"bitwise on every rank {same}; per-shard form bitwise {per}; from_mesh total "
              f"bitwise from_emulation {tot}")
        if not (rel <= SHARD_REL_TOL and same and per and tot):
            raise SystemExit(f"chip_smoke: the sharded pass {f}/{c} disagrees with the "
                             f"block emulation")
        if "allreduce_ms" in got:
            ms = [r[f"{f}/{c}"]["allreduce_ms"] for r in res]
            print(f"[sharded] all-reduce of the (L, B, d, d) = ({len(ladder)}, {B}, {d}, {d}) "
                  f"fp32 stack: {got['allreduce_bytes']} bytes, {min(ms):.3f}-{max(ms):.3f} "
                  f"ms per rank (median of 5, gloo, {SHARD_K} ranks sharing the card)")
    pod = res[0]["pod"]
    reqs = ridge_requests(device=dev, **POD_TRAFFIC)
    worst = 0.0
    for (A_r, y_r, nu), a in zip(reqs, pod["answers"]):
        err, tol = _ridge_gate(a["x"].to(dev), A_r, y_r, nu, a["iters"])
        worst = max(worst, err / tol)
        if a["shape_class"][0] != 65536 or a["status"] != "OK" or not err <= tol:
            raise SystemExit(f"chip_smoke: sharded pod-scale answer {a['status']} in class "
                             f"{a['shape_class']}, error {err:.3e} (gate {tol:.3e})")
    same = all(torch.equal(a["x"], b["x"]) for r in res[1:]
               for a, b in zip(pod["answers"], r["pod"]["answers"]))
    m = sorted(a["m_final"] for a in pod["answers"])
    kept = max(rows for r in res for rows in r["pod"]["queued_rows"])
    print(f"[sharded] pod-scale class (65536, 256, 512, srht): {len(pod['answers'])} requests "
          f"OK on "
          f"{SHARD_K} ranks in {pod['wall_s'] * 1e3:.1f} ms of flush ({pod['stats']['batches']} "
          f"batch), m_final {m[0]}/{m[len(m) // 2]}/{m[-1]}, worst answer {worst:.3f} of its "
          f"ridge gate; every rank the same answers {same}")
    print(f"[sharded] each rank queued at most {kept} of a request's 65536 rows")
    if not same:
        raise SystemExit("chip_smoke: the sharded service's ranks disagree")
    if kept > 65536 // SHARD_K:
        raise SystemExit(f"chip_smoke: a rank of the sharded service queued {kept} rows of "
                         f"a request, more than its {65536 // SHARD_K}")
    _sharded_ft(smi, res, q, writers)
    launches = {}
    for r in res:
        for counts in r["launches"].values():
            for body, v in counts.items():
                launches[body] = launches.get(body, 0) + v
    print(f"[sharded] launches per Pallas body over the {SHARD_K} ranks' tasks (counted in "
          f"each rank from 0, read after each task): {launches}")
    for body, task in (("_gauss_sa_kernel", "seg"), ("_fwht_kernel_scaled", "pod-ft"),
                       ("_sjlt_kernel_batched", "sjlt/int8")):
        if not all(r["launches"][task][body] > 0 for r in res):
            raise SystemExit(f"chip_smoke: the sharded task {task} never launched {body}")
    del q, A, reqs
    torch.cuda.empty_cache()


def _sharded_ft(smi, res, q, writers):
    """Phase 8 (b)'s deadline, checkpoint and preemption tasks: one verdict
    for every rank."""
    import torch

    from repro_torch.core.status import SolveStatus
    from repro_torch.launch.sharded import ridge_requests

    def same(name, key):
        return all(torch.equal(r[name][key], res[0][name][key]) for r in res)

    def gate(name):
        st, worst = res[0][name]["stats"], 0.0
        for b in range(q.batch):
            if st["status"][b] != int(SolveStatus.OK):
                continue
            err, tol = _ridge_gate(res[0][name]["x"][b].to(q.A.device), q.A[b], None,
                                   float(q.nu[b]), int(st["iters"][b]), rhs=q.b[b])
            if not err <= tol:
                raise SystemExit(f"chip_smoke: sharded {name} slot {b} error {err:.3e} over "
                                 f"its gate {tol:.3e}")
            worst = max(worst, err / tol)
        return worst

    base = res[0]["seg"]
    stats = [r["seg"]["stats"] for r in res]
    if not (same("seg", "x") and all(s["segments"] == stats[0]["segments"] for s in stats)):
        raise SystemExit("chip_smoke: the sharded segmented solve differs between ranks")
    print(f"[mesh-ft] no deadline: {stats[0]['segments']} segments of {SEG_TRIPS} trips, "
          f"{base['wall_s'] * 1e3:.1f} ms on rank 0; worst OK slot {gate('seg'):.3f} of its "
          f"ridge gate")
    gen = [r["seg-generous"] for r in res]
    bitwise = all(torch.equal(g["x"], r["seg"]["x"])
                  and torch.equal(g["stats"]["status"], r["seg"]["stats"]["status"])
                  for g, r in zip(gen, res))
    print(f"[mesh-ft] generous deadline (3600 s): bitwise the no-deadline answer on every "
          f"rank {bitwise}; {gen[0]['stats']['verdicts']} verdicts")
    if not bitwise or any(g["stats"]["deadline_hit"] for g in gen):
        raise SystemExit("chip_smoke: a generous deadline changed the sharded answer")
    bind = [r["seg-bind"] for r in res]
    st0 = bind[0]["stats"]
    agree = (same("seg-bind", "x")
             and all(torch.equal(b["stats"]["status"], st0["status"])
                     and b["stats"]["segments"] == st0["segments"]
                     and b["stats"]["deadline_hit"] == st0["deadline_hit"] for b in bind))
    late = int((st0["status"] == int(SolveStatus.DEADLINE_EXCEEDED)).sum())
    print(f"[mesh-ft] deadline 0 s (binds after the first segment): hit "
          f"{st0['deadline_hit']} after {st0['segments']} of {stats[0]['segments']} "
          f"segments; {late} slots "
          f"DEADLINE_EXCEEDED, the same slots, statuses and segments on every rank {agree}; "
          f"worst OK slot {gate('seg-bind'):.3f} of its ridge gate; every x finite "
          f"{bool(torch.isfinite(bind[0]['x']).all())}")
    if not (agree and st0["deadline_hit"] and st0["segments"] == 1
            and st0["segments"] < stats[0]["segments"] and late > 0
            and bool(torch.isfinite(bind[0]["x"]).all())):
        raise SystemExit("chip_smoke: the sharded deadline did not bind mid-solve on one "
                         "verdict for every rank")
    others = [r["seg-others-late"] for r in res]
    lead = [r["seg-lead-late"] for r in res]
    never = all(not o["stats"]["deadline_hit"] and torch.equal(o["x"], r["seg"]["x"])
                and torch.equal(o["stats"]["status"], r["seg"]["stats"]["status"])
                for o, r in zip(others, res))
    binds = all(lo["stats"]["deadline_hit"] and lo["stats"]["segments"] == 1
                and torch.equal(lo["x"], r["seg-bind"]["x"])
                and torch.equal(lo["stats"]["status"], r["seg-bind"]["stats"]["status"])
                for lo, r in zip(lead, res))
    print(f"[mesh-ft] deadline 0 s on ranks 1-{SHARD_K - 1} only (3600 s on the lead): never "
          f"bound, bitwise the no-deadline answer on every rank {never}; worst OK slot "
          f"{gate('seg-others-late'):.3f} of its ridge gate. Deadline 0 s on the lead only: "
          f"bound after segment 1 on every rank, bitwise the all-ranks zero deadline {binds}")
    if not (never and binds):
        raise SystemExit("chip_smoke: a sharded deadline followed a clock other than the "
                         "lead rank's")
    pre = [r["seg-preempt"] for r in res]
    saves = [p["saves"] for p in pre]
    resumed = [r["seg-resume"] for r in res]
    ok = (all(p["preempted"] == 2 for p in pre) and saves[0] > 0 and not any(saves[1:])
          and all(r["stats"]["resumed"] for r in resumed)
          and all(torch.equal(r2["x"], r["seg"]["x"]) for r2, r in zip(resumed, res)))
    print(f"[mesh-ft] preemption flag on rank {SEG_PREEMPT[0]} only: raised at segments "
          f"{[p['preempted'] for p in pre]}, checkpoints written per rank {saves}; resumed "
          f"answer bitwise the uninterrupted one on every rank {ok}")
    if not ok:
        raise SystemExit("chip_smoke: the sharded preemption did not stop every rank at one "
                         "segment, or the resume is not bitwise")
    ms = [r["seg-generous"]["stats"]["verdict_s"] * 1e3 / r["seg-generous"]["stats"]["verdicts"]
          for r in res]
    print(f"[mesh-ft] host verdict (one (2,) int32 MAX all-reduce, gloo, {SHARD_K} ranks "
          f"sharing the card): {', '.join(f'{v:.3f}' for v in ms)} ms a segment boundary "
          f"per rank; {smi}")
    pod = [r["pod-ft"] for r in res]
    for (A_r, y_r, nu), a in zip(ridge_requests(device=q.A.device, **POD_TRAFFIC),
                                 pod[0]["answers"]):
        err, tol = _ridge_gate(a["x"].to(q.A.device), A_r, y_r, nu, a["iters"])
        if a["status"] != "OK" or not err <= tol:
            raise SystemExit(f"chip_smoke: pod-scale answer under deadlines {a['status']}, "
                             f"error {err:.3e} (gate {tol:.3e})")
    same_pod = all(p["order"] == pod[0]["order"]
                   and all(torch.equal(a["x"], b["x"])
                           for a, b in zip(p["answers"], pod[0]["answers"])) for p in pod)
    print(f"[mesh-ft] pod-scale class under per-request deadlines with a checkpoint "
          f"directory: {len(pod[0]['answers'])} answers OK under the ridge gate, "
          f"{pod[0]['stats']['segments']} segments; the same EDF order and answers on every "
          f"rank {same_pod}; checkpoints in {writers}")
    if not same_pod or "pod" not in writers:
        raise SystemExit("chip_smoke: the pod-scale service under deadlines differs between "
                         "ranks or wrote no checkpoint")


def phase_nccl():
    """Phase 8 (c): a one-rank NCCL group: the sharded pass is bitwise the
    one-device provider under fold_seeds(seed, 0)."""
    import torch

    from repro_torch.core.adaptive_padded import doubling_ladder
    from repro_torch.core.level_grams import fold_seeds, get_provider
    from repro_torch.core.quadratic import Quadratic
    from repro_torch.launch.mesh import run_ranks

    dev = torch.device("cuda")
    B, n, d, m_max = 16, 4096, 256, 512
    g = torch.Generator(device=dev).manual_seed(90)
    q = Quadratic(A=torch.randn((B, n, d), generator=g, device=dev) / n ** 0.5,
                  b=torch.zeros((B, d), device=dev), nu=torch.ones(B, device=dev),
                  lam_diag=torch.ones((B, d), device=dev), batched=True)
    seeds = torch.randint(0, 2 ** 32, (B,), generator=g, device=dev, dtype=torch.int64)
    ladder = doubling_ladder(m_max)
    q_cpu = Quadratic(A=q.A.cpu(), b=q.b.cpu(), nu=q.nu.cpu(), lam_diag=q.lam_diag.cpu(),
                      batched=True)
    res = run_ranks("repro_torch.launch.sharded:run_tasks", 1, {"tasks": [
        ("g", "pass", dict(q=q_cpu, seeds=seeds.cpu(), ladder=ladder, sketch="gaussian",
                           compute_dtype="fp32"))]}, backend="nccl", device="cuda", timeout=300)
    prov = get_provider("gaussian")
    want = prov.level_grams(prov.sample(fold_seeds(seeds, 0), m_max, n), q, ladder).cpu()
    ok = torch.equal(res[0]["g"]["grams"], want)
    print(f"[nccl] one-rank NCCL group: shard_level_grams gaussian/fp32 bitwise the "
          f"one-device provider {ok}")
    if not ok:
        raise SystemExit("chip_smoke: the one-rank NCCL pass is not the one-device pass")


AUDIT_CLASSES = (("top", 3, 512), ("SRHT", 4, 512))    # (label, TRAFFIC row, m_max)
# the gaussian_dense pass, weighted or not, above entry: at most this many
# times (dense S + SA), plus in bf16 and int8 one A-sized fp32 copy
# (4·B·n·d); the dense S is built in column blocks, so the plain hash's
# temporaries are a fraction of S (it held 16.1× S unblocked)
DENSE_GATE = 1.25


def _queued(dev, row: int, seed: int, sketch: str):
    """A new service (default family ``sketch``) holding one full batch of
    phase 4's traffic for one class."""
    import torch

    from repro_torch.serve.solver_service import SolverService

    _, n_rng, d_rng = TRAFFIC[row]
    g = torch.Generator(device=dev).manual_seed(seed)
    svc = SolverService(device=dev, sketch=sketch)
    for _ in range(svc.batch_size):
        svc.submit(*_request(g, dev, n_rng, d_rng))
    return svc, g


def _audit_batch(dev, row: int, seed: int):
    """The service's packed batch of one class of phase 4's traffic: (the
    class, q, seeds, row weights)."""
    import torch

    svc, g = _queued(dev, row, seed, "srht" if row == 4 else "gaussian")
    cls = next(c for c, queue in svc._queues.items() if queue)
    q, seeds = svc._pack(cls, svc._queues[cls])
    w = torch.rand((q.batch, q.n), generator=g, device=dev) + 0.5
    return cls, q, seeds, w


def phase_audit(smi, dev="cuda"):
    """Phase 9: the invariant audit on the card, peak device memory of every
    one-touch pass and of whole flushes, the state audit and the rebuild
    sentinel."""
    import torch

    from repro_torch.analysis.audit.retrace import check_rebuild_sentinel, check_segment_state
    from repro_torch.analysis.audit.runner import run_audit
    from repro_torch.analysis.audit.rules import gaussian_budget
    from repro_torch.analysis.memscan import peak_bytes_above_entry
    from repro_torch.core.adaptive_padded import doubling_ladder
    from repro_torch.core.level_grams import PADDED_SKETCHES, get_provider
    from repro_torch.kernels import ops
    from repro_torch.kernels.precision import COMPUTE_DTYPES

    dev = torch.device(dev)
    # (a) the full registry and every negative control, on the card
    t0 = time.perf_counter()
    report = run_audit(device=dev)
    for line in report.human_report().splitlines():
        print(f"[audit] {line}")
    print(f"[audit] {report.summary()} in {time.perf_counter() - t0:.1f} s; {smi}")
    if not report.passed:
        raise SystemExit("chip_smoke: the invariant audit failed on the card")

    # (b) peak device memory of every one-touch pass at full width
    ops.reset_launches()
    for label, row, m_max in AUDIT_CLASSES:
        cls, q, seeds, w = _audit_batch(dev, row, seed=100 + row)
        B, n, d = q.batch, q.n, q.d
        ladder = doubling_ladder(m_max)
        budget = gaussian_budget(B, n, d, m_max)
        dense = 4 * B * m_max * n
        quant = 4 * B * n * d          # int8's fp32 A-sized pass, the reference's allowance
        print(f"[memory] {label} class {tuple(cls[:3])}, B = {B}: dense S {dense} B, "
              f"Gaussian budget {budget} B (int8: + {quant} B for one fp32 A-sized "
              f"quantization pass), pinvs {len(ladder) * B * d * d * 4} B; {smi}")
        for family in PADDED_SKETCHES:
            prov = get_provider(family)
            for cd in COMPUTE_DTYPES:
                for weighted in (False, True):
                    def one_pass(prov=prov, cd=cd, weighted=weighted):
                        return prov.level_grams(prov.sample(seeds, m_max, n), q, ladder,
                                                row_weights=w if weighted else None,
                                                compute_dtype=cd)
                    # a warm call first: a process's first cuBLAS call allocates
                    # its 32 MiB workspace, which is no pass's
                    one_pass()
                    peak, _ = peak_bytes_above_entry(one_pass, dev)
                    gate = budget + (quant if cd == "int8" else 0)
                    gated = family == "gaussian"
                    if family == "gaussian_dense":
                        # the materialized baseline holds one S and SA; its
                        # reduced legs add one fp32 copy of A, rounded
                        gate = (DENSE_GATE * (dense + 4 * B * m_max * d)
                                + (quant if cd != "fp32" else 0))
                        gated = True
                    print(f"[memory] {label} {family}/{cd} "
                          f"{'weighted' if weighted else 'unweighted'}: {peak} B above entry "
                          f"({peak / 1e6:.2f} MB; {peak / dense:.3f} of dense S"
                          + (f", {peak / gate:.3f} of its gate {gate:.0f} B" if gated else "")
                          + ")")
                    if gated and peak > gate:
                        raise SystemExit(f"chip_smoke: the {family} {cd} pass peaks "
                                         f"at {peak} B, over its gate {gate:.0f} B")
        del q, seeds, w
        torch.cuda.empty_cache()
    launches = dict(ops.LAUNCHES)
    print(f"[memory] launches per kernel leg over (b): {launches}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise SystemExit(f"chip_smoke: phase 9 (b) never launched {missing}")

    # (c) whole flushes, each on a new service with a full batch queued
    for label, row, sketch in (("top", 3, "gaussian"), ("SRHT", 4, "srht")):
        svc, _ = _queued(dev, row, 120 + row, sketch)
        peak, sols = peak_bytes_above_entry(svc.flush, dev)
        ok = sum(s.status == "OK" for s in sols.values())
        print(f"[memory] one {label}-class flush in {sketch}/fp32 ({len(sols)} requests, "
              f"{ok} OK): {peak} B above entry ({peak / 1e6:.2f} MB); {smi}")
        del svc, sols
        torch.cuda.empty_cache()

    # (d) the state audit, and the rebuild sentinel over a second flush
    vs, found = check_segment_state(dev)
    print(f"[state] an {found['trips']}-trip segment at the top class: {found['peak_bytes']} "
          f"B above entry ({found['peak_bytes'] / 1e6:.2f} MB) against pinvs' "
          f"{found['pinvs_bytes']} B; {smi}")
    if vs:
        raise SystemExit(f"chip_smoke: {vs[0].message}")
    for label, row, sketch in (("top", 3, "gaussian"), ("SRHT", 4, "srht")):
        reserved = {}

        def flush(device, seed, row=row, sketch=sketch, reserved=reserved):
            svc, _ = _queued(device, row, 140 + seed, sketch)
            torch.cuda.synchronize(device)
            before = torch.cuda.memory_reserved(device)
            svc.flush()
            torch.cuda.synchronize(device)
            reserved[seed] = torch.cuda.memory_reserved(device) - before

        vs = check_rebuild_sentinel(dev, flush, name=f"flush:{label}")
        print(f"[sentinel] a second {label}-class flush in {sketch}/fp32 compiled and opened "
              f"no library: {not vs}; memory_reserved grew by {reserved[1]} B over it "
              f"({reserved[0]} B over the first)")
        if vs:
            raise SystemExit(f"chip_smoke: {vs[0].message} ({vs[0].provenance})")
    torch.cuda.empty_cache()


def phase_dryrun(smi):
    """Phase 8 (d): the solver's pod-scale dry-run, all six variants on the
    16×16 and 2×16×16 fake meshes, traced per rank with nothing allocated;
    the roofline terms are H100 data-sheet arithmetic, not a measurement."""
    from repro_torch.analysis.roofline import analyze_record
    from repro_torch.launch import dryrun_solver

    for mesh_name in ("single", "multi"):
        for variant in dryrun_solver.VARIANTS:
            rec = dryrun_solver.run(variant, mesh_name, None)
            if rec["status"] != "ok":
                raise SystemExit(f"chip_smoke: dry-run {mesh_name}/{variant}: {rec['error']}")
            r = analyze_record(rec)
            print(f"[dryrun] {mesh_name} ({rec['n_devices']} ranks) solver-{variant}: per rank "
                  f"{rec['hlo_dot_flops']:.4e} dot FLOPs ({rec['flops']:.4e} with the analytic "
                  f"factorization, solves and sketch), {rec['collectives']['total_bytes']} B "
                  f"of collectives, {rec['bytes_accessed']:.4e} B accessed; data-sheet terms "
                  f"compute {r.compute_s:.4e} s, memory {r.memory_s:.4e} s, collective "
                  f"{r.collective_s:.4e} s → {r.bottleneck}; useful {r.useful_ratio:.3f}")
    print(f"[dryrun] 12 records ok (traced on the host under FakeTensorMode; the terms are "
          f"data-sheet arithmetic, beside {smi})")


# phase 10: LM serving at qwen2-0.5b's full width (the launcher's default
# --arch and the probe's backbone): B prompts of LM_PROMPT tokens, LM_NEW
# new tokens, greedy, seeded parameters
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "qwen2-0.5b", 4, 32, 16
# decode against the uncached forward at the reference's own bound
# (tests/test_models.py: rtol = atol = 2e-3); cached greedy ids against an
# uncached argmax wherever the top-2 margin exceeds LM_MARGIN (below it two
# summation orders may pick different ids)
LM_DECODE_TOL, LM_MARGIN = 2e-3, 1e-3
# the same fp32 forward on the card and on the CPU: matmuls summed in other
# orders, about 1e-6 of the logits' scale a layer
LM_CPU_REL_TOL = 1e-4
# decode steps in the profiled window of (a)
LM_PROFILED_STEPS = 8
# bf16 against fp32 logits of the same prompt, rms(Δ) / rms(fp32 logits):
# bf16 rounding at this width moves them by a few percent; above the upper
# bound something worse than rounding broke, below the lower one the bf16
# path ran in fp32 (TF32 is off, so that would be about 1e-6). At random
# weights one misplaced cast moves the logits no more than rounding does,
# so (a) also scans one bf16 decode step op by op (_lm_bf16_check)
LM_BF16_GAP = (1e-3, 5e-2)
# the probe: features of PROBE_BATCH × PROBE_SEQ tokens (and a quarter as
# many held-out sequences); the gate of test_system.py::test_ridge_probe_pipeline
PROBE_BATCH, PROBE_SEQ, PROBE_MSE_SHARE = 256, 32, 0.05


def _lm_decode_check(model, cfg, tokens, enc, *, prefill, max_seq, tag):
    """Phase 10 (b), (d): prefill ``prefill`` tokens, decode the rest one
    by one; each step's logits against the uncached forward's at the
    reference's bound. Returns the max |Δ|."""
    import torch

    from repro_torch.models import init_cache
    from repro_torch.serve.step import decode_step, prefill_step

    f32, dev = torch.float32, tokens.device
    B, S = tokens.shape
    want = model(tokens, enc_feats=enc, compute_dtype=f32)[0][:, prefill - 1:]
    cache = init_cache(cfg, B, max_seq, dtype=f32, device=dev)
    lg, cache = prefill_step(model, cfg, tokens[:, :prefill], cache, enc_feats=enc,
                             compute_dtype=f32, device=dev)
    outs = [lg]
    for t in range(prefill, S):
        lg, cache = decode_step(model, cfg, tokens[:, t:t + 1], cache, t, compute_dtype=f32,
                                device=dev)
        outs.append(lg)
    got = torch.stack(outs, dim=1)[:, :want.shape[1]]
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= LM_DECODE_TOL + LM_DECODE_TOL * want.abs()).all())
    print(f"[lm] {tag}: decode after a {prefill}-token prefill against the uncached forward "
          f"over {S} tokens, max |Δ| {err:.3e} (rtol = atol = {LM_DECODE_TOL:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {tag}: cached decode disagrees with the forward")
    return err


def _lm_serving(smi, model, cfg, prompts, cd, tag):
    """Phase 10 (a) in one compute dtype: greedy ids, prefill ms, ms a decode
    step, tokens/s, peak device memory of a warm call, the device's busy
    share of a decode window. Returns the greedy ids."""
    import torch

    from repro_torch.analysis.audit.op_trace import record
    from repro_torch.launch.breakdown import _device_profile
    from repro_torch.models import init_cache
    from repro_torch.serve.step import decode_step, greedy_generate, prefill_step

    dev = prompts.device
    B, P = prompts.shape
    max_seq = P + LM_NEW + 1

    def generate():
        return greedy_generate(model, cfg, prompts, LM_NEW, max_seq=max_seq,
                               compute_dtype=cd, device=dev)
    generate()                                       # warm: cuBLAS handles, allocator
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids = generate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if ids.shape != (B, LM_NEW) or not bool(((ids >= 0) & (ids < cfg.vocab)).all()):
        raise SystemExit(f"chip_smoke: {tag}: greedy ids out of shape or range")

    prefill_ms = time_ms(lambda: prefill_step(
        model, cfg, prompts, init_cache(cfg, B, max_seq, dtype=cd, device=dev),
        compute_dtype=cd, device=dev), reps=5)
    logits, cache = prefill_step(model, cfg, prompts, init_cache(cfg, B, max_seq, dtype=cd,
                                                                  device=dev),
                                 compute_dtype=cd, device=dev)
    tok = torch.argmax(logits, dim=-1)[:, None]
    step_ms = time_ms(lambda: decode_step(model, cfg, tok, cache, P, compute_dtype=cd,
                                          device=dev), reps=10)

    def window():
        c, t = cache, tok
        for pos in range(P, P + LM_PROFILED_STEPS):
            lg, c = decode_step(model, cfg, t, c, pos, compute_dtype=cd, device=dev)
            t = torch.argmax(lg, dim=-1)[:, None]
        return t
    window()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    busy, n_device, n_copies = _device_profile(window)
    if busy is None:
        raise SystemExit(f"chip_smoke: {tag}: the profiler saw no device time in the decode "
                         "window")
    # a decode step's bound: every weight read once, 2 FLOPs a weight a row
    n_w = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    step_bound, bound_by = bound_ms(2 * B * n_w, w_bytes)
    dev_step_ms = busy * 1e3 / LM_PROFILED_STEPS
    sites = record(lambda: decode_step(model, cfg, tok, cache, P, compute_dtype=cd,
                                       device=dev), device=dev).sites
    print(f"[lm] {tag}: B={B}, prompt {P}, {LM_NEW} new tokens: prefill {prefill_ms:.3f} ms, "
          f"decode step {step_ms:.3f} ms (median of 10), {B * LM_NEW / wall:.1f} tok/s "
          f"({wall * 1e3:.1f} ms for the greedy call), peak device memory "
          f"{peak:,} B ({peak - base:,} B above the {base:,} B held before), a "
          f"{LM_PROFILED_STEPS}-step decode window {window_s * 1e3:.2f} ms wall, device "
          f"{busy / window_s:.3f} busy, {1 - busy / window_s:.3f} idle ({smi})")
    print(f"[lm] {tag}: the profiled window ran {n_device} device activities "
          f"({n_copies} memcpy/memset), {n_device / LM_PROFILED_STEPS:.1f} a decode step, "
          f"which dispatches {len(sites)} torch ops ({sum(any(x.new) for x in sites)} of "
          f"them allocate); "
          f"device time {dev_step_ms:.3f} ms a step, {dev_step_ms / step_bound:.1f}x the "
          f"step's {step_bound:.3f} ms bound ({bound_by}: {w_bytes:,} B of weights read "
          f"once) ({smi})")
    return ids


def _lm_bf16_check(smi, model, cfg, prompts):
    """Phase 10 (a) in bf16: the bf16 prefill logits against the fp32 ones
    of the same prompt within LM_BF16_GAP, and one bf16 decode step scanned
    op by op on the card: every matmul on bf16 operands (qwen2's reference
    contracts only in bf16; tests/test_torch_models.py holds every config's
    set to the reference's), every softmax and norm mean on fp32, and the
    cache it returns in bf16."""
    import math

    import torch

    from repro_torch.analysis.audit.op_trace import CONTRACTION_OPS, record
    from repro_torch.models import init_cache
    from repro_torch.serve.step import decode_step, prefill_step

    dev, bf16 = prompts.device, torch.bfloat16
    B, P = prompts.shape
    logits = {}
    for cd in (torch.float32, bf16):
        logits[cd], cache = prefill_step(model, cfg, prompts, init_cache(
            cfg, B, P + 2, dtype=cd, device=dev), compute_dtype=cd, device=dev)
    f32, b16 = logits[torch.float32], logits[bf16]
    gap = float(torch.sqrt(((b16 - f32) ** 2).mean() / (f32 ** 2).mean()))
    top1 = float((b16.argmax(-1) == f32.argmax(-1)).float().mean())
    tok = torch.argmax(b16, dim=-1)[:, None]
    trace = record(lambda: decode_step(model, cfg, tok, cache, P, compute_dtype=bf16,
                                       device=dev), device=dev)
    _, new_cache = trace.result
    seen = {}
    for site in trace.sites:
        kind = ("matmul" if site.base in CONTRACTION_OPS else
                site.base if site.base in ("aten._softmax", "aten.mean") else None)
        if kind:
            seen.setdefault(kind, set()).update(str(d).split(".")[-1] for d in site.in_dtypes)
    leaves = {str(t.dtype).split(".")[-1] for part in new_cache.values() for layers in
              part.values() for c in (layers if isinstance(layers, list) else [layers])
              for t in c.values()}
    want = {"matmul": {"bfloat16"}, "aten._softmax": {"float32"}, "aten.mean": {"float32"}}
    ok_gap = LM_BF16_GAP[0] <= gap <= LM_BF16_GAP[1]
    ok_ops = seen == want and leaves == {"bfloat16"}
    print(f"[lm] {cfg.name} bf16 against fp32 prefill logits ({B}, {P}): rms |Δ| / rms "
          f"{gap:.3e} (within {LM_BF16_GAP}: {ok_gap}), max |Δ| "
          f"{float((b16 - f32).abs().max()):.3e} at max |logits| {float(f32.abs().max()):.3e}, "
          f"top-1 equal in {top1:.4f}; one bf16 decode step, {len(trace.sites)} ops: input "
          f"dtypes {dict(sorted((k, sorted(v)) for k, v in seen.items()))}, cache "
          f"{sorted(leaves)} ({'ok' if ok_ops else 'FAIL'}) ({smi})")
    if not (ok_gap and ok_ops and math.isfinite(gap)):
        raise SystemExit("chip_smoke: the bf16 path is not the reference's bf16")


def phase_lm(smi):
    """Phase 10: LM serving and the ridge probe on the card. (a) greedy
    decode at qwen2-0.5b's full width in fp32 and bf16 with its times,
    peak memory and busy share; (b) the fp32 cache against the uncached
    forward, and the cached greedy ids against an uncached argmax; (c) one
    fp32 forward on the card against the same parameters on the CPU; (d)
    the other families reduced (and recurrentgemma with a remainder layer):
    a forward, decode against prefill, gemma2's ring at prompts 40 and 20
    around its window of 32; (e) the ridge probe's fit on the full-width
    features. Returns (the probe's launches per Pallas body, the SJLT
    measurement at the probe's shape)."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.core.sketches import make_sketch
    from repro_torch.device import check_fp32_matmul
    from repro_torch.kernels import ops
    from repro_torch.kernels import sjlt as ksj
    from repro_torch.launch.ridge_probe import NU, run_probe
    from repro_torch.models import Transformer, init_params

    dev = torch.device("cuda")
    check_fp32_matmul()
    cfg = get_config(LM_ARCH)
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(cfg, generator=g, device=dev, max_seq=LM_PROMPT + LM_NEW + 1)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[lm] {cfg.name}: {n_params:,} parameters (param_count {cfg.param_count():,}), "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, seeded on {dev} in "
          f"{time.perf_counter() - t0:.2f} s")
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=g, device=dev)
    clock = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        print(f"[time] phase 10 {part}: {now - clock[0]:.1f} s")
        clock[0] = now

    # (a) greedy serving in fp32 and bf16
    ids = _lm_serving(smi, model, cfg, prompts, torch.float32, f"{cfg.name} fp32")
    _lm_serving(smi, model, cfg, prompts, torch.bfloat16, f"{cfg.name} bf16")
    _lm_bf16_check(smi, model, cfg, prompts)
    lap("(a)")

    # (b) the cache at full width, fp32: decode against the uncached forward;
    # the greedy ids against an uncached argmax over the same history
    _lm_decode_check(model, cfg, prompts[:, :12], None, prefill=1, max_seq=12,
                     tag=f"{cfg.name} fp32, a 12-token prompt")
    seq = torch.cat([prompts, ids[:, :-1]], dim=1)
    logits = model(seq, compute_dtype=torch.float32)[0][:, LM_PROMPT - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > LM_MARGIN
    same = torch.argmax(logits, dim=-1) == ids
    print(f"[lm] {cfg.name} fp32 greedy ids against an uncached argmax: {int(same.sum())} of "
          f"{same.numel()} equal; {int(clear.sum())} with a top-2 margin above {LM_MARGIN:g}, "
          f"all of those equal: {bool(same[clear].all())}")
    if not bool(same[clear].all()):
        raise SystemExit("chip_smoke: cached greedy ids differ from the uncached argmax")
    lap("(b)")

    # (c) the card against the CPU, one fp32 forward of a (2, 16) prompt
    cpu = Transformer(cfg, max_seq=LM_PROMPT + LM_NEW + 1, device="cpu")
    cpu.load_state_dict(model.state_dict())
    x = prompts[:2, :16]
    on_card = model(x, compute_dtype=torch.float32)[0].cpu()
    t0 = time.perf_counter()
    on_cpu = cpu(x.cpu(), compute_dtype=torch.float32)[0]
    rel = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    print(f"[lm] {cfg.name} fp32 forward (2, 16), card against CPU: max |Δ| / max |logits| "
          f"{rel:.3e} (tolerance {LM_CPU_REL_TOL:g}; the CPU took "
          f"{time.perf_counter() - t0:.2f} s)")
    if not rel <= LM_CPU_REL_TOL:
        raise SystemExit("chip_smoke: the card's forward disagrees with the CPU's")
    del cpu, on_card, on_cpu
    lap("(c)")

    # (d) every family reduced; the MoE families at a capacity that never
    # binds (a 12-token group drops tokens a 1-token decode group keeps, in
    # the reference too); recurrentgemma at 7 layers runs a remainder layer
    worst = 0.0
    for arch, n_layers in [(a, None) for a in ARCHS] + [("recurrentgemma-9b", 7)]:
        rcfg = get_config(arch).reduced()
        if n_layers:
            rcfg = dataclasses.replace(rcfg, n_layers=n_layers)
        if rcfg.n_experts:
            rcfg = dataclasses.replace(rcfg, capacity_factor=rcfg.n_experts / rcfg.top_k + 0.01)
        rg = torch.Generator(device=dev).manual_seed(1)
        rmodel = init_params(rcfg, generator=rg, device=dev, max_seq=64)
        toks = torch.randint(0, rcfg.vocab, (2, 48), generator=rg, device=dev)
        enc = (torch.randn((2, rcfg.enc_seq, rcfg.d_model), generator=rg, device=dev)
               if rcfg.n_enc_layers else None)
        lg = rmodel(toks[:, :16], enc_feats=enc, compute_dtype=torch.float32)[0]
        if lg.shape != (2, 16, rcfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise SystemExit(f"chip_smoke: {rcfg.name}: forward not finite or misshaped")
        tag = f"{rcfg.name} ({rcfg.n_layers} layers, {rcfg.n_rem} remainder)"
        worst = max(worst, _lm_decode_check(rmodel, rcfg, toks[:, :12], enc, prefill=1,
                                            max_seq=12, tag=tag))
        if arch == "gemma2-27b":
            for prefill, S in ((40, 48), (20, 36)):       # around the window of 32
                worst = max(worst, _lm_decode_check(
                    rmodel, rcfg, toks[:, :S], None, prefill=prefill, max_seq=64,
                    tag=f"{rcfg.name} ring (window {rcfg.window}), prompt {prefill}"))
    print(f"[lm] every family reduced: worst decode |Δ| {worst:.3e} ({smi})")
    lap("(d)")

    # (e) the ridge probe on the full-width features; the solve's kernel
    # launches counted from 0
    ops.reset_launches()
    r = run_probe(model, batch=PROBE_BATCH, seq=PROBE_SEQ, seed=1, device=dev)
    launches = dict(ops.BODY_LAUNCHES)
    q, x = r["q"], r["x"]
    H64 = q.A.double().T @ q.A.double() + NU ** 2 * torch.eye(q.d, dtype=torch.float64,
                                                               device=dev)
    x64 = torch.linalg.solve(H64, q.b.double())
    ev = torch.linalg.eigvalsh(H64)
    kappa = float(ev[-1] / ev[0])
    e = x.double() - x64
    err = float(torch.sqrt(torch.trace(e.T @ H64 @ e) / torch.trace(x64.T @ H64 @ x64)))
    gate = max(SOLVE_REL_TOL, FP32_UNIT * kappa * max(r["iters"], 1) ** 0.5)
    print(f"[probe] {cfg.name} features {r['features']} in {r['feature_s'] * 1e3:.2f} ms; "
          f"adaptive PCG/SJLT {r['solve_s'] * 1e3:.2f} ms, {r['iters']} iterations, m_final "
          f"{r['m_final']}, {r['n_doublings']} doublings; relative error against the fp32 "
          f"direct solve {r['rel_err']:.3e}, against the fp64 solve {err:.3e} in the H-norm "
          f"(gate {gate:.3e}, κ(H) {kappa:.3e}); MSE {r['mse']:.5f}, held-out MSE "
          f"{r['heldout_mse']:.5f} against {PROBE_MSE_SHARE} × mean(y²) = "
          f"{PROBE_MSE_SHARE * r['heldout_base']:.5f}; launches {launches} ({smi})")
    if not (math.isfinite(err) and err <= gate):
        raise SystemExit(f"chip_smoke: the probe's fit misses the ridge gate: {err:.3e}")
    if not r["heldout_mse"] < PROBE_MSE_SHARE * r["heldout_base"]:
        raise SystemExit("chip_smoke: the probe's held-out MSE misses its gate")
    if launches["_sjlt_kernel"] <= 0:
        raise SystemExit("chip_smoke: the probe's solve never launched the SJLT kernel")

    # the B = 1 SJLT at the probe's shape: the fitted features and a sketch
    # of the final size
    A, M = q.A, r["m_final"]
    if M >= q.n:
        raise SystemExit(f"chip_smoke: the probe ended unsketched (m_final {M} ≥ n {q.n})")
    sk = make_sketch("sjlt", M, q.n, 5, device=dev)
    tgt, sg = sk.data["rows"][0], sk.data["signs"][0]

    def index_add():
        return torch.zeros((M, q.d), device=dev).index_add_(0, tgt, A * sg[:, None])
    rec = _measure(f"sjlt single problem, ridge probe (n={q.n}, d={q.d}, M={M})",
                   lambda: ops.sjlt_apply(A, tgt, sg, M), lambda: ksj.sjlt_ref(A, tgt, sg, M),
                   sjlt_terms(1, q.n, q.d, M, shared=True, index_itemsize=8), SJLT_REL_TOL,
                   library=index_add)
    del model, r, q, A
    torch.cuda.empty_cache()
    lap("(e)")
    return launches, rec


# phase 11: LM training at qwen2-0.5b's full width: B × S tokens of one
# SyntheticLM batch, TRAIN_MB microbatches, remat, TRAIN_STEPS steps
TRAIN_ARCH, TRAIN_B, TRAIN_SEQ, TRAIN_MB, TRAIN_STEPS = "qwen2-0.5b", 8, 128, 2, 10
TRAIN_LR = 3e-3
# the steps train on one batch: on fresh draws 10 steps cannot lower the
# loss (three quarters of SyntheticLM's tokens are uniform draws), while
# one batch of 1024 tokens is memorized within a few steps; the last loss
# must fall under this share of the first
TRAIN_GATE = 0.5
# (b) the same fp32 step on the card and on the CPU: matmuls summed in
# other orders (about 1e-6 of the scale); each grad against max |g| of all
TRAIN_CPU_REL_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
# (c) the blocked loss against lm_loss: the reference's own bound
# (tests/test_blocked_ce.py)
CE_LOSS_TOL, CE_RTOL, CE_ATOL, CE_CHUNKS = 1e-5, 2e-4, 2e-5, 8
# (d) the launcher's reduced runs
LAUNCH_FLAGS = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "4", "--seq", "64",
                "--save-every", "10", "--log-every", "1"]
# bitwise resumes on the card need deterministic kernels (the embedding's
# backward accumulates with atomics otherwise)
DETERMINISTIC = ("import sys, torch; torch.use_deterministic_algorithms(True); "
                 "from repro_torch.launch.train import main; main(sys.argv[1:])")


# device kernels by kind, from their names (cuBLAS/CUTLASS GEMMs, the bf16
# ones named nvjet, PyTorch's elementwise and reduction templates, its
# softmax, the foreach kernels)
KERNEL_KINDS = (("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
                ("foreach", ("multi_tensor", "foreach")),
                ("softmax", ("softmax",)),
                ("reduction", ("reduce",)),
                ("elementwise", ("elementwise", "vectorized", "unrolled")))


def _device_kinds(events):
    """Device ms by kernel kind of a profile's device events, the five
    kernels with the most device time (name, ms, launches), and the one of
    kind "other" with the most."""
    by_name = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    kinds, other = {}, []
    for name, (ms, n) in by_name.items():
        low = name.lower()
        kind = next((k for k, keys in KERNEL_KINDS if any(x in low for x in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
        if kind == "other":
            other.append((name, ms, n))
    top = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda r: -r[1])[:5]
    return kinds, top, max(other, key=lambda r: r[1], default=None)


def _train_step_split(step, model, opt, batch, tcfg):
    """(ms of a warm step, ms of AdamW alone): CUDA events, median of 5."""
    from repro_torch.train.optimizer import adamw_update

    step_ms = time_ms(lambda: step(model, opt, batch), reps=5, warm=1)
    params = dict(model.named_parameters())
    grads = {k: p.grad for k, p in params.items()}
    adam_ms = time_ms(lambda: adamw_update(tcfg.opt, params, grads, opt), reps=5, warm=1)
    return step_ms, adam_ms


def _train_full(smi, cd, tag):
    """Phase 11 (a) in one compute dtype."""
    import torch

    from repro_torch.analysis.roofline import (
        PEAK_BF16_FLOPS,
        adamw_terms,
        bound_ms,
        lm_train_terms,
    )
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.breakdown import device_events, device_totals
    from repro_torch.launch.train import device_batch
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, TrainConfig, init_opt_state, make_train_step

    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    model = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev,
                        max_seq=TRAIN_SEQ)
    opt = init_opt_state(model)
    tcfg = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS),
                       num_microbatches=TRAIN_MB, compute_dtype=cd, remat=True)
    step = make_train_step(cfg, tcfg)
    batch = device_batch(next(SyntheticLM(vocab=cfg.vocab, batch=TRAIN_B, seq_len=TRAIN_SEQ)),
                         dev)
    losses, norms, walls = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))                 # waits for the card
        walls.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
    ok = all(math.isfinite(v) for v in losses + norms) and losses[-1] < TRAIN_GATE * losses[0]
    tokens = TRAIN_B * TRAIN_SEQ
    n = sum(p.numel() for p in model.parameters())
    # the steps above were the run; what follows times more steps
    step_ms, adam_ms = _train_step_split(step, model, opt, batch, tcfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(model, opt, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    # launch/breakdown._device_profile's reading, its events kept for the kinds
    events = device_events(lambda: step(model, opt, batch))
    busy, n_dev, n_copies = device_totals(events)
    if busy is None:
        raise SystemExit(f"chip_smoke: {tag}: the profiler saw no device time in a train step")
    kinds, top, other = _device_kinds(events)
    peak_flops = PEAK_BF16_FLOPS if cd == torch.bfloat16 else PEAK_FP32_FLOPS
    fb_flops, fb_bytes = lm_train_terms(n, tokens)
    fb_bound, fb_by = bound_ms(fb_flops, fb_bytes, peak_flops)
    ad_flops, ad_bytes = adamw_terms(n)
    ad_bound, ad_by = bound_ms(ad_flops, ad_bytes)
    walls_ms = sorted(w * 1e3 for w in walls[1:])
    print(f"[train] {tag}: B={TRAIN_B}, S={TRAIN_SEQ}, {TRAIN_MB} microbatches, remat, "
          f"{n:,} parameters; losses {' '.join(f'{v:.4f}' for v in losses)} (gate: last < "
          f"{TRAIN_GATE} × first: {'ok' if ok else 'FAIL'}), grad norms {norms[0]:.4f} → "
          f"{norms[-1]:.4f}; host clock of the 9 warm steps: median "
          f"{walls_ms[len(walls_ms) // 2]:.3f} ms ({smi})")
    print(f"[train] {tag}: step {step_ms:.3f} ms (CUDA events, median of 5), "
          f"{tokens / step_ms * 1e3:.1f} tokens/s; forward+backward {step_ms - adam_ms:.3f} ms "
          f"against its {fb_bound:.3f} ms bound ({fb_by}: {fb_flops:.4e} FLOPs), AdamW "
          f"{adam_ms:.3f} ms against its {ad_bound:.3f} ms bound ({ad_by}: {ad_bytes:,.0f} B) "
          f"({adam_ms / step_ms:.3f} of the step); peak device memory of a warm step {peak:,} B "
          f"({peak - base:,} B above the {base:,} B held before it); one step under the "
          f"profiler: device busy {busy * 1e3:.2f} ms, {busy * 1e3 / step_ms:.3f} of the step, "
          f"{n_dev} device activities ({n_copies} memcpy/memset) ({smi})")
    total = sum(kinds.values())
    print(f"[train] {tag}: device time of one step by kernel kind: " + ", ".join(
        f"{k} {v:.2f} ms ({v / total:.3f})" for k, v in sorted(kinds.items(),
                                                             key=lambda kv: -kv[1]))
        + "; the five longest: " + "; ".join(f"{name[:70]} {ms:.2f} ms × {n}"
                                            for name, ms, n in top)
        + ("" if other is None else
           f"; the longest of the other kinds: {other[0][:70]} {other[1]:.2f} ms × {other[2]}")
        + f" ({smi})")
    if not ok:
        raise SystemExit(f"chip_smoke: {tag}: training did not lower the loss under the gate")
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return losses, norms


def _grads(model):
    import torch

    return torch.cat([p.grad.reshape(-1).float() for p in model.parameters()])


def _train_configs_card_vs_cpu(smi):
    """Phase 11 (b): one fp32 train step of every config reduced on the card
    and on the CPU, from the same parameters and batch."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import device_batch
    from repro_torch.models import Transformer, init_params
    from repro_torch.train import AdamWConfig, TrainConfig, init_opt_state, make_train_step

    dev = torch.device("cuda")
    worst = [0.0, 0.0, 0.0]
    for arch, n_layers in [(a, None) for a in ARCHS] + [("recurrentgemma-9b", 7)]:
        cfg = get_config(arch).reduced()
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                           num_microbatches=2, compute_dtype=torch.float32)
        g = torch.Generator(device=dev).manual_seed(3)
        card = init_params(cfg, generator=g, device=dev, max_seq=32)
        cpu = Transformer(cfg, max_seq=32, device="cpu")
        cpu.load_state_dict(card.state_dict())
        batch = next(SyntheticLM(vocab=cfg.vocab, batch=4, seq_len=16, seed=1))
        if cfg.n_enc_layers:
            batch["enc_feats"] = torch.randn((4, cfg.enc_seq, cfg.d_model),
                                             generator=torch.Generator().manual_seed(2)).numpy()
        out = {}
        for name, model, d in (("card", card, dev), ("cpu", cpu, torch.device("cpu"))):
            _, _, m = make_train_step(cfg, tcfg)(model, init_opt_state(model),
                                                 device_batch(batch, d))
            out[name] = (float(m["loss"]), float(m["grad_norm"]), _grads(model).cpu())
        (l1, n1, g1), (l2, n2, g2) = out["card"], out["cpu"]
        errs = (abs(l1 - l2) / abs(l2), abs(n1 - n2) / abs(n2),
                float((g1 - g2).abs().max() / g2.abs().max()))
        worst = [max(a, b) for a, b in zip(worst, errs)]
        ok = (errs[0] <= TRAIN_CPU_REL_TOL and errs[1] <= TRAIN_CPU_REL_TOL
              and errs[2] <= TRAIN_GRAD_TOL and all(map(math.isfinite, (l1, n1))))
        print(f"[train] {cfg.name} ({cfg.n_layers} layers, {cfg.n_rem} remainder): card against "
              f"CPU, loss {l1:.6f} / {l2:.6f} (rel {errs[0]:.2e}), grad norm rel {errs[1]:.2e}, "
              f"worst grad |Δ| / max |g| {errs[2]:.2e} ({'ok' if ok else 'FAIL'})")
        if not ok:
            raise SystemExit(f"chip_smoke: {cfg.name}: the card's train step disagrees with "
                             "the CPU's")
    print(f"[train] every config reduced, card against CPU: worst loss rel {worst[0]:.2e}, "
          f"grad norm rel {worst[1]:.2e}, grad {worst[2]:.2e} (gates {TRAIN_CPU_REL_TOL:g}, "
          f"{TRAIN_CPU_REL_TOL:g}, {TRAIN_GRAD_TOL:g}) ({smi})")


def _blocked_ce(smi):
    """Phase 11 (c): the blocked loss at the full vocab against lm_loss on
    the card (loss, every grad), and the peak device memory above entry of
    each at (8, 512)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train.step import blocked_lm_loss, lm_loss

    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    model = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev,
                        max_seq=512).requires_grad_(True)
    g = torch.Generator(device=dev).manual_seed(4)

    def run(fn, B, S, **kw):
        toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=g, device=dev)
        mask = torch.ones((B, S), device=dev)
        mask[0, :3] = 0.0
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = fn(model, cfg, toks[:, :-1], toks[:, 1:], mask, compute_dtype=torch.float32,
                     remat=True, **kw)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), _grads(model), torch.cuda.max_memory_allocated() - base

    fns = {"lm_loss": lm_loss,
           "blocked": lambda *a, **kw: blocked_lm_loss(*a, ce_chunks=CE_CHUNKS, **kw)}
    # (4, 128): the values; the same tokens for both
    state = g.get_state()
    got = {}
    for name, fn in fns.items():
        g.set_state(state)
        got[name] = run(fn, 4, TRAIN_SEQ)
    (lb, gb, _), (lp, gp, _) = got["blocked"], got["lm_loss"]
    bad = int((~torch.isclose(gb, gp, rtol=CE_RTOL, atol=CE_ATOL)).sum())
    ok = abs(lb - lp) < CE_LOSS_TOL and bad == 0
    print(f"[train] blocked CE, {cfg.name} vocab {cfg.vocab} = {CE_CHUNKS} × "
          f"{cfg.vocab // CE_CHUNKS}, (4, {TRAIN_SEQ}) fp32: loss {lb:.6f} against lm_loss "
          f"{lp:.6f} (|Δ| {abs(lb - lp):.2e}, gate {CE_LOSS_TOL:g}), worst grad |Δ| "
          f"{float((gb - gp).abs().max()):.2e}, {bad} of {gb.numel():,} outside rtol {CE_RTOL:g}, "
          f"atol {CE_ATOL:g} ({'ok' if ok else 'FAIL'})")
    del gb, gp
    # (8, 512): the peaks, a warm call of each first
    peaks = {}
    for name, fn in fns.items():
        run(fn, 8, 512)
        peaks[name] = run(fn, 8, 512)[2]
    lower = peaks["blocked"] < peaks["lm_loss"]
    print(f"[train] blocked CE at (8, 512) fp32: peak device memory above entry "
          f"{peaks['blocked']:,} B against lm_loss's {peaks['lm_loss']:,} B "
          f"({peaks['blocked'] / peaks['lm_loss']:.3f}; logits alone "
          f"{8 * 512 * cfg.vocab * 4:,} B) ({'ok' if lower else 'FAIL'}) ({smi})")
    if not (ok and lower):
        raise SystemExit("chip_smoke: the blocked cross-entropy disagrees with lm_loss or "
                         "does not lower the peak")
    del model
    torch.cuda.empty_cache()


def _launch_leaves(ckpt_dir):
    """Every leaf of the latest step of a launcher's directory, on the host."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.ft import CheckpointManager
    from repro_torch.ft.checkpoint import _flatten
    from repro_torch.models import Transformer
    from repro_torch.train import init_opt_state

    model = Transformer(get_config("qwen2-0.5b").reduced(), max_seq=64, device="cpu")
    tree, extra = CheckpointManager(ckpt_dir).restore(bridge.train_tree(model,
                                                                        init_opt_state(model)))
    return {k: v.numpy() for k, v in _flatten(tree).items()}, extra


def _train_launcher(smi):
    """Phase 11 (d): the launcher on the card in subprocesses with
    deterministic algorithms: an uninterrupted 30 steps, 20 then a resume
    to 30, and a SIGTERM after step 10's log line then a resume to 30 (the
    first launches run side by side); then ``serve --ckpt-dir`` and
    ``train_lm`` in this process."""
    import signal

    import numpy as np

    from repro_torch.launch import serve, train_lm

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    t0 = time.perf_counter()
    started = []

    def launch(name, steps):
        started.append(subprocess.Popen(
            [sys.executable, "-u", "-c", DETERMINISTIC, *LAUNCH_FLAGS, "--steps", str(steps),
             "--ckpt-dir", str(work / name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT)))
        return started[-1]

    def finish(p, name):
        out, err = p.communicate(timeout=300)
        if p.returncode != 0:
            raise SystemExit(f"chip_smoke: the launcher ({name}) failed:\n{err[-3000:]}")
        return out

    try:
        procs = {"straight": launch("straight", 30), "resumed": launch("resumed", 20),
                 "sigterm": launch("sigterm", 30)}
        for line in procs["sigterm"].stdout:
            if line.startswith("step    10 "):
                procs["sigterm"].send_signal(signal.SIGTERM)
                break
        outs = {k: finish(p, k) for k, p in procs.items()}
        if "preemption requested" not in outs["sigterm"]:
            raise SystemExit("chip_smoke: the SIGTERM did not stop the launcher")
        stopped = _launch_leaves(work / "sigterm")[1]["step"]
        resumes = [launch("resumed", 30), launch("sigterm", 30)]
        outs["resumed"] = finish(resumes[0], "resumed to 30")
        outs["sigterm"] = finish(resumes[1], "resumed after SIGTERM")
        want, _ = _launch_leaves(work / "straight")
        same = {}
        for name in ("resumed", "sigterm"):
            got, extra = _launch_leaves(work / name)
            same[name] = (extra["step"] == 30 and got.keys() == want.keys() and all(
                got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want))
        last = [ln for ln in outs["straight"].splitlines() if ln.startswith("step")][-1]
        print(f"[train] launcher on the card (qwen2-0.5b reduced, deterministic algorithms): "
              f"20 → 30 resumed bitwise the uninterrupted 30 steps: {same['resumed']}; the "
              f"SIGTERM after step 10's log line committed step {stopped}, resumed to 30 "
              f"bitwise: {same['sigterm']} ({len(want)} leaves); the uninterrupted run's last "
              f"log line: {last} ({time.perf_counter() - t0:.1f} s for the five launches)")
        if not all(same.values()) or stopped < 10:
            raise SystemExit("chip_smoke: a resumed training run is not the uninterrupted one")
        ids = serve.main(["--arch", "qwen2-0.5b", "--batch", "2", "--prompt-len", "8",
                          "--new-tokens", "8", "--ckpt-dir", str(work / "sigterm")])
        if ids.shape != (2, 8) or ids.device.type != "cuda":
            raise SystemExit("chip_smoke: serve --ckpt-dir gave no ids on the card")
        t1 = time.perf_counter()
        train_lm.main(["--steps", "4", "--batch", "4", "--seq", "128", "--ckpt-dir",
                       str(work / "train_lm")])
        print(f"[train] launch.train_lm: 4 steps of qwen2-100m on the card in "
              f"{time.perf_counter() - t1:.1f} s ({smi})")
    finally:
        for p in started:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(work, ignore_errors=True)


def phase_train(smi):
    """Phase 11: LM training on one device. Returns the fp32 run's losses
    and grad norms, step by step (phase 12 (a) is held to them)."""
    import torch

    clock = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        print(f"[time] phase 11 {part}: {now - clock[0]:.1f} s")
        clock[0] = now

    runs = {}
    for cd, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        runs[name] = _train_full(smi, cd, f"{TRAIN_ARCH} {name}")
        lap(f"(a) {name}")
    _train_configs_card_vs_cpu(smi)
    lap("(b)")
    _blocked_ce(smi)
    lap("(c)")
    _train_launcher(smi)
    lap("(d)")
    return runs["fp32"]


# phase 12: sharded LM training and decode on gloo ranks sharing the card
# (NCCL puts no two ranks on one GPU). (a) phase 11's model, seed, batch and
# AdamW on (2, 2) with fsdp and the batch over data, SHARD_STEPS steps;
# loss and grad norm against phase 11's fp32 steps
SHARD_STEPS, SHARD_REL_TOL = 2, 1e-4
# (b) every config reduced on (2, 1), one fp32 step against the
# single-device step on the card: the reference's bound on parameters
SHARD_PARAM_TOL = 1e-4
# (c) greedy decode at full width on (2, 2): B prompts of P tokens, NEW
# tokens; logits within the reference's 2e-4 (rtol = atol) of the
# single-device decode, greedy ids equal
SHARD_DECODE_B, SHARD_DECODE_P, SHARD_DECODE_NEW, SHARD_LOGIT_TOL = 4, 32, 8, 2e-4
# (d) the launcher on 4 ranks at reduced qwen2-0.5b, deterministic algorithms
SHARD_LAUNCH_FLAGS = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "4", "--seq", "64",
                      "--save-every", "5", "--log-every", "1", "--mesh", "4",
                      "--deterministic"]
SHARD_JOB = "repro_torch.launch.sharded_lm:run_tasks"


def _ragged_batch(cfg, B=4, S=16, seed=1):
    """A batch whose mask holds 13, 16, 16 and 5 tokens in its rows (so a
    data rank's share of a microbatch's Σ mask is not the microbatch's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    mask = np.ones((B, S), np.float32)
    mask[0, :3], mask[3, 5:] = 0.0, 0.0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    if cfg.n_enc_layers:
        batch["enc_feats"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _sharded_full(smi, single):
    """Phase 12 (a) and (c) in one group of 4 gloo ranks."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import run_ranks

    cfg = get_config(TRAIN_ARCH)
    n = cfg.param_count()
    batch = next(SyntheticLM(vocab=cfg.vocab, batch=TRAIN_B, seq_len=TRAIN_SEQ))
    prompt = np.random.default_rng(12).integers(0, cfg.vocab, (SHARD_DECODE_B, SHARD_DECODE_P))
    t0 = time.perf_counter()
    res = run_ranks(SHARD_JOB, 4, {"tasks": [
        ("train", "train", dict(arch=TRAIN_ARCH, reduced=False, seed=0, max_seq=TRAIN_SEQ,
                                model=2, fsdp=True, nmb=TRAIN_MB,
                                opt=dict(lr=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS),
                                batch=batch, steps=SHARD_STEPS, measure=True, tensors=False)),
        ("decode", "decode", dict(arch=TRAIN_ARCH, reduced=False, seed=0,
                                  max_seq=SHARD_DECODE_P + SHARD_DECODE_NEW, model=2,
                                  prompt=prompt, new=SHARD_DECODE_NEW, single=True,
                                  greedy=False))]},
        backend="gloo", device="cuda", timeout=900)
    wall = time.perf_counter() - t0
    losses, norms = single
    worst, ok = 0.0, True
    for r in res:
        t = r["train"]
        errs = [max(abs(m["loss"] - losses[i]) / abs(losses[i]),
                    abs(m["grad_norm"] - norms[i]) / abs(norms[i]))
                for i, m in enumerate(t["metrics"])]
        worst = max(worst, *errs)
        ok = ok and max(errs) <= SHARD_REL_TOL and all(
            math.isfinite(m["loss"]) for m in t["metrics"])
        traffic = t["traffic"][-1]
        print(f"[shard] (a) rank {r['rank']}: {TRAIN_ARCH} fp32 on (2, 2), fsdp, B={TRAIN_B} × "
              f"S={TRAIN_SEQ} over data, {TRAIN_MB} microbatches, remat: losses "
              + " ".join(f"{m['loss']:.6f}" for m in t["metrics"])
              + " (phase 11: " + " ".join(f"{v:.6f}" for v in losses[:SHARD_STEPS])
              + "), grad norms " + " ".join(f"{m['grad_norm']:.6f}" for m in t["metrics"])
              + " (phase 11: " + " ".join(f"{v:.6f}" for v in norms[:SHARD_STEPS])
              + f"); ms a step (CUDA events) " + " ".join(f"{v:.1f}" for v in t["ms"])
              + f"; a step all-reduces {traffic['gathered']:,} B gathering and "
              f"{traffic['reduced']:,} B reducing; alone, one gather of every weight "
              f"{t['gather_bytes']:,} B in {t['gather_ms']:.1f} ms, one reduction of the full "
              f"grads {t['reduce_bytes']:,} B in {t['reduce_ms']:.1f} ms; placed state "
              f"{t['placed_bytes']:,} B (16 B × N / 4 = {16 * n // 4:,}); peak device memory "
              f"of the warm step {t['peak']:,} B (phase 11: 11,931,525,632 B on one device) "
              f"({smi})")
    print(f"[shard] (a) worst relative gap to phase 11's steps {worst:.2e} (gate "
          f"{SHARD_REL_TOL:g}) ({'ok' if ok else 'FAIL'}); 4 ranks in {wall:.1f} s with (c)")
    if not ok:
        raise SystemExit("chip_smoke: the sharded train step disagrees with phase 11's")
    d = res[0]["decode"]
    gaps = [float((g - w).abs().max()) for g, w in zip(d["logits"], d["single_logits"])]
    close = all(bool(((g - w).abs() <= SHARD_LOGIT_TOL * (1 + w.abs())).all())
                for g, w in zip(d["logits"], d["single_logits"]))
    same_ids = all(torch.equal(r["decode"]["ids"], d["single_ids"]) for r in res)
    kept = all(r["decode"]["placements_kept"] and r["decode"]["input_unchanged"] for r in res)
    for r in res:
        print(f"[shard] (c) rank {r['rank']}: decode ms, prefill then each step: "
              + " ".join(f"{v:.1f}" for v in r["decode"]["ms"]))
    print(f"[shard] (c) greedy decode at full width on (2, 2), B={SHARD_DECODE_B}, prompts of "
          f"{SHARD_DECODE_P}, {SHARD_DECODE_NEW} tokens: worst |Δlogit| to the single-device "
          f"decode {max(gaps):.2e} (rtol = atol = {SHARD_LOGIT_TOL:g}: "
          f"{'ok' if close else 'FAIL'}), greedy ids equal on every rank: {same_ids}, caches "
          f"kept their placements and inputs unchanged: {kept}; the single-device steps ms "
          + " ".join(f"{v:.1f}" for v in d["single_ms"]) + f" ({smi})")
    if not (close and same_ids and kept):
        raise SystemExit("chip_smoke: the sharded decode disagrees with the single-device one")
    return res[0]["train"]["placed_bytes"], res[0]["train"]["peak"]


def _sharded_configs(smi):
    """Phase 12 (b): every config reduced, one sharded fp32 step on 2 ranks
    against the single-device step on the card."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch.mesh import run_ranks

    configs = [(a, None) for a in ARCHS] + [("recurrentgemma-9b", 7)]
    tasks = []
    for arch, n_layers in configs:
        cfg = get_config(arch).reduced()
        tasks.append((f"{arch}/{n_layers}", "train", dict(
            arch=arch, n_layers=n_layers, seed=3, max_seq=32, model=1, fsdp=True,
            nmb=2, opt=dict(lr=1e-3, warmup_steps=1, total_steps=10),
            batch=_ragged_batch(cfg), steps=1, single=True)))
    res = run_ranks(SHARD_JOB, 2, {"tasks": tasks}, backend="gloo", device="cuda", timeout=900)
    worst = [0.0, 0.0]
    for name, _, _ in tasks:
        got, single = res[0][name], res[0][name]["single"]
        m, w = got["metrics"][0], single["metrics"][0]
        rel = max(abs(m[k] - w[k]) / abs(w[k]) for k in ("loss", "grad_norm"))
        dp = max(float((got["params"][k] - v).abs().max()) for k, v in single["params"].items())
        worst = [max(worst[0], rel), max(worst[1], dp)]
        same = res[1][name]["metrics"] == got["metrics"]
        ok = rel <= SHARD_REL_TOL and dp <= SHARD_PARAM_TOL and same and math.isfinite(m["loss"])
        print(f"[shard] (b) {name}: on (2, 1), fsdp, the batch over data: loss {m['loss']:.6f} / "
              f"{w['loss']:.6f}, loss and grad norm rel {rel:.2e}, worst parameter |Δ| {dp:.2e}, "
              f"the ranks' metrics equal: {same} ({'ok' if ok else 'FAIL'})")
        if not ok:
            raise SystemExit(f"chip_smoke: the sharded step of {name} disagrees with the "
                             "single-device one")
    print(f"[shard] (b) every config reduced: worst loss/norm rel {worst[0]:.2e} (gate "
          f"{SHARD_REL_TOL:g}), parameter {worst[1]:.2e} (gate {SHARD_PARAM_TOL:g}) ({smi})")


def _sharded_launcher(smi):
    """Phase 12 (d): ``launch.train --mesh 4`` on the card: 15 steps
    straight, 10 then a relaunch to 15, and a SIGTERM to rank 2 after step
    5's log line then a relaunch to 15 (the three side by side), every leaf
    bitwise the uninterrupted run's."""
    import concurrent.futures

    from repro_torch.launch.mesh import EXIT_PREEMPTED, run_ranks

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_shard_"))
    t0 = time.perf_counter()

    def launch(name, steps, signal_rank=None):
        argv = SHARD_LAUNCH_FLAGS + ["--steps", str(steps), "--ckpt-dir", str(work / name)]
        return run_ranks("repro_torch.launch.train:mesh_rank", 4, {"argv": argv},
                         backend="gloo", device="cuda", timeout=600, signal_rank=signal_rank)

    def twice(name, first_steps, signal_rank=None):
        return launch(name, first_steps, signal_rank), launch(name, 15)

    try:
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            straight = ex.submit(launch, "straight", 15)
            resumed = ex.submit(twice, "resumed", 10)
            stopped, after = ex.submit(twice, "sigterm", 15, (2, "step     5 ", 0.0)).result()
            straight, resumed = straight.result(), [resumed.result()[1], after]
        codes = [r.get("exit_code", 0) for r in stopped]
        steps = {r.get("step") for r in stopped}
        if codes != [EXIT_PREEMPTED] * 4 or len(steps) != 1:
            raise SystemExit(f"chip_smoke: SIGTERM to rank 2 gave exit codes {codes}, "
                             f"committed steps {steps}")
        want, _ = _launch_leaves(work / "straight")
        same = {}
        for name in ("resumed", "sigterm"):
            got, extra = _launch_leaves(work / name)
            same[name] = (extra["step"] == 15 and got.keys() == want.keys() and all(
                got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
                for k in want))
        last = [ln for ln in straight[0]["log"] if ln.startswith("step")][-1]
        print(f"[shard] (d) launch.train --mesh 4 on the card (qwen2-0.5b reduced, (2, 2), "
              f"deterministic): 10 → 15 bitwise the uninterrupted 15 steps: {same['resumed']}; "
              f"SIGTERM to rank 2 after step 5's log line: exit codes {codes}, every rank "
              f"committed step {steps.pop()}, resumed to 15 bitwise: {same['sigterm']} "
              f"({len(want)} leaves); the uninterrupted run's last log line: {last} "
              f"({time.perf_counter() - t0:.1f} s for the five launches) ({smi})")
        if not all(same.values()):
            raise SystemExit("chip_smoke: a resumed sharded training run is not the "
                             "uninterrupted one")
        if not all(any(ln.startswith("resumed from step") for ln in r[0]["log"])
                   for r in resumed):
            raise SystemExit("chip_smoke: a relaunch did not resume")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_sharded_lm(smi, single):
    """Phase 12: sharded LM training and decode on gloo ranks sharing the
    card; ``single`` is phase 11's fp32 (losses, grad norms). Returns rank
    0's placed-state bytes and warm-step peak of (a)."""
    clock = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        print(f"[time] phase 12 {part}: {now - clock[0]:.1f} s")
        clock[0] = now

    measured = _sharded_full(smi, single)
    lap("(a) and (c)")
    _sharded_configs(smi)
    lap("(b)")
    _sharded_launcher(smi)
    lap("(d)")
    return measured


# phase 13 (a): the quickstart leg (launch/quickstart.py) at the example's
# sizes; GLM answers against the port's fp64 IRLS, relative (PERF.md §2)
QS_GLM_REL_TOL = 1e-3


def _quickstart(smi):
    """Phase 13 (a); returns the launches per kernels-line row and the
    weighted Gaussian's measurement at the Newton systems' shape."""
    import torch

    from repro_torch.core import adaptive_padded, irls_reference
    from repro_torch.core.objectives import synthetic_logistic_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.gaussian_gram import gaussian_s_dense, gaussian_sa_ref
    from repro_torch.launch import quickstart as qs

    dev = torch.device("cuda")
    n, d, nu = qs.RIDGE["full"]
    A, y, sv = qs.ridge_problem(n, d, generator=torch.Generator(device=dev).manual_seed(
        qs.DATA_SEEDS["ridge"]))
    H64 = A.double().T @ A.double() + nu ** 2 * torch.eye(d, dtype=torch.float64, device=dev)
    x64 = torch.linalg.solve(H64, A.double().T @ y.double())
    ev = torch.linalg.eigvalsh(H64)
    kappa = float(ev[-1] / ev[0])

    def h_err(x):
        e = x.double() - x64
        return float(torch.sqrt((e @ H64 @ e) / (x64 @ H64 @ x64)))

    # the example's calls twice, a first call and a repeat (alone in a
    # process the first includes cuSOLVER's first factorization, as the
    # example's first call includes its compile); both are the path and
    # both count
    torch.cuda.synchronize()
    ops.reset_launches()
    runs = [qs.ridge_solves(A, y, nu, sv, device=dev) for _ in ("first", "repeat")]
    torch.cuda.synchronize()
    ridge = {k: v for k, v in ops.BODY_LAUNCHES.items() if v}
    ok = True
    for tag, r in zip(("first", "repeat"), runs):
        errs = {"direct": (h_err(r["x_star"]), 1), "adaptive PCG": (h_err(r["x"]), r["iters"])}
        for name, (err, k) in errs.items():
            gate = max(SOLVE_REL_TOL, FP32_UNIT * kappa * max(k, 1) ** 0.5)
            ok = ok and math.isfinite(err) and err <= gate
            print(f"[quickstart] ridge (n={n}, d={d}, ν={nu:g}) {tag} {name}: error {err:.3e} "
                  f"in the H-norm of the fp64 solve (gate {gate:.3e}, κ(H) {kappa:.3e})")
        print(f"[quickstart] ridge, {tag}: direct {r['direct_ms']:.2f} ms, CG ({qs.CG_ITERS} "
              f"iterations) {r['cg_ms']:.2f} ms rel_err {r['cg_rel_err']:.3e} (H-norm "
              f"{h_err(r['x_cg']):.3e}; not gated), adaptive PCG/SJLT "
              f"{r['adaptive_ms']:.2f} ms rel_err {r['rel_err']:.3e}, {r['iters']} iterations, "
              f"{r['doublings']} doublings, m_final {r['m_final']} (2d {2 * d}, d_e "
              f"{r['d_e']:.1f}, m_final/d_e {r['m_final'] / r['d_e']:.2f}); ms are CUDA events "
              f"around each call ({smi})")
    print(f"[quickstart] ridge: launches over both runs {ridge}")
    if not ok or max(r["m_final"] for r in runs) > 2 * d or ridge.get("_sjlt_kernel", 0) <= 0:
        raise SystemExit("chip_smoke: the quickstart's ridge leg missed its gate, its m_final "
                         "exceeds 2d, or it never launched the B = 1 SJLT")
    del H64

    B, n, d, m_max = qs.LOGISTIC["full"]
    A, Y = synthetic_logistic_batch(torch.Generator(device=dev).manual_seed(
        qs.DATA_SEEDS["logistic"]), B, n, d)
    x64 = irls_reference("logistic", A.double(), Y.double(), qs.LOGISTIC_NU, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    runs = [qs.logistic_solve(A, Y, qs.LOGISTIC_NU, m_max, device=dev)
            for _ in ("first", "repeat")]
    torch.cuda.synchronize()
    legs = {k: v for k, v in ops.LAUNCHES.items() if v}
    bodies = {k: v for k, v in ops.BODY_LAUNCHES.items() if v}
    worst = 0.0
    for tag, g in zip(("first", "repeat"), runs):
        rel = float(((g["x"].double() - x64).norm(dim=1) / x64.norm(dim=1)).max())
        worst = max(worst, rel) if math.isfinite(rel) else math.inf
        print(f"[quickstart] logistic (B={B}, n={n}, d={d}, m_max={m_max}, "
              f"ν={qs.LOGISTIC_NU}), {tag}: sketched Newton {g['newton_ms']:.2f} ms (CUDA "
              f"events), worst error to the fp64 IRLS {rel:.3e} (gate {QS_GLM_REL_TOL:g}), "
              f"converged {g['converged']}/{B}, outer iterations {g['outer_min']}-"
              f"{g['outer_max']}, max decrement {g['max_decrement']:.3e}, problem 0's m "
              f"trajectory {g['m_trajectory']} ({smi})")
    print(f"[quickstart] logistic: launches over both runs {legs}, per Pallas body {bodies}")
    weighted = ops.leg("gaussian_sa", "fp32", weighted=True)
    g = runs[-1]
    if not (worst <= QS_GLM_REL_TOL and all(r["converged"] == B for r in runs)
            and legs.get(weighted, 0) > 0):
        raise SystemExit("chip_smoke: the quickstart's logistic leg missed its gate or never "
                         "launched the weighted Gaussian leg")
    # the weighted leg at the Newton systems' shape, on their final weights
    p = torch.sigmoid(torch.einsum("bnd,bd->bn", A, g["x"]))
    w = (p * (1 - p)).contiguous()
    seeds = adaptive_padded.batch_seeds(1, B, dev)
    S_w = gaussian_s_dense(seeds, m_max, n) * torch.sqrt(w)[:, None, :]
    rec = _measure(f"gaussian_sa.weighted at the quickstart's Newton systems (B={B}, n={n}, "
                   f"d={d}, m={m_max})", lambda: ops.gaussian_sa(A, seeds, m_max, row_weights=w),
                   lambda: gaussian_sa_ref(A, seeds, m_max, scale=torch.sqrt(w)),
                   gauss_sa_terms(B, n, d, m_max, scaled=True), GAUSSIAN_REL_TOL,
                   library=lambda: torch.bmm(S_w, A))
    return {"gaussian_sa.weighted": legs[weighted], "sjlt (B = 1)": ridge["_sjlt_kernel"]}, rec


def _model_dryrun(smi, phase12):
    """Phase 13 (b): qwen2-0.5b × every shape on the single fake mesh, then
    phase 12 (a)'s configuration on a fake (2, 2) mesh beside what phase 12
    measured on the card, and the report's table of these records."""
    from repro_torch.analysis.report import dryrun_table
    from repro_torch.analysis.roofline import analyze_record
    from repro_torch.configs import SHAPES, ShapeSpec, get_config, skip_reason
    from repro_torch.launch import dryrun

    cfg = get_config(TRAIN_ARCH)
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    try:
        t0 = time.perf_counter()
        for shape in SHAPES:
            rec = dryrun.run_cell(TRAIN_ARCH, shape, "single", out, force=True)
            reason = skip_reason(cfg, shape)
            if rec["status"] != ("skipped" if reason else "ok"):
                raise SystemExit(f"chip_smoke: dry-run single/{TRAIN_ARCH}/{shape}: "
                                 f"{rec.get('error', rec['status'])}")
            if reason:
                continue
            mem, r = rec["memory"], analyze_record(rec)
            print(f"[dryrun] single (256 ranks) {TRAIN_ARCH}/{shape}: per rank arguments "
                  f"{mem['argument_size_in_bytes']:,} B, temp {mem['temp_size_in_bytes']:,} B, "
                  f"{rec['hlo_dot_flops']:.4e} dot FLOPs, {rec['collectives']['total_bytes']:,} "
                  f"B of collectives; data-sheet terms compute {r.compute_s:.4e} s, memory "
                  f"{r.memory_s:.4e} s, collective {r.collective_s:.4e} s → {r.bottleneck}; "
                  f"traced in {rec['trace_s']} s")
        sweep_s = time.perf_counter() - t0
        rec = dryrun.run_cell(TRAIN_ARCH, ShapeSpec("phase12_train", TRAIN_SEQ, TRAIN_B,
                                                    "train"), "2x2", out,
                              force_nmb=TRAIN_MB, mesh_shape=(2, 2), force=True)
        if rec["status"] != "ok":
            raise SystemExit(f"chip_smoke: dry-run of phase 12's configuration: {rec['error']}")
        mem = rec["memory"]
        placed, peak = phase12
        print(f"[dryrun] phase 12 (a)'s configuration traced on a fake (2, 2) mesh "
              f"({TRAIN_ARCH}, B={TRAIN_B} × S={TRAIN_SEQ}, {TRAIN_MB} microbatches, fsdp): "
              f"arguments {mem['argument_size_in_bytes']:,} B a rank (parameters, moments, "
              f"batch) beside phase 12's measured placed state {placed:,} B (parameters, "
              f"moments and grads); arguments + temp "
              f"{mem['argument_size_in_bytes'] + mem['temp_size_in_bytes']:,} B beside phase "
              f"12's measured warm-step peak {peak:,} B; {rec['collectives']['total_bytes']:,} "
              f"B of collectives a step; printed, not gated ({smi})")
        print(f"[dryrun] the single-mesh sweep of {TRAIN_ARCH} took {sweep_s:.1f} s on the "
              f"host; the report's table of these records:")
        print(dryrun_table(out))
    finally:
        shutil.rmtree(out, ignore_errors=True)


def phase_quickstart_dryrun(smi, phase12):
    """Phase 13: the quickstart leg on the card (a) and the model dry-run on
    the host (b). Returns (a)'s launches per kernels-line row and its
    weighted Gaussian measurement."""
    clock = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        print(f"[time] phase 13 {part}: {now - clock[0]:.1f} s")
        clock[0] = now

    launches, rec = _quickstart(smi)
    lap("(a)")
    _model_dryrun(smi, phase12)
    lap("(b)")
    return launches, rec


def main() -> int:
    import torch

    import repro_torch  # noqa: F401  (fails when run outside the checkout)

    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        print(f"[time] {name}: {now - clock[0]:.1f} s")
        clock[0] = now

    smi = phase_device()
    phase_build()
    lap("phases 1-2 (device, build)")
    rows = phase_kernels()
    lap("phase 3 (kernels against plain)")
    from repro_torch.kernels import ops

    launches = phase_main_path()
    for i, (sketch, cd) in enumerate(MODES):
        run = phase_main_path(sketch=sketch, compute_dtype=cd, traffic=MODE_TRAFFIC,
                              seed=2 + i)
        launches = {k: launches[k] + run[k] for k in launches}
    missing = [k for k, v in launches.items() if v <= 0 and k not in ops.WEIGHTED_LEGS]
    if missing:
        raise SystemExit(f"chip_smoke: kernel legs {missing} were never launched on "
                         "the main path")
    print(f"[main] launches per kernel leg over the six service runs: {launches}")
    lap("phase 4 (main path)")
    run = phase_deadlines(smi)
    launches = {k: launches[k] + run[k] for k in launches}
    print(f"[main] launches per kernel leg over phases 4 and 5: {launches}")
    lap("phase 5 (main path under deadlines)")
    run = phase_glm_path(smi)
    launches = {k: launches[k] + run[k] for k in launches}
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernel legs {missing} were never launched on "
                         "the main path")
    print(f"[main] launches per kernel leg over phases 4, 5 and 6: {launches}")
    lap("phase 6 (GLM and path traffic)")
    run = phase_ft(smi)
    launches = {k: launches[k] + run[k] for k in launches}
    print(f"[main] launches per kernel leg over phases 4 to 7: {launches}")
    lap("phase 7 (preemption, chaos and NaN isolation)")
    for r in rows:
        r["launches"] = launches[r["name"]]
    _, paper_rows = phase_paper(smi)
    lap("phase 8 (a) (paper-literal solves)")
    phase_sharded(smi)
    lap("phase 8 (b) (sharded pass and service, gloo ranks)")
    phase_nccl()
    lap("phase 8 (c) (one-rank NCCL group)")
    phase_dryrun(smi)
    lap("phase 8 (d) (pod-scale dry-run)")
    phase_audit(smi)
    lap("phase 9 (invariant audit, peak device memory)")
    probe_launches, probe_rec = phase_lm(smi)
    lap("phase 10 (LM serving and the ridge probe)")
    single = phase_train(smi)
    lap("phase 11 (LM training)")
    phase12 = phase_sharded_lm(smi, single)
    lap("phase 12 (sharded LM training and decode)")
    qs_launches, qs_rec = phase_quickstart_dryrun(smi, phase12)
    lap("phase 13 (the quickstart leg and the model dry-run)")
    for r in paper_rows:
        if r["name"] == "sjlt (B = 1)":
            r["launches"] += probe_launches["_sjlt_kernel"] + qs_launches["sjlt (B = 1)"]
            r["variants"].append(probe_rec)
            print(f"[probe] Pallas row 5 launches: {r['launches']} (phase 8 (a), the probe "
                  f"and phase 13 (a))")
    for r in rows:
        if r["name"] == "gaussian_sa.weighted":
            r["launches"] += qs_launches["gaussian_sa.weighted"]
            r["variants"].append(qs_rec)
            print(f"[quickstart] Pallas row 2 (fp32) launches: {r['launches']} (phases 4-7 "
                  f"and phase 13 (a))")
    rows += paper_rows
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
