"""What bounds the Gaussian sketch→SA, FWHT and SJLT kernels, measured on the card.

    PYTHONPATH=src python -m repro_torch.launch.anatomy [--reps 10] [--legs gaussian,fwht,sjlt]
    PYTHONPATH=<checkout>/src python src/repro_torch/launch/anatomy.py --legs sjlt-calls

Times each compute-dtype leg at the main path's shape beside builds of the
same kernel with one piece left out (``GS_OMIT`` / ``FWHT_OMIT`` /
``SJLT_OMIT``, defined only in these measurement builds; their results are
wrong and are not looked at). Each build is a library of its own, loaded by
its own handle (``_build.load(name, defines)``) and launched here through
its C launch function, so the port's wrappers never reach it; the plain
build is launched the same way, and its result is held bitwise against the
wrapper's first. Whatever a leg still costs without a piece is what the
other pieces cost together, so the variants show which piece the time
follows:

* Gaussian (B=16, n=4096, d=256, m=512; fp32 A, bf16 mode rounding it, and
  int8 codes with their row scales): ``no-generation`` draws no S (a
  constant stands in), ``no-contraction`` skips the FMA loop (fp32 leg: all
  but one of each step's 16 rows) or the wgmma (its fragment folds into one
  accumulator register instead), ``no-A`` reads no A. At this shape the
  grid is 128 blocks, one an SM in every build, so leaving a piece out
  cannot change the blocks an SM holds.
* FWHT (B=16, n=16384, d=256, SRHT signs fused; fp32, bf16 from fp32 input,
  bf16 from int8 codes): ``no-adds`` runs no butterfly, so the kernel only
  moves the data in its access pattern; ``copy`` is ``torch.Tensor.copy_``
  of the fp32 input, the same bytes read and written contiguously.
* SJLT (B=16, n=4096, d=256, M=512 with per-problem fp32 A, and B=1 with
  shared A): ``bucket`` runs the bucket pass alone; ``bucket-launch`` and
  ``bucket-scan`` stop its blocks at once and after their scan;
  ``segment`` runs the segment sum alone, on the buckets the plain build
  left in the workspace.

Each leg's builds are timed in turns (full, variants, variants reversed,
full; CUDA events, median of ``--reps`` launches after two warm-up ones, the
card kept busy while the host enqueues each launch, so only its time counts) and
the means of the two turns' medians are printed, one JSON line per leg,
with the card's name and power limit.

``sjlt-calls`` times the wrapper instead: one ``sjlt_launch`` call on the
stream ``fold_stream`` prepares, for each SJLT leg of ``chip_smoke.py``'s
kernels line, as ``card_ms`` (host enqueue hidden) and ``call_ms`` (the
card waits for the host, so the wrapper's host time counts: what
``chip_smoke.py`` reports as ``ms``), medians of ``--reps``. It uses only
those two functions, which every version of the port has, so run as a file
with ``PYTHONPATH`` at another checkout's ``src`` it times that version:
two versions compare in turns on one card in one call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.dist.compress import quantize_rows
from repro_torch.kernels import _build
from repro_torch.kernels import fwht as kf
from repro_torch.kernels import sjlt as ksj
from repro_torch.kernels.gaussian_gram import gaussian_sa_cuda

GAUSSIAN_VARIANTS = {"no-generation": ("GS_OMIT=1",), "no-contraction": ("GS_OMIT=2",),
                     "no-A": ("GS_OMIT=3",)}
FWHT_VARIANTS = {"no-adds": ("FWHT_OMIT=1",)}
SJLT_VARIANTS = {"bucket": ("SJLT_OMIT=1",), "bucket-launch": ("SJLT_OMIT=2",),
                 "bucket-scan": ("SJLT_OMIT=3",), "segment": ("SJLT_OMIT=4",)}
SLEEP_CYCLES = 4_000_000     # the card spins about 2 ms while the host enqueues a launch


def time_ms(fn, reps: int, warm: int = 2, hide_host: bool = False) -> float:
    """Median time of one call on the card, by CUDA events around each call
    after ``warm`` calls. The card waits for the host, so the call's host
    time counts, unless ``hide_host``: then the card spins
    (``torch.cuda._sleep``) before the start event while the host enqueues
    the call, and only the card's time counts."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if hide_host:
            torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _gaussian(lib, A, seeds, m, scale, kind):
    """(launch, out): ``lib``'s gaussian_sa_launch on per-problem A, as
    ``gaussian_sa_cuda`` calls it."""
    B, n, d = A.shape
    out = torch.empty((B, m, d), dtype=torch.float32, device=A.device)
    args = (A.data_ptr(), n * d, seeds.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            B, n, d, m, kind, torch.cuda.current_stream().cuda_stream)
    return lambda: _build.check_launch(lib.gaussian_sa_launch(*args), "gaussian_sa"), out


def _fwht(lib, X, scale, tile):
    """(launch, out): ``lib``'s fwht_axis_launch, the one pass of
    ``fwht_passes_cuda`` on a (B, n, d) stack with the row scale fused."""
    B, n, d = X.shape
    (a, L, c), = kf.pass_shapes(n, d)
    out = torch.empty((B, n, d), dtype=tile, device=X.device)
    args = (X.data_ptr(), out.data_ptr(), scale.data_ptr(), B, a, L, c, n * d,
            kf._IN_KIND[X.dtype], int(tile == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    return lambda: _build.check_launch(lib.fwht_axis_launch(*args), "fwht"), out


def _sjlt(lib, A, rows, signs, m, kind, ws):
    """(launch, out): ``lib``'s sjlt_launch as ``sjlt_launch`` calls it,
    with the workspace ``ws``, which every build shares."""
    B, n = rows.shape
    d = A.shape[-1]
    out = torch.empty((B, m, d), dtype=torch.float32, device=A.device)
    args = (A.data_ptr(), 0 if A.dim() == 2 else n * d, rows.data_ptr(), signs.data_ptr(),
            out.data_ptr(), ws.data_ptr(), B, n, d, m, ksj.bucket_chunk(B, n, m), kind,
            torch.cuda.current_stream().cuda_stream)
    return lambda: _build.check_launch(lib.sjlt_launch(*args), "sjlt"), out


def _in_turns(library: str, variants: dict[str, tuple[str, ...]], make, want, reps: int,
              extra: dict | None = None) -> dict[str, float]:
    """{build: ms} for the plain build and each variant, each timed twice in
    the order plain, variants, variants reversed, plain (the mean of its two
    medians); ``make(lib)`` gives a build's (launch, out), and the plain
    build's out must equal ``want`` bitwise; ``extra`` adds callables timed
    the same way."""
    launch, out = make(_build.load(library))
    launch()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise SystemExit(f"anatomy: the direct {library} launch differs from its wrapper")
    fns = {"full": launch, **{k: make(_build.load(library, v))[0] for k, v in variants.items()},
           **(extra or {})}
    order = list(fns)
    times: dict[str, list[float]] = {k: [] for k in order}
    for k in order + order[::-1]:
        times[k].append(time_ms(fns[k], reps, hide_host=True))
    return {k: sum(v) / len(v) for k, v in times.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--legs", default="gaussian,fwht,sjlt",
                   help="comma-separated: gaussian, fwht, sjlt (kernels to take "
                        "apart), sjlt-calls (the SJLT wrapper's legs)")
    args = p.parse_args(argv)
    kernels = set(args.legs.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("anatomy: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    B, n, d, m = 16, 4096, 256, 512
    A = torch.randn((B, n, d), generator=g, device=dev) / n ** 0.5
    seeds = torch.randint(0, 2 ** 32, (B,), generator=g, device=dev, dtype=torch.int64)
    codes, a_scales = quantize_rows(A)
    legs = {   # (A, column scale, compute dtype)
        "gaussian_sa": (A, None, None),
        "gaussian_sa.bf16": (A, None, "bf16"),
        "gaussian_sa.int8": (codes, a_scales, "int8"),
    }
    for leg, (A_in, scale, cd) in legs.items() if "gaussian" in kernels else ():
        kind = _build.a_kind(A_in.dtype, cd is not None)
        want = gaussian_sa_cuda(A_in, seeds, m, scale=scale, compute_dtype=cd)
        ms = _in_turns("gaussian_sa", GAUSSIAN_VARIANTS,
                       lambda lib: _gaussian(lib, A_in, seeds, m, scale, kind), want, args.reps)
        print(json.dumps({"leg": leg, "shape": [B, n, d, m], "card": card, "ms": ms}))
    del A, codes, a_scales

    B, n, d = 16, 16384, 256
    X = torch.randn((B, n, d), generator=g, device=dev)
    s = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    codes, a_scales = quantize_rows(X)
    Y = torch.empty_like(X)
    legs = {   # (X, row scale, compute dtype)
        "fwht": (X, s, None),
        "fwht.bf16": (X, s, "bf16"),
        "fwht.int8": (codes, s * a_scales, "int8"),
    }
    for leg, (X_in, scale, cd) in legs.items() if "fwht" in kernels else ():
        tile = torch.float32 if cd is None else torch.bfloat16
        want, launches = kf.fwht_passes_cuda(X_in, scale, compute_dtype=cd)
        assert launches == 1
        ms = _in_turns("fwht", FWHT_VARIANTS,
                       lambda lib: _fwht(lib, X_in, scale.to(tile), tile), want, args.reps,
                       extra={"copy": lambda: Y.copy_(X)})
        print(json.dumps({"leg": leg, "shape": [B, n, d], "card": card, "ms": ms}))
    del X, codes, a_scales, Y

    B, n, d, M = 16, 4096, 256, 512
    A = torch.randn((B, n, d), generator=g, device=dev) / n ** 0.5
    A_sh = torch.randn((n, d), generator=g, device=dev) / n ** 0.5
    tgt = torch.randint(0, M, (B, n), generator=g, device=dev, dtype=torch.int32)
    sg = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    legs = {"sjlt": (A, tgt, sg), "sjlt single problem": (A_sh, tgt[:1], sg[:1])}
    for leg, (A_in, t_, s_) in legs.items() if "sjlt" in kernels else ():
        Bq = t_.shape[0]
        ws = torch.empty(ksj.workspace_ints(Bq, n, M, ksj.bucket_chunk(Bq, n, M)),
                         dtype=torch.int32, device=dev)
        want = ksj.sjlt_launch(A_in, t_, s_, M)
        ms = _in_turns("sjlt", SJLT_VARIANTS,
                       lambda lib: _sjlt(lib, A_in, t_, s_, M, 0, ws), want, args.reps)
        print(json.dumps({"leg": leg, "shape": [Bq, n, d, M], "card": card, "ms": ms}))

    legs = {   # chip_smoke.py's SJLT legs: (A, targets, signs, compute dtype)
        "sjlt": (A, tgt, sg, "fp32"), "sjlt shared A": (A_sh, tgt, sg, "fp32"),
        "sjlt single problem": (A_sh, tgt[:1], sg[:1], "fp32"),
        "sjlt.bf16": (A, tgt, sg, "bf16"),
        "sjlt.bf16 (bf16 A)": (A.to(torch.bfloat16), tgt, sg, "bf16"),
        "sjlt.bf16 single problem": (A_sh, tgt[:1], sg[:1], "bf16"),
        "sjlt.int8": (A, tgt, sg, "int8"),
        "sjlt.int8 single problem": (A_sh, tgt[:1], sg[:1], "int8"),
    }
    for leg, (A_in, t_, s_, cd) in legs.items() if "sjlt-calls" in kernels else ():
        A_s, s_s = ksj.fold_stream(A_in, s_, cd)
        fn = lambda: ksj.sjlt_launch(A_s, t_, s_s, M, compute_dtype=cd)  # noqa: E731
        print(json.dumps({"leg": leg, "card_ms": time_ms(fn, args.reps, hide_host=True),
                          "call_ms": time_ms(fn, args.reps), "card": card}), flush=True)

if __name__ == "__main__":
    main()
