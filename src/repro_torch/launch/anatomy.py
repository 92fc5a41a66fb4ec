"""What bounds the Gaussian sketch→SA and FWHT kernels, measured on the card.

    PYTHONPATH=src python -m repro_torch.launch.anatomy [--reps 10]

Times each compute-dtype leg at the main path's shape beside builds of the
same kernel with one piece left out (``GS_OMIT`` / ``FWHT_OMIT``, defined
only in these measurement builds; their results are wrong and are not
looked at). Each build is a library of its own, loaded by its own handle
(``_build.load(name, defines)``) and launched here through its C launch
function, so the port's wrappers never reach it; the plain build is
launched the same way, and its result is held bitwise against the wrapper's
first. Whatever a leg still costs without a piece is what the other pieces
cost together, so the variants show which piece the time follows:

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

Each leg's builds are timed in turns (full, variants, variants reversed,
full; CUDA events, median of ``--reps`` launches after two warm-up ones) and
the medians of the two turns are printed, one JSON line per leg, with the
card's name and power limit.
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
from repro_torch.kernels.gaussian_gram import gaussian_sa_cuda

GAUSSIAN_VARIANTS = {"no-generation": ("GS_OMIT=1",), "no-contraction": ("GS_OMIT=2",),
                     "no-A": ("GS_OMIT=3",)}
FWHT_VARIANTS = {"no-adds": ("FWHT_OMIT=1",)}


def _time_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
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
        times[k].append(_time_ms(fns[k], reps))
    return {k: sum(v) / len(v) for k, v in times.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
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
    for leg, (A_in, scale, cd) in legs.items():
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
    for leg, (X_in, scale, cd) in legs.items():
        tile = torch.float32 if cd is None else torch.bfloat16
        want, launches = kf.fwht_passes_cuda(X_in, scale, compute_dtype=cd)
        assert launches == 1
        ms = _in_turns("fwht", FWHT_VARIANTS,
                       lambda lib: _fwht(lib, X_in, scale.to(tile), tile), want, args.reps,
                       extra={"copy": lambda: Y.copy_(X)})
        print(json.dumps({"leg": leg, "shape": [B, n, d], "card": card, "ms": ms}))


if __name__ == "__main__":
    main()
