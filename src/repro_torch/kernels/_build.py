"""Builds the CUDA kernels of ``csrc/`` with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` exports plain C launch functions, so it compiles in
seconds without PyTorch's headers. A library is built at first use into
``build/repro_torch_kernels/`` under the checkout's root (``.gitignore``
lists ``build/``), named by a hash of its source, the shared ``csrc/*.cuh``
headers and the flags, so a changed source rebuilds and an unchanged one
loads at once. A missing ``nvcc`` or a
failed build raises: there is no fallback.

``--use_fast_math`` is deliberately absent: it turns ``logf``/``cosf`` into
intrinsics that lose accuracy in the Box–Muller tail of the Gaussian sketch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of every launch function: argument types, by library
SIGNATURES = {
    "gaussian_sa": {"gaussian_sa_launch": (_P, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _P),
                    "gaussian_entry_mismatches": ()},
    "fwht": {"fwht_axis_launch": (_P, _P, _P, _I, _I, _I, _I, _LL, _I, _I, _P),
             "fwht_active_clusters": (_I, _I, _I)},
    "sjlt": {"sjlt_launch": (_P, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)},
}

_loaded: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}
# libraries compiled (one nvcc each) and opened in this process: a second
# call of an entry point must add to neither (analysis.audit.retrace)
COUNTS = {"builds": 0, "loads": 0}


def a_kind(dtype, round_bf16: bool) -> int | None:
    """The ``a_kind`` argument of gaussian_sa.cu and sjlt.cu (``AKind`` in
    csrc/a_stream.cuh):
    how the kernel reads A, by A's torch dtype and whether the pass rounds
    its operands to bf16. None for a combination the kernels do not take."""
    import torch

    return {(torch.float32, False): 0, (torch.float32, True): 1,
            (torch.bfloat16, True): 2, (torch.int8, True): 3}.get((dtype, round_bf16))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the repro_torch CUDA "
            "kernels are built from source at first use and need the CUDA toolkit")
    return found


def _flags(defines: tuple[str, ...]) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def _target(name: str, defines: tuple[str, ...] = ()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + headers + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names=tuple(SIGNATURES), defines: tuple[str, ...] = ()) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together, with the preprocessor ``defines``
    (none in the port's own builds). Returns {name: compiler output} for the
    sources compiled now (``-Xptxas=-v`` lists registers and shared memory)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
        COUNTS["builds"] += 1
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)      # atomic: a concurrent build never sees half a file
        logs[name] = log
    return logs


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built library ``name`` with its launch functions' argument types
    set (every pointer and the stream as ``c_void_p``), building it first if
    needed. The kernel wrappers load the plain build; ``defines`` gives a
    separate handle to a build with those preprocessor defines (the
    measurement builds of ``launch/anatomy.py``, whose results are wrong),
    which nothing but its caller launches."""
    key = (name, defines)
    lib = _loaded.get(key)
    if lib is None:
        build_all((name,), defines)
        lib = open_library(_target(name, defines))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[key] = lib
    return lib


def open_library(path) -> ctypes.CDLL:
    """``ctypes.CDLL(path)``, counted in ``COUNTS["loads"]``."""
    COUNTS["loads"] += 1
    return ctypes.CDLL(str(path))


def check_launch(code: int, what: str) -> None:
    """Raise if a launch function returned a nonzero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {code}")
