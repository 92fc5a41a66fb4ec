"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means ``cuda``. A machine
with no CUDA device raises instead of carrying on on the CPU; the CPU runs
only when a caller asks for it with ``device="cpu"`` (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise. Raises if that is a CUDA device and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on cuda by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def require_on(dev: torch.device, **tensors) -> None:
    """Raise unless every given tensor lies on ``dev`` (no silent copies)."""
    for name, t in tensors.items():
        if t is not None and t.device.type != dev.type:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")


def check_fp32_matmul() -> None:
    """The engine computes in full fp32, as the JAX reference does; it must
    not depend on a process-wide switch to TF32."""
    prec = torch.get_float32_matmul_precision()
    if prec != "highest":
        raise RuntimeError(
            "repro_torch needs full-fp32 matmuls, but "
            f"torch.get_float32_matmul_precision() is {prec!r}; call "
            "torch.set_float32_matmul_precision('highest')")
