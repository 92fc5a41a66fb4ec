"""The state carried between the JAX reference and the port.

The system has no weights: its state is the problem data and the sketch
randomness. These helpers turn numpy arrays (what ``np.asarray`` gives for
the reference's arrays) into the port's tensors on an explicit device, and
the port's results back into numpy, so the two packages can be run on the
same inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.quadratic import Quadratic
from .device import resolve_device


def _tensor(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=dev)


def quadratic_from_numpy(A, b, nu, lam_diag, row_weights=None, *,
                         device=None) -> Quadratic:
    """A batched ``Quadratic`` from numpy arrays: A (B, n, d) or shared
    (n, d), b (B, d), ν (B,), Λ (B, d), optional row weights (B, n)."""
    dev = resolve_device(device)
    f32 = torch.float32
    return Quadratic(
        A=_tensor(A, f32, dev), b=_tensor(b, f32, dev), nu=_tensor(nu, f32, dev),
        lam_diag=_tensor(lam_diag, f32, dev), batched=True,
        row_weights=None if row_weights is None else _tensor(row_weights, f32, dev))


def sample_from_numpy(sample: dict, *, device=None) -> dict:
    """A provider's sample dict from numpy: ``seeds`` (B,) uint32 → int64,
    the SRHT's ``signs`` (B, n) → fp32 and ``rows`` (B, m_max) → int64, or
    the SJLT's ``u`` (B, n) → fp32 and ``signs``."""
    dev = resolve_device(device)
    out = {}
    for k, v in sample.items():
        v = np.asarray(v)
        if k == "seeds":
            out[k] = _tensor(v.astype(np.uint32).astype(np.int64), torch.int64, dev)
        elif k == "rows":
            out[k] = _tensor(v.astype(np.int64), torch.int64, dev)
        elif k in ("signs", "u"):
            out[k] = _tensor(v, torch.float32, dev)
        else:
            raise ValueError(f"unknown sample field {k!r}")
    return out


def to_numpy(obj):
    """Tensors → numpy, recursively through dicts, lists, tuples and
    dataclasses (e.g. a ``RidgeSolution``, as a dict of fields)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(to_numpy(v) for v in obj)
    return obj
