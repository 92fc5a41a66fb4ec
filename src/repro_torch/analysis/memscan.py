"""Memory scans: the op-trace shape helpers, and peak device memory.

Counterpart of ``repro.analysis.memscan``: the new-tensor scans live in
``analysis.audit.op_trace`` (one recorder for the auditor, the smoke script
and the tests) and are re-exported here. On the card the one-touch claim is
also a claim in bytes: ``peak_bytes_above_entry`` is what a call allocates
above what was allocated when it started.
"""

from __future__ import annotations

from typing import Callable

import torch

from .audit.op_trace import (  # noqa: F401
    count_a_consumers,
    find_new_tensors,
    max_new_tensor_bytes,
)


def peak_bytes_above_entry(fn: Callable[[], object], device=None) -> tuple[int, object]:
    """(peak bytes allocated above the entry's, ``fn()``'s result) of one
    call on a CUDA ``device`` (default the current card):
    ``torch.cuda.reset_peak_memory_stats``, then ``max_memory_allocated −
    memory_allocated`` at entry. There is no such count for the CPU, so a
    CPU device raises rather than read 0."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"peak device memory is measured on a CUDA device, not {dev}")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    entry = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - entry, out
