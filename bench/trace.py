"""The device trace of a traced slice, reduced to what the metrics read.

``DeviceTrace`` runs ``torch.profiler`` around a slice of the timed loop,
recording the device's activities (kernels, copies, fills) alone: host ops
would slow the host, and this system's device waits on its host.
``summarize`` reads:

* busy seconds: the union of the device's intervals in the slice, so that
  two kernels that overlap count once;
* the seconds of each kernel's launches, by name;
* the device operations that took most time, and the device's idle gaps,
  each named by the operation that ended it (what the device waited for).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import torch


@dataclasses.dataclass
class TraceSummary:
    window_s: float            # the slice, by the host's clock
    busy_s: float              # union of device intervals in the slice
    kernels: dict              # kernel name -> list of seconds, one per launch
    device_ops: list           # [[name, seconds], ...], most time first, ≤ 10
    idle_gaps: list            # [["before <op>", seconds], ...], most first, ≤ 10


def union_seconds(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_before(events) -> dict:
    """Idle seconds between the device's intervals, summed by the name of
    the operation that ended each gap. ``events``: (start, end, name)."""
    out, t = defaultdict(float), None
    for s, e, name in sorted(events):
        if t is not None and s > t:
            out[f"before {name}"] += s - t
        t = e if t is None else max(t, e)
    return dict(out)


def _top(pairs: dict, k: int = 10) -> list:
    """The k largest, most first; a C++ kernel name cut to 200 characters."""
    return [[name[:200], s] for name, s in sorted(pairs.items(), key=lambda p: -p[1])[:k]]


class DeviceTrace:
    """Context manager: profile the device's activities inside it; the
    slice's length is the host clock's."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts = [ProfilerActivity.CUDA]
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False

    def events(self) -> list:
        """The device's events, (start, end, name) in seconds from the
        first; the host's annotations, mirrored on the device, left out.
        (On the CPU, where there is no device, the host's ops.)"""
        from torch.autograd import DeviceType

        want = DeviceType.CUDA if self.device.type == "cuda" else DeviceType.CPU
        raw = [e for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == want and not e.is_user_annotation()]
        base = min((e.start_ns() for e in raw), default=0)   # keeps ns resolution
        return [((e.start_ns() - base) * 1e-9, (e.start_ns() - base + e.duration_ns()) * 1e-9,
                 e.name()) for e in raw]


def summarize(tr: DeviceTrace) -> TraceSummary:
    """Busy time, kernel times, the top device ops and the idle gaps of a
    traced slice."""
    dev = tr.events()
    kernels, per_op = defaultdict(list), defaultdict(float)
    for s, e, n in dev:
        kernels[n].append(e - s)
        per_op[n] += e - s
    return TraceSummary(window_s=tr.window_s, busy_s=union_seconds([(s, e) for s, e, _ in dev]),
                        kernels=dict(kernels), device_ops=_top(per_op),
                        idle_gaps=_top(idle_before(dev)))
