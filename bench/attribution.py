"""The device's idle time of a traced slice, put down to the program's spans.

The slice's device intervals come from ``torch.profiler`` on the Unix-epoch
nanosecond clock; the program's spans (``repro_torch.trace``, recorded
around the slice: ``enable()`` before it, ``take()`` after) on the host's
``perf_counter_ns``, which ``take()``'s ``epoch_offset_ns`` maps onto the
same clock. ``SpanSlice`` joins the two: each idle interval of the device
inside the slice is split, by time, among the innermost spans open on the
host during it; time with no span open is ``outside``. The innermost spans'
idle plus ``outside`` is all the slice's idle time. An "in X" share counts X
and every span beneath it.

``table()`` gives, per span name, the count, the host ms a flush (total,
and self: total less its children's) and the device idle ms a flush under
it (innermost), for standard error.
"""

from __future__ import annotations

from collections import defaultdict

OUTSIDE = "outside"


def device_intervals_ns(tr) -> list:
    """(start, end) in Unix-epoch ns of a ``bench.trace.DeviceTrace``'s
    device events, its annotations mirrored on the device left out (as
    ``DeviceTrace.events`` reads them, there relative to the first)."""
    from torch.autograd import DeviceType

    want = DeviceType.CUDA if tr.device.type == "cuda" else DeviceType.CPU
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in tr._prof.profiler.kineto_results.events()
            if e.device_type() == want and not e.is_user_annotation()]


def idle_intervals(busy, lo: int, hi: int) -> list:
    """The parts of [lo, hi] that no (start, end) of ``busy`` covers."""
    out, t = [], lo
    for s, e in sorted(busy):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def _depths(spans) -> dict:
    parent = {s.id: s.parent_id for s in spans}
    depth = {}
    for sid in parent:
        d, p = 0, parent[sid]
        while p in parent:
            d, p = d + 1, parent[p]
        depth[sid] = d
    return depth


def innermost_segments(spans) -> list:
    """(start, end, span or None) pieces of time, in order, over which the
    innermost open span (the deepest; of two, the later started) is one."""
    depth = _depths(spans)
    cuts = sorted({t for s in spans for t in (s.start_ns, s.end_ns)})
    starts = sorted(spans, key=lambda s: s.start_ns)
    out, open_, k = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(starts) and starts[k].start_ns <= a:
            open_.append(starts[k])
            k += 1
        open_ = [s for s in open_ if s.end_ns > a]
        top = max(open_, key=lambda s: (depth[s.id], s.start_ns, s.id), default=None)
        out.append((a, b, top))
    return out


def split_idle(idle, segments) -> dict:
    """Idle ns by span id (``None``: no span open), each idle interval
    split by time among the innermost spans of ``segments``."""
    out = defaultdict(int)
    k = 0
    for s, e in idle:
        covered = 0
        while k < len(segments) and segments[k][1] <= s:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < e:
            a, b, top = segments[j]
            part = min(b, e) - max(a, s)
            if part > 0 and top is not None:
                out[top.id] += part
                covered += part
            j += 1
        out[None] += (e - s) - covered
    return dict(out)


class SpanSlice:
    """A traced slice's spans and device idle time on one clock.

    ``spans``: ``repro_torch.trace.Span``s with their stamps on the
    ``perf_counter_ns`` clock; ``epoch_offset_ns`` maps them onto the
    device's; ``busy``: the device's (start, end) epoch ns; the slice is
    [lo_ns, hi_ns] on the epoch clock."""

    def __init__(self, spans, epoch_offset_ns: int, busy, lo_ns: int, hi_ns: int):
        self.spans = [s._replace(start_ns=s.start_ns + epoch_offset_ns,
                                 end_ns=s.end_ns + epoch_offset_ns) for s in spans]
        self.lo_ns, self.hi_ns = lo_ns, hi_ns
        self.window_ns = hi_ns - lo_ns
        self.idle = idle_intervals(busy, lo_ns, hi_ns)
        self.idle_by_id = split_idle(self.idle, innermost_segments(self.spans))
        by_id = {s.id: s for s in self.spans}
        self._names = {}                 # span id -> names of itself and its ancestors
        for s in self.spans:
            names, p = {s.name}, by_id.get(s.parent_id)
            while p is not None:
                names.add(p.name)
                p = by_id.get(p.parent_id)
            self._names[s.id] = names
        self._child_ns = defaultdict(int)
        for s in self.spans:
            if s.parent_id in by_id:
                self._child_ns[s.parent_id] += s.end_ns - s.start_ns

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def count(self, name: str) -> int:
        return len(self.named(name))

    def host_ns(self, name: str) -> int:
        """Host ns inside the spans ``name``."""
        return sum(s.end_ns - s.start_ns for s in self.named(name))

    def self_ns(self, name: str) -> int:
        """Host ns inside the spans ``name`` and outside their children."""
        return sum(s.end_ns - s.start_ns - self._child_ns[s.id] for s in self.named(name))

    def idle_self_ns(self, name: str | None) -> int:
        """Device idle ns while ``name`` was the innermost open span
        (``None``: while no span was open)."""
        if name is None:
            return self.idle_by_id.get(None, 0)
        return sum(self.idle_by_id.get(s.id, 0) for s in self.named(name))

    def idle_in_ns(self, name: str) -> int:
        """Device idle ns while the host was in ``name`` or a span beneath it."""
        return sum(v for sid, v in self.idle_by_id.items()
                   if sid is not None and name in self._names[sid])

    def share(self, ns: int) -> float:
        return ns / self.window_ns

    def names(self) -> list:
        return sorted({s.name for s in self.spans})

    def table(self, idle_share: float | None = None) -> list:
        """Lines for standard error: per span name, its count, host ms a
        flush (total, self) and device idle ms a flush under it, innermost;
        then ``outside`` and the shares' sum beside ``idle_share``."""
        flushes = max(1, self.count("service.flush"))
        lines = [f"spans over {flushes} flushes of the traced slice "
                 f"({self.window_ns * 1e-9} s): name, count, host ms/flush total and self, "
                 "device idle ms/flush while innermost, share of the slice"]
        total = 0.0
        for name in self.names() + [OUTSIDE]:
            key = None if name == OUTSIDE else name
            idle = self.idle_self_ns(key)
            total += self.share(idle)
            host = ("" if key is None else
                    f"{self.count(name)} {self.host_ns(name) * 1e-6 / flushes} "
                    f"{self.self_ns(name) * 1e-6 / flushes} ")
            lines.append(f"span {name}: {host}{idle * 1e-6 / flushes} {self.share(idle)}")
        lines.append(f"span idle shares + outside: {total}; device.idle_share: {idle_share}")
        return lines


def from_trace(tr, taken) -> SpanSlice:
    """The ``SpanSlice`` of a finished ``bench.trace.DeviceTrace`` and the
    ``repro_torch.trace.take()`` of the spans recorded around it. The slice
    is the trace's own: from its start stamp on the host (``perf_counter``)
    for its ``window_s``."""
    lo = round(tr._t0 * 1e9) + taken.epoch_offset_ns
    return SpanSlice(taken.spans, taken.epoch_offset_ns, device_intervals_ns(tr),
                     lo, lo + round(tr.window_s * 1e9))


def idle_in(ctx, name: str):
    """A reader's value: the device's idle share of the traced slice while
    the host was in ``name`` or beneath it; None without the program's spans
    (``ctx.spans``, a ``SpanSlice``)."""
    spans = getattr(ctx, "spans", None)
    return None if spans is None else spans.share(spans.idle_in_ns(name))
