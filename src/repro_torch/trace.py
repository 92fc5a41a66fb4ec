"""Spans of the program's layers on the host's clock.

Off by default. ``span(name, **attrs)`` then hands back one shared no-op
context manager: a call, one module-global check, no clock read and no host
read of the device. ``enable()`` turns recording on; every span that closes
while it is on is kept in memory as a ``Span`` (ids, the innermost span open
on the same thread as parent, ``time.perf_counter_ns()`` stamps, attributes).
``take()`` hands back what was kept, with the offset that maps a stamp onto
the Unix-epoch nanoseconds ``torch.profiler`` events carry, and turns
recording off again.

The spans sit at layer boundaries only (none per loop trip or kernel):

* service: ``service.submit`` (``req_id``), ``service.flush``,
  ``service.chunk`` (``cls``, ``kind``, ``req_ids``), ``service.pack``,
  ``service.sync``, ``service.answers``;
* robust driver: ``robust.attempt`` (``attempt``, 0 for the first),
  ``robust.to_host``, ``robust.fallback``;
* engine: ``engine.prepare`` (around ``ladder.sketch``, ``ladder.factor``,
  ``engine.true_gram``), ``engine.loop`` (``trips``: the trips it
  dispatched), ``engine.host_read``, ``engine.finalize``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    id: int
    parent_id: int | None    # the innermost span open on the same thread
    name: str
    start_ns: int            # time.perf_counter_ns()
    end_ns: int
    attrs: dict


class Taken(NamedTuple):
    spans: list              # Span, in the order they closed
    epoch_offset_ns: int     # + a stamp = Unix-epoch ns (the profiler's clock)


_ON = False
_SPANS: list[Span] = []
_OFFSET_NS = 0
_IDS = itertools.count(1)
_OPEN = threading.local()    # .stack: ids of this thread's open spans


class _Off:
    """The span handed out while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


class _Recording:
    __slots__ = ("name", "attrs", "id", "parent", "start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _OPEN.stack.pop()
        if _ON:
            _SPANS.append(Span(self.id, self.parent, self.name, self.start, end, self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Attributes known only once the span's work is done."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager around one layer's work; ``as sp`` gives ``sp.set``."""
    if not _ON:
        return OFF
    return _Recording(name, attrs)


def enable() -> None:
    """Record spans from now on, and take the epoch offset for ``take``."""
    global _ON, _OFFSET_NS
    _OFFSET_NS = time.time_ns() - time.perf_counter_ns()
    _SPANS.clear()
    _ON = True


def take() -> Taken:
    """The spans that closed since ``enable()``, and the epoch offset;
    recording stops (a span still open then is not kept)."""
    global _ON
    _ON = False
    spans = list(_SPANS)
    _SPANS.clear()
    return Taken(spans, _OFFSET_NS)
