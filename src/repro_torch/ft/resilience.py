"""Elastic re-meshing plans, preemption handling, straggler detection and
a restartable step loop.

Port of ``repro.ft.resilience``: the mechanisms are the reference's,
unit-tested on the CPU. An elastic plan is made on an abstract mesh, a
shape and its axis names with no devices, so the controller can plan
before the new set of ranks is up; ``launch.mesh.make_elastic_mesh``
realizes the same shape as a ``DeviceMesh`` at restart.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import statistics
import time
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, with no devices (the counterpart of
    ``jax.sharding.AbstractMesh``)."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


@dataclasses.dataclass
class ElasticPlan:
    n_devices: int
    mesh: AbstractMesh
    per_device_batch: int
    num_microbatches: int


def plan_mesh_shape(n_devices: int) -> tuple[int, int]:
    """(data, model) for any live-device count: model = 16 when it divides,
    else the largest power-of-two divisor ≤ 16."""
    model = 1
    for cand in (16, 8, 4, 2):
        if n_devices % cand == 0:
            model = cand
            break
    return n_devices // model, model


def plan_elastic(global_batch: int, n_live_devices: int,
                 target_microbatch: int = 32) -> ElasticPlan:
    """The largest usable mesh for the live-device count and a batch plan
    that keeps the global batch. The data axis shrinks to the largest
    divisor of the global batch that fits; devices left over idle as hot
    spares."""
    data, model = plan_mesh_shape(n_live_devices)
    while global_batch % data:
        data -= 1
    mesh = AbstractMesh((data, model), ("data", "model"))
    nmb = max(1, global_batch // target_microbatch)
    while global_batch % nmb:
        nmb -= 1
    return ElasticPlan(n_devices=mesh.size, mesh=mesh,
                       per_device_batch=global_batch // data, num_microbatches=nmb)


class StragglerWatchdog:
    """Tracks per-step (or per-host heartbeat) durations and flags outliers.

    A step is a straggler event if it takes more than ``factor`` × the
    running median over the last ``window`` steps (once five are known); a
    host is flagged, once, after ``patience`` consecutive events, and
    ``on_flag(host, duration)`` is called. A normal step resets the count.
    """

    def __init__(self, window: int = 50, factor: float = 2.0,
                 patience: int = 3,
                 on_flag: Optional[Callable[[str, float], None]] = None):
        self.window = window
        self.factor = factor
        self.patience = patience
        self.on_flag = on_flag or (lambda host, t: None)
        self._times: list[float] = []
        self._consecutive: dict[str, int] = {}
        self.flagged: list[str] = []

    def median(self) -> Optional[float]:
        return statistics.median(self._times) if self._times else None

    def record(self, duration_s: float, host: str = "host0") -> bool:
        """Returns True if this step was a straggler event."""
        med = self.median()
        self._times.append(duration_s)
        if len(self._times) > self.window:
            self._times.pop(0)
        if med is None or len(self._times) < 5:
            return False
        if duration_s > self.factor * med:
            c = self._consecutive.get(host, 0) + 1
            self._consecutive[host] = c
            if c >= self.patience and host not in self.flagged:
                self.flagged.append(host)
                self.on_flag(host, duration_s)
            return True
        self._consecutive[host] = 0
        return False


class PreemptionHandler:
    """A context manager that installs a handler for ``signals`` (SIGTERM by
    default) which only raises a flag; the loop it guards polls
    ``should_stop`` between steps (the solver between segments), saves and
    exits. The previous handlers come back on exit."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = False
        self._signals = signals
        self._old = {}

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop


def run_with_restarts(step_fn, n_steps: int, ckpt, state, *, save_every: int,
                      start_step: int = 0, watchdog: StragglerWatchdog | None = None,
                      preempt: PreemptionHandler | None = None):
    """Drive ``state = step_fn(state)`` to ``n_steps`` with a background
    checkpoint every ``save_every`` steps, straggler tracking, and on
    preemption a blocking save of the current step before leaving the loop.
    Returns (state, last step)."""
    step = start_step
    while step < n_steps:
        t0 = time.perf_counter()
        state = step_fn(state)
        dt = time.perf_counter() - t0
        step += 1
        if watchdog is not None:
            watchdog.record(dt)
        if step % save_every == 0:
            ckpt.save(step, state, blocking=False)
        if preempt is not None and preempt.should_stop:
            ckpt.wait()
            ckpt.save(step, state, blocking=True)
            break
    ckpt.wait()
    return state, step
