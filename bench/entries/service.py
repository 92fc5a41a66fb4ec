"""Entry ``service``: the ridge solver service, driven by one caller.

Requests are the next ones of the pool (``streams.order``: each pass in a
new order), each submitted under a new request id so that each draws its
own sketch. A step submits up to the mix's ``requests_per_flush`` of them,
calls ``flush`` and waits for the device. Two loops:

* without ``rate`` in the mix, saturating: the caller always has the next
  ``requests_per_flush`` ready, as an open loop above capacity would; a
  request's latency runs from the start of its ``submit`` to its flush's
  return;
* with ``rate`` (requests/s), open: arrivals are a Poisson process drawn
  from the seed, starting with the window; a step submits what has arrived
  (waiting for the first arrival if none has), and a request's latency runs
  from its arrival, so a caller that falls behind shows in the tail.
  ``drain`` ends the window by answering every arrival up to its close.

The configuration's ``service`` holds the ``SolverService`` arguments;
``shape_classes`` is ``"default"`` (the port's ``DEFAULT_SHAPE_CLASSES``)
or a list of [n, d, m_max, sketch] classes.
"""

from __future__ import annotations

import time
from collections import deque

import torch
from torch.profiler import record_function

from bench import check, manifest, streams

CERTIFIED = ("OK", "RETRIED")


class Run:
    def __init__(self, cell, seed: int, device):
        from repro_torch.serve.solver_service import (
            DEFAULT_SHAPE_CLASSES,
            ShapeClass,
            SolverService,
        )

        self.device = torch.device(device)
        spec = {**cell.config.get("problem", {}), **cell.traffic}
        t = time.perf_counter()
        generate = manifest.generator(cell.traffic["generator"], cell.root)
        self.pool = generate(spec, seed, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.pool_s = time.perf_counter() - t
        kw = dict(cell.config["service"])
        classes = kw.pop("shape_classes")
        classes = (DEFAULT_SHAPE_CLASSES if classes == "default"
                   else [ShapeClass(*c) for c in classes])
        self.svc = SolverService(classes, seed=seed & 0xFFFFFFFF, device=self.device, **kw)
        self.per_flush = int(cell.traffic["requests_per_flush"])
        self.order = streams.order(len(self.pool), seed)
        self.rate = cell.traffic.get("rate")
        if self.rate is not None:
            self.arrivals = streams.poisson(float(self.rate), seed)
            self.next_arrival = None      # absolute time, set when the window starts
            self.closed = False           # drain admits no more arrivals
            self.queue = deque()          # (arrival time, pool index)
        self.window = True            # the harness clears it for the traced slice
        self.attempted = 0
        self.answers: list[check.Answer] = []
        self.records = {"latencies_s": [], "submit_s": [], "wait_s": [], "fill": [],
                        "iters": [], "m_final": [], "classes": set()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _admit(self, now: float) -> None:
        while self.next_arrival <= now:
            self.queue.append((self.next_arrival, next(self.order)))
            self.next_arrival += next(self.arrivals)

    def _due(self, record: bool):
        """(pool indices, arrival times or None) of the next flush."""
        if self.rate is None or not record:     # the warm step is a full batch too
            return [next(self.order) for _ in range(self.per_flush)], None
        now = time.perf_counter()
        if self.next_arrival is None:
            self.next_arrival = now + next(self.arrivals)
        if not self.closed:
            self._admit(now)
        if not self.queue:
            time.sleep(max(0.0, self.next_arrival - now))
            self._admit(max(now, self.next_arrival))
        batch = [self.queue.popleft() for _ in range(min(self.per_flush, len(self.queue)))]
        return [i for _, i in batch], [t for t, _ in batch]

    def drain(self) -> None:
        """Answer every request that arrived before now and admit no more;
        the next step starts the arrivals anew (open loop only)."""
        if self.rate is None:
            return
        self._admit(time.perf_counter())
        self.closed = True
        while self.queue:
            self.step()
        self.closed, self.next_arrival = False, None

    def step(self, record: bool = True) -> None:
        idx, arrived = self._due(record)
        starts, ids = [], []
        with record_function("bench.submit"):
            for i in idx:
                starts.append(time.perf_counter())
                ids.append(self.svc.submit(self.pool.A[i], self.pool.y[i], self.pool.nu[i]))
        t_sub = time.perf_counter()
        with record_function("bench.flush"):
            sols = self.svc.flush()
            self._sync()
        t_end = time.perf_counter()
        if not record:
            return
        self.attempted += len(idx)
        rec = self.records
        since = starts if arrived is None else arrived
        if self.window:
            rec["submit_s"].append(t_sub - starts[0])
            rec["fill"].append(len(idx))
            rec["wait_s"].extend(t - a for t, a in zip(starts, since))
        for i, rid, t in zip(idx, ids, since):
            s = sols.get(rid)
            if s is None:
                continue
            self.answers.append(check.Answer(i, s.x, s.status in CERTIFIED, self.window))
            if self.window:
                rec["latencies_s"].append(t_end - t)
                rec["iters"].append(s.iters)
                rec["m_final"].append(s.m_final)
                rec["classes"].add(s.shape_class)
        if self.window and len(rec["classes"]) == 1:
            (c,) = rec["classes"]
            rec["gaussian_sa_shape"] = ((self.svc.batch_size, c.n, c.d, c.m_max)
                                        if (c.sketch or self.svc.sketch) == "gaussian" else None)

    def counters(self) -> dict:
        return dict(self.svc.stats)

    def release(self) -> None:
        """Free the program's state; the pool and the answers stay."""
        del self.svc


def setup(cell, seed: int, device) -> Run:
    return Run(cell, seed, device)
