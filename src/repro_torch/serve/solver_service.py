"""Ridge-solve serving on top of the batched padded engine.

Port of the ridge half of ``repro.serve.solver_service``. The service

1. **buckets** each request into the smallest fixed (n, d, m_max) shape
   class that fits; A is zero-padded to (n_c, d_c) with Λ = 1 on padded
   coordinates, which block-diagonalizes H so the padded solution restricted
   to the request's coordinates is exactly its solution;
2. **packs** up to ``batch_size`` requests per class into one batched
   ``Quadratic`` staged on the device (short batches are padded with b = 0
   problems that converge at initialization);
3. **solves** each batch with the retry/fallback driver over the padded
   engine (``core.robust``), with the class's sketch family;
4. **returns** per-request solutions with their certificates (δ̃, m_final,
   iterations, doublings, status).

Deadlines: a request may carry its own (``submit(deadline_s=…)``) and a
flush a budget for all of it (``flush(deadline_s=…)`` or the service's
``flush_deadline_s``). Chunks dispatch earliest-deadline-first; a chunk
whose budget is spent before it starts expires without a solve, and one
that runs out mid-solve returns its unfinished requests as
``DEADLINE_EXCEEDED`` with their best iterates, through the segmented
driver (``segment_trips`` trips a segment).

Per-slot seeds come from ``_slot_seeds``: a fold of the service seed with
the slot id (a real slot's request id; padded slots the reserved ids
2³²−1−slot), so a request's sketch does not depend on what it is packed
with. Not ported yet: path traffic and the ladder cache (ROADMAP queue 1
item 5), GLM traffic (item 6), checkpoints and preemption (item 7) and
sharding (item 8).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Iterable, NamedTuple

import torch

from repro_torch.core.level_grams import fold_seeds
from repro_torch.core.quadratic import Quadratic
from repro_torch.core.robust import robust_padded_solve_batched
from repro_torch.core.status import SolveStatus, status_name
from repro_torch.device import resolve_device


class ShapeClass(NamedTuple):
    n: int       # padded row count
    d: int       # padded feature count
    m_max: int   # padded sketch budget for the class
    sketch: str | None = None          # per-class sketch family (None →
                                       # service default)
    compute_dtype: str | None = None   # per-class sketch-pass precision


DEFAULT_SHAPE_CLASSES = (
    ShapeClass(n=256, d=32, m_max=64),
    ShapeClass(n=1024, d=64, m_max=128),
    ShapeClass(n=2048, d=128, m_max=256),
    ShapeClass(n=4096, d=256, m_max=512),
    # large-n tail: one FWHT pass instead of the streamed Gaussian
    ShapeClass(n=16384, d=256, m_max=512, sketch="srht"),
)


@dataclasses.dataclass(frozen=True)
class RidgeRequest:
    req_id: int
    A: torch.Tensor          # (n, d) features
    y: torch.Tensor          # (n,) targets
    nu: float                # regularization ν
    lam_diag: torch.Tensor | None = None
    deadline: float | None = None   # absolute time.perf_counter() stamp


@dataclasses.dataclass(frozen=True)
class RidgeSolution:
    req_id: int
    x: torch.Tensor          # (d,) solution in the request's coordinates
    delta_tilde: float       # certificate: final δ̃ (eq. 2.3)
    m_final: int             # certificate: adapted sketch size
    iters: int               # accepted iterations
    doublings: int
    shape_class: ShapeClass
    batch_index: int         # slot in the packed batch (observability)
    sketch: str = "gaussian"
    compute_dtype: str = "fp32"
    status: str = "OK"       # failure-lattice verdict (SolveStatus name)
    converged: bool = True   # δ̃ cleared the service tolerance
    stalled: bool = False    # terminated above tolerance
    retries: int = 0         # sketch redraws consumed before this answer
    fell_back: bool = False  # answer from direct_solve, no δ̃ certificate


class SolverService:
    """Shape-class bucketing + batch packing over the padded adaptive engine.

    ``submit`` enqueues; ``flush`` drains every bucket in fixed-size batches
    and returns solutions keyed by request id. Everything runs on ``device``
    (default cuda). ``strict=True`` raises on an inadmissible request at
    submit; ``strict=False`` quarantines it into a ``REJECTED`` solution."""

    def __init__(
        self,
        shape_classes: Iterable[ShapeClass] | None = None,
        *,
        batch_size: int = 16,
        method: str = "pcg",
        sketch: str = "gaussian",
        compute_dtype: str = "fp32",
        rho: float = 0.5,
        tol: float = 1e-10,
        max_iters: int = 200,
        seed: int = 0,
        strict: bool = True,
        max_retries: int = 2,
        fallback: bool = True,
        flush_deadline_s: float | None = None,
        segment_trips: int = 32,
        device=None,
    ):
        self.device = resolve_device(device)
        self.shape_classes = sorted(DEFAULT_SHAPE_CLASSES if shape_classes is None
                                    else shape_classes,
                                    key=lambda c: (c.n, c.d, c.m_max))
        self.batch_size = batch_size
        self.method = method
        self.sketch = sketch
        self.compute_dtype = compute_dtype
        self.rho = rho
        self.tol = tol
        self.max_iters = max_iters
        self.seed = seed
        self.strict = strict
        self.max_retries = max_retries
        self.fallback = fallback
        # the default per-flush budget, and the trips of a segment whenever
        # a budget routes a chunk through the segmented driver
        self.flush_deadline_s = flush_deadline_s
        self.segment_trips = segment_trips
        self._queues: dict[ShapeClass, list[RidgeRequest]] = {
            c: [] for c in self.shape_classes}
        self._next_id = 0
        self._quarantined: dict[int, RidgeSolution] = {}
        self.rejection_reasons: dict[int, str] = {}
        self.stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                      "solve_seconds": 0.0, "retries": 0, "fallbacks": 0,
                      "rejected": 0, "deadline_exceeded": 0, "segments": 0,
                      "resumed_chunks": 0}

    def slot_utilization(self) -> float:
        """Fraction of solved batch slots that held a real request."""
        total = self.stats["batches"] * self.batch_size
        return 1.0 - self.stats["padded_slots"] / total if total else 1.0

    # -- bucketing ---------------------------------------------------------
    def bucket_for(self, n: int, d: int) -> ShapeClass:
        """Smallest configured shape class that fits an (n, d) request."""
        for c in self.shape_classes:
            if n <= c.n and d <= c.d:
                return c
        raise ValueError(
            f"no shape class fits (n={n}, d={d}); "
            f"largest is {self.shape_classes[-1]}")

    def submit(self, A, y, nu, lam_diag=None, *,
               deadline_s: float | None = None) -> int:
        """Enqueue one ridge problem (A (n, d), y (n,), ν > 0, optional Λ
        (d,)); returns its request id. Tensors are moved to the service's
        device. ν must be a positive finite float and A, y, Λ finite:
        padded coordinates carry H = ν²·I, and a NaN would poison the
        certificates silently, so admission checks them here.

        ``deadline_s``: the request's wall-clock budget, counted from now.
        It orders dispatch (earliest deadline first) and binds mid-solve: a
        request that runs out of time returns its best finite iterate, its
        real δ̃ and ``DEADLINE_EXCEEDED``; one whose budget is spent before
        its chunk starts returns x = 0 with no certificate."""
        dev = self.device
        A = torch.as_tensor(A, dtype=torch.float32, device=dev)
        y = torch.as_tensor(y, dtype=torch.float32, device=dev)
        if lam_diag is not None:
            lam_diag = torch.as_tensor(lam_diag, dtype=torch.float32, device=dev)
        cls = self.bucket_for(*A.shape)     # shape errors always raise
        nu, reason = self._validate(A, y, nu, lam_diag)
        rid = self._next_id
        self._next_id += 1
        self.stats["requests"] += 1
        if reason is not None:
            self._quarantined[rid] = RidgeSolution(
                req_id=rid, x=torch.zeros(A.shape[1], device=dev),
                delta_tilde=float("nan"), m_final=0, iters=0, doublings=0,
                shape_class=cls, batch_index=-1,
                sketch=cls.sketch or self.sketch,
                compute_dtype=cls.compute_dtype or self.compute_dtype,
                status=SolveStatus.REJECTED.name, converged=False)
            self.rejection_reasons[rid] = reason
            self.stats["rejected"] += 1
            return rid
        deadline = (None if deadline_s is None
                    else time.perf_counter() + float(deadline_s))
        self._queues[cls].append(RidgeRequest(
            req_id=rid, A=A, y=y, nu=nu, lam_diag=lam_diag, deadline=deadline))
        return rid

    def _validate(self, A, y, nu, lam_diag) -> tuple[float, str | None]:
        """Admission checks beyond shape: (ν, reason), reason None iff
        admissible. In strict mode an inadmissible request raises a
        ValueError naming the id it would have been given."""
        reason = None
        try:
            nu = self._check_nu(nu)
        except ValueError as e:
            reason, nu = str(e), float("nan")
        if reason is None and y.shape != (A.shape[0],):
            raise ValueError(
                f"y has shape {tuple(y.shape)}, expected ({A.shape[0]},) to match A")
        for name, t in (("A", A), ("y", y), ("lam_diag", lam_diag)):
            if reason is None and t is not None and not bool(torch.isfinite(t).all()):
                reason = f"non-finite entries in {name}"
        if reason is not None and self.strict:
            raise ValueError(f"request {self._next_id} rejected: {reason}")
        return nu, reason

    @staticmethod
    def _check_nu(nu) -> float:
        nu = float(nu)
        if not math.isfinite(nu) or nu <= 0.0:
            raise ValueError(
                f"nu must be a positive finite float, got {nu!r}: padded "
                "coordinates carry H = ν²·I, so ν = 0 makes the padded "
                "block singular and NaN-poisons the certificates")
        return nu

    # -- packing -----------------------------------------------------------
    def _slot_seeds(self, slot_ids: list[int]) -> torch.Tensor:
        """(B,) uint32 sketch seeds (int64 carrier) of a packed batch, a
        fold of the service seed with each slot id."""
        ids = torch.tensor(slot_ids, dtype=torch.int64, device=self.device)
        base = torch.tensor(self.seed, dtype=torch.int64, device=self.device)
        return fold_seeds(base, ids)

    def _pack(self, cls: ShapeClass, reqs: list[RidgeRequest]):
        """Pad each request to the class shape and stack on the device; pad
        the batch to ``batch_size`` with trivial (b = 0) problems. Padded
        slots take the reserved ids 2³²−1−slot, so padding never aliases a
        real request's sketch. Returns (q, seeds)."""
        B, dev = self.batch_size, self.device
        A = torch.zeros((B, cls.n, cls.d), device=dev)
        b = torch.zeros((B, cls.d), device=dev)
        nu = torch.ones(B, device=dev)
        lam = torch.ones((B, cls.d), device=dev)
        for i, r in enumerate(reqs):
            ni, di = r.A.shape
            A[i, :ni, :di] = r.A
            b[i, :di] = r.A.T @ r.y
            nu[i] = r.nu
            if r.lam_diag is not None:
                lam[i, :di] = r.lam_diag
        slot_ids = ([r.req_id for r in reqs]
                    + [0xFFFFFFFF - s for s in range(len(reqs), B)])
        q = Quadratic(A=A, b=b, nu=nu, lam_diag=lam, batched=True)
        return q, self._slot_seeds(slot_ids)

    # -- solving -----------------------------------------------------------
    def flush(self, deadline_s: float | None = None) -> dict[int, RidgeSolution]:
        """Solve everything queued; returns {req_id: solution}. Chunks go
        earliest-deadline-first (requests without a deadline last, in
        insertion order); quarantined (REJECTED) requests come back first
        and cost no solve time.

        ``deadline_s`` (default: the service's ``flush_deadline_s``) is a
        budget for the whole flush. Each chunk gets the least of what is
        left of it and of its most urgent request's budget; a chunk whose
        budget is spent before dispatch expires, and a budget binds
        mid-solve through the segmented driver."""
        if deadline_s is None:
            deadline_s = self.flush_deadline_s
        t0 = time.perf_counter()
        out: dict[int, RidgeSolution] = dict(self._quarantined)
        self._quarantined = {}
        chunks = []
        for cls in self.shape_classes:
            queue, self._queues[cls] = self._queues[cls], []
            queue.sort(key=lambda r: (r.deadline is None, r.deadline or 0.0))
            for i in range(0, len(queue), self.batch_size):
                chunk = queue[i: i + self.batch_size]
                dl = [r.deadline for r in chunk if r.deadline is not None]
                chunks.append((min(dl) if dl else None, len(chunks), cls, chunk))
        chunks.sort(key=lambda c: (c[0] is None, c[0] or 0.0, c[1]))
        for chunk_deadline, _, cls, chunk in chunks:
            now = time.perf_counter()
            budgets = []
            if deadline_s is not None:
                budgets.append(deadline_s - (now - t0))
            if chunk_deadline is not None:
                budgets.append(chunk_deadline - now)
            budget = min(budgets) if budgets else None
            if budget is not None and budget <= 0:
                out.update(self._expire_chunk(cls, chunk))
            else:
                out.update(self._solve_chunk(cls, chunk, budget_s=budget))
        return out

    def _expire_chunk(self, cls: ShapeClass, reqs: list[RidgeRequest]):
        """DEADLINE_EXCEEDED solutions for a chunk that was not dispatched."""
        out = {}
        for r in reqs:
            out[r.req_id] = RidgeSolution(
                req_id=r.req_id, x=torch.zeros(r.A.shape[1], device=self.device),
                delta_tilde=float("nan"), m_final=0, iters=0, doublings=0,
                shape_class=cls, batch_index=-1, sketch=cls.sketch or self.sketch,
                compute_dtype=cls.compute_dtype or self.compute_dtype,
                status=SolveStatus.DEADLINE_EXCEEDED.name, converged=False)
            self.stats["deadline_exceeded"] += 1
        return out

    def _solve_chunk(self, cls: ShapeClass, reqs: list[RidgeRequest],
                     budget_s: float | None = None):
        sketch = cls.sketch or self.sketch
        cd = cls.compute_dtype or self.compute_dtype
        q, seeds = self._pack(cls, reqs)
        # a budget routes the solve through the segmented driver; without
        # one the call, and its numbers, are the monolithic ones
        seg = ({} if budget_s is None
               else dict(deadline_s=budget_s, segment_trips=self.segment_trips))
        t0 = time.perf_counter()
        x, stats = robust_padded_solve_batched(
            q, seeds, m_max=cls.m_max, method=self.method, sketch=sketch,
            max_iters=self.max_iters, rho=self.rho, tol=self.tol,
            max_retries=self.max_retries, fallback=self.fallback,
            compute_dtype=cd, device=self.device, **seg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["solve_seconds"] += time.perf_counter() - t0
        self.stats["batches"] += 1
        self.stats["padded_slots"] += self.batch_size - len(reqs)
        self.stats["segments"] += stats["segments"]
        self.stats["resumed_chunks"] += int(stats["resumed"])
        out = {}
        for i, r in enumerate(reqs):
            di = r.A.shape[1]
            self.stats["retries"] += int(stats["retries"][i])
            self.stats["fallbacks"] += int(stats["fell_back"][i])
            if int(stats["status"][i]) == int(SolveStatus.DEADLINE_EXCEEDED):
                self.stats["deadline_exceeded"] += 1
            out[r.req_id] = RidgeSolution(
                req_id=r.req_id, x=x[i, :di],
                delta_tilde=float(stats["dtilde"][i]),
                m_final=int(stats["m_final"][i]),
                iters=int(stats["iters"][i]),
                doublings=int(stats["doublings"][i]),
                shape_class=cls, batch_index=i, sketch=sketch, compute_dtype=cd,
                status=status_name(stats["status"][i]),
                converged=bool(stats["converged"][i]),
                stalled=bool(stats["stalled"][i]),
                retries=int(stats["retries"][i]),
                fell_back=bool(stats["fell_back"][i]))
        return out

    def solve_one(self, A, y, nu, lam_diag=None) -> RidgeSolution:
        """Convenience: submit + flush a single request (still batched —
        the padded slots ride along as no-op problems)."""
        rid = self.submit(A, y, nu, lam_diag)
        return self.flush()[rid]
