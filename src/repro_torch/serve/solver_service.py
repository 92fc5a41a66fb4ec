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

Preemption: with ``checkpoint_dir=`` every ridge chunk checkpoints its
solver state after each segment under ``chunk_<tag>``, a tag derived from
the chunk's shape class and request ids (the reference's token, so both
packages name a chunk alike). ``preempt=`` (an ``ft.PreemptionHandler``) is
polled between segments: when it is set, the in-flight chunk saves and
``flush`` raises ``core.robust.PreemptedError``. A restarted process that
replays the same submissions on a service with the same seed finds the
same directories and resumes each chunk from its last committed segment,
bitwise the uninterrupted answers (``stats["resumed_chunks"]``).

GLM traffic: ``submit_glm`` takes (A, y, ν) with a ``family`` (logistic,
poisson, huber[:δ], quadratic) through the same bucketing and packing; a
packed GLM batch is solved by the sketched-Newton driver (``core.newton``),
whose weighted Newton systems run on the padded engine with warm-started
ladders. Its answers carry Newton-level certificates: outer steps, the
final decrement λ̃²/2 and the per-step m trajectory.

Path traffic: ``submit_path`` takes (A, y, a grid of ν) and returns one
``PathSolution`` whose ``PathPoint``s each carry the full certificate. A
packed path chunk runs ``core.robust.robust_path_solve_batched``: one sketch
pass serves the whole grid (the ladder Grams are λ-free), x and the ladder
level warm-started point to point.

Ladder cache (opt-in, ``ladder_cache=True``): the λ-free ladder is also
reusable across requests with the same (A, Λ, class, family, dtype). The
service fingerprints that content (SHA-1 of every byte of A and Λ), keys
the slot's sketch off the fingerprint instead of the request id (the same
data draws the same sketch, so a cached slice is exactly what the pass
would recompute), and serves a chunk whose slots are all cached without
touching A. Solutions record ``cache_hit``.

Per-slot seeds come from ``_slot_seeds``: a fold of the service seed with
the slot id (a real slot's request id, or its fingerprint's id under the
cache; padded slots the reserved ids 2³²−1−slot), so a request's sketch
does not depend on what it is packed with.

Sharded mode (``mesh=``, a ``DeviceMesh`` of the ranks that serve together,
``core.distributed``): every rank runs the same service on the same
submissions, so each packs the same batch with the same b and seeds as one
device would. From ``submit`` on, a rank keeps only its row block of each
ridge and path request (its rows of the class's n, copied out, with
b = Aᵀy and, under the ladder cache, the fingerprint taken from the whole
request first), so its queue and packed A hold n/K rows of each request.
The caller still hands each request in whole, one at a time. GLM requests
stay whole on every rank: the Newton driver's gradient and weights are
replicated, and only its inner systems are cut to the rank's rows. Every
solve then runs with ``mesh=``: one all-reduce each for the ladder Grams
and the true Gram, and every rank returns the same answers. The default
classes add the pod-scale tail (65536, 256, 512, srht); every class's n
must divide by the data-shard count. Deadlines, checkpoints and preemption
work as on one device, decided by the lead rank (``core.distributed``):
ranks stamp their submissions at different instants, so each flush
broadcasts the lead rank's remaining time per request, from which every
rank builds the same chunks, EDF order and budgets; one ``host_verdict``
before each dispatch says whether the chunk has expired on the lead rank's
clock. A ridge chunk's deadline, checkpoint and preemption flag then go
through the segmented driver's verdicts (any rank's SIGTERM stops every
rank at the same segment), and the lead rank alone writes the chunk's
checkpoint into the shared ``checkpoint_dir``; every rank resumes the lead
rank's latest step, or every rank raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from collections import OrderedDict
from pathlib import Path
from typing import Iterable, NamedTuple

import torch

from repro_torch import trace
from repro_torch.core.adaptive_padded import doubling_ladder, prepare_path_ladder
from repro_torch.core.level_grams import fold_seeds
from repro_torch.core.newton import adaptive_newton_solve_batched
from repro_torch.core.objectives import get_objective
from repro_torch.core.quadratic import Quadratic
from repro_torch.core.robust import robust_padded_solve_batched, robust_path_solve_batched
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

# a sharded service (mesh=...) also serves the pod-scale tail: each data
# shard holds n/K rows of the packed batch and the one-touch pass all-reduces
# the (L, B, d, d) level Grams; a service without a mesh keeps refusing
# such requests with "no shape class fits"
SHARDED_SHAPE_CLASSES = DEFAULT_SHAPE_CLASSES + (
    ShapeClass(n=65536, d=256, m_max=512, sketch="srht"),
)


@dataclasses.dataclass(frozen=True)
class RidgeRequest:
    req_id: int
    A: torch.Tensor          # (n, d) features
    y: torch.Tensor          # (n,) targets
    nu: float                # regularization ν
    lam_diag: torch.Tensor | None = None
    deadline: float | None = None   # absolute time.perf_counter() stamp
    # sharded mode: A and y are this rank's row block, b = Aᵀy of the whole
    # request and fp its ladder-cache fingerprint (None: taken from A and y)
    b: torch.Tensor | None = None
    fp: str | None = None


@dataclasses.dataclass(frozen=True)
class PathRequest:
    req_id: int
    A: torch.Tensor          # (n, d) features
    y: torch.Tensor          # (n,) targets
    nus: tuple               # grid of ν, walked in order (strong → weak)
    lam_diag: torch.Tensor | None = None
    deadline: float | None = None   # absolute time.perf_counter() stamp
    b: torch.Tensor | None = None   # as RidgeRequest's
    fp: str | None = None


@dataclasses.dataclass(frozen=True)
class GLMRequest:
    req_id: int
    A: torch.Tensor          # (n, d) features
    y: torch.Tensor          # (n,) labels / counts / responses
    nu: float                # regularization ν
    family: str              # "logistic" | "poisson" | "huber[:delta]" | "quadratic"
    lam_diag: torch.Tensor | None = None
    deadline: float | None = None   # absolute time.perf_counter() stamp


@dataclasses.dataclass(frozen=True)
class GLMSolution:
    req_id: int
    x: torch.Tensor          # (d,) solution in the request's coordinates
    family: str
    decrement: float         # certificate: final Newton decrement λ̃²/2
    converged: bool          # the decrement cleared the service tolerance
    newton_iters: int        # accepted outer Newton steps
    m_trajectory: tuple      # certificate: inner m_final after each step
    m_final: int             # last adapted sketch size
    inner_iters: int         # inner iterations over all steps
    shape_class: ShapeClass
    batch_index: int
    sketch: str = "gaussian"
    compute_dtype: str = "fp32"
    status: str = "OK"       # failure-lattice verdict (SolveStatus name)
    stalled: bool = False    # frozen above tolerance (line search, budget)
    retries: int = 0         # sketch redraws (0 on the GLM path)
    fell_back: bool = False  # answer from a dense fallback, no certificate


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
    cache_hit: bool = False  # the λ-free ladder came from the fingerprint
                             # cache: this answer skipped the sketch pass


@dataclasses.dataclass(frozen=True)
class PathPoint:
    """One ν of a ``PathSolution``, with a ``RidgeSolution``'s certificates."""
    nu: float
    x: torch.Tensor          # (d,) solution in the request's coordinates
    delta_tilde: float       # certificate: final δ̃ at this ν
    m_final: int             # certificate: adapted sketch size at this ν
    iters: int
    doublings: int
    status: str = "OK"
    converged: bool = True
    retries: int = 0
    fell_back: bool = False


@dataclasses.dataclass(frozen=True)
class PathSolution:
    req_id: int
    points: tuple            # P PathPoints, in the request's grid order
    shape_class: ShapeClass
    batch_index: int
    sketch: str = "gaussian"
    compute_dtype: str = "fp32"
    status: str = "OK"       # OK iff every point converged, else the first
                             # unconverged point's status
    converged: bool = True   # every point cleared the service tolerance
    cache_hit: bool = False  # the ladder came from the fingerprint cache
    sketch_passes: int = 1   # sketch passes the request's chunk paid for the
                             # whole grid (0 on a cache hit, +1 per retry)


class SolverService:
    """Shape-class bucketing + batch packing over the padded adaptive engine.

    ``submit`` / ``submit_glm`` / ``submit_path`` enqueue; ``flush`` drains
    every queue in fixed-size batches and returns solutions keyed by request
    id. Everything runs on ``device`` (default cuda). ``strict=True`` raises
    on an inadmissible request at submit; ``strict=False`` quarantines it
    into a ``REJECTED`` solution. ``ladder_cache=True`` keeps up to
    ``ladder_cache_size`` λ-free ladder slices (on the device), keyed by
    content fingerprint. ``checkpoint_dir`` and ``preempt`` make ridge
    chunks preemptible (module docstring). The GLM driver's knobs are the
    attributes ``newton_iters`` and ``newton_tol``. ``mesh`` turns on the
    sharded mode (module docstring)."""

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
        checkpoint_dir=None,
        preempt=None,
        ladder_cache: bool = False,
        ladder_cache_size: int = 64,
        mesh=None,
        device=None,
    ):
        self.device = resolve_device(device)
        if shape_classes is None:
            shape_classes = SHARDED_SHAPE_CLASSES if mesh is not None else DEFAULT_SHAPE_CLASSES
        self.shape_classes = sorted(shape_classes, key=lambda c: (c.n, c.d, c.m_max))
        self.mesh = mesh
        if mesh is not None:
            from repro_torch.core.distributed import n_data_shards

            k = n_data_shards(mesh)
            bad = [c for c in self.shape_classes if c.n % k]
            if bad:
                raise ValueError(f"shape classes {bad} have n not divisible by the "
                                 f"mesh's {k} data shards")
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
        # per-chunk checkpoints (deterministic directory names, so a
        # restarted process resumes its chunks) and the preemption flag
        # polled between segments
        self.checkpoint_dir = checkpoint_dir
        self.preempt = preempt
        self._queues: dict[ShapeClass, list[RidgeRequest]] = {
            c: [] for c in self.shape_classes}
        # GLM traffic buckets by (class, family), path traffic by (class,
        # grid length P): a packed path chunk's grids form one (P, B) array
        self._glm_queues: dict[tuple[ShapeClass, str], list[GLMRequest]] = {}
        self._path_queues: dict[tuple[ShapeClass, int], list[PathRequest]] = {}
        # fingerprint → ((L, d, d) level-Gram slice, (d, d) true-Gram slice),
        # least recently used first
        self.ladder_cache = bool(ladder_cache)
        self.ladder_cache_size = int(ladder_cache_size)
        self._ladder_store: OrderedDict[str, tuple] = OrderedDict()
        self.newton_iters = 30
        self.newton_tol = 1e-9
        self._next_id = 0
        self._quarantined: dict = {}
        self.rejection_reasons: dict[int, str] = {}
        self.stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                      "retries": 0, "fallbacks": 0,
                      "rejected": 0, "deadline_exceeded": 0, "segments": 0,
                      "resumed_chunks": 0, "path_requests": 0,
                      "ladder_cache_hits": 0, "ladder_cache_misses": 0,
                      "sketch_passes_saved": 0,
                      # ridge and path chunks: the PCG trips the host
                      # dispatched, and those the problems needed
                      "trips_run": 0, "trips_needed": 0}

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
        with trace.span("service.submit", req_id=self._next_id):
            A, y, lam_diag = self._stage(A, y, lam_diag)
            cls = self.bucket_for(*A.shape)     # shape errors always raise
            nu, reason = self._validate(A, y, nu, lam_diag)
            rid = self._new_id()
            if reason is not None:
                self._reject(rid, reason, RidgeSolution(
                    req_id=rid, x=torch.zeros(A.shape[1], device=self.device),
                    delta_tilde=float("nan"), m_final=0, iters=0, doublings=0,
                    shape_class=cls, batch_index=-1,
                    sketch=cls.sketch or self.sketch,
                    compute_dtype=cls.compute_dtype or self.compute_dtype,
                    status=SolveStatus.REJECTED.name, converged=False))
                return rid
            self._queues[cls].append(RidgeRequest(
                req_id=rid, nu=nu, lam_diag=lam_diag, deadline=self._deadline(deadline_s),
                **self._rows_kept(cls, A, y, lam_diag)))
            return rid

    def submit_glm(self, A, y, nu, family: str = "logistic", lam_diag=None, *,
                   deadline_s: float | None = None) -> int:
        """Enqueue one regularized GLM problem (``family``: logistic,
        poisson, huber[:δ] or quadratic); returns its request id.

        Padding keeps the answer: padded columns of A are zero and carry
        ν²Λ = ν²·I, so their optimum is 0; padded rows are all-zero data
        rows, with no gradient and no Hessian weight. Admission checks and
        ``deadline_s`` are those of ``submit``; the budget binds between
        the Newton driver's outer steps."""
        with trace.span("service.submit", req_id=self._next_id):
            get_objective(family)              # an unknown family raises here
            A, y, lam_diag = self._stage(A, y, lam_diag)
            cls = self.bucket_for(*A.shape)
            nu, reason = self._validate(A, y, nu, lam_diag)
            rid = self._new_id()
            if reason is not None:
                self._reject(rid, reason, GLMSolution(
                    req_id=rid, x=torch.zeros(A.shape[1], device=self.device),
                    family=family, decrement=float("nan"), converged=False,
                    newton_iters=0, m_trajectory=(), m_final=0, inner_iters=0,
                    shape_class=cls, batch_index=-1, sketch=cls.sketch or self.sketch,
                    compute_dtype=cls.compute_dtype or self.compute_dtype,
                    status=SolveStatus.REJECTED.name))
                return rid
            self._glm_queues.setdefault((cls, family), []).append(GLMRequest(
                req_id=rid, A=A, y=y, nu=nu, family=family, lam_diag=lam_diag,
                deadline=self._deadline(deadline_s)))
            return rid

    def submit_path(self, A, y, nus, lam_diag=None, *,
                    deadline_s: float | None = None) -> int:
        """Enqueue one ridge problem over a grid of ν; returns its request
        id. The flush returns a ``PathSolution`` with one ``PathPoint`` per ν,
        in the grid's order, x and the ladder level warm-started point to
        point (sort the grid from strong to weak regularization). The whole
        grid is solved off one sketch pass; requests with grids of the same
        length pack into one chunk even when the grids differ. Admission
        checks every ν of the grid. A ``deadline_s`` orders dispatch and
        expires the chunk before it starts; it does not bind mid-solve."""
        with trace.span("service.submit", req_id=self._next_id):
            A, y, lam_diag = self._stage(A, y, lam_diag)
            cls = self.bucket_for(*A.shape)
            nus = tuple(float(v) for v in torch.as_tensor(nus, dtype=torch.float64).reshape(-1))
            if not nus:
                raise ValueError("submit_path needs a non-empty grid of ν")
            reason = None
            try:
                for v in nus:
                    self._check_nu(v)
            except ValueError as e:
                reason = str(e)
                if self.strict:
                    raise ValueError(f"request {self._next_id} rejected: {reason}") from e
            if reason is None:
                _, reason = self._validate(A, y, nus[0], lam_diag)
            rid = self._new_id()
            self.stats["path_requests"] += 1
            if reason is not None:
                zero = torch.zeros(A.shape[1], device=self.device)
                self._reject(rid, reason, PathSolution(
                    req_id=rid, points=tuple(PathPoint(
                        nu=v, x=zero, delta_tilde=float("nan"), m_final=0, iters=0,
                        doublings=0, status=SolveStatus.REJECTED.name, converged=False)
                        for v in nus),
                    shape_class=cls, batch_index=-1, sketch=cls.sketch or self.sketch,
                    compute_dtype=cls.compute_dtype or self.compute_dtype,
                    status=SolveStatus.REJECTED.name, converged=False, sketch_passes=0))
                return rid
            self._path_queues.setdefault((cls, len(nus)), []).append(PathRequest(
                req_id=rid, nus=nus, lam_diag=lam_diag, deadline=self._deadline(deadline_s),
                **self._rows_kept(cls, A, y, lam_diag)))
            return rid

    def _rows_kept(self, cls: ShapeClass, A, y, lam_diag) -> dict:
        """The fields of a queued ridge or path request that hold its data:
        A and y whole, or in sharded mode this rank's row block of the
        class's n (copied, so the whole request can go), b = Aᵀy and, under
        the ladder cache, the fingerprint of the whole request."""
        if self.mesh is None:
            return dict(A=A, y=y)
        from repro_torch.core.distributed import data_index, n_data_shards

        n_rows = cls.n // n_data_shards(self.mesh)
        r0 = data_index(self.mesh) * n_rows
        fp = None
        if self.ladder_cache:
            fp = self._ladder_fingerprint(A, lam_diag, cls, cls.sketch or self.sketch,
                                          cls.compute_dtype or self.compute_dtype)
        return dict(A=A[r0:r0 + n_rows].clone(), y=y[r0:r0 + n_rows].clone(), b=A.T @ y,
                    fp=fp)

    def _stage(self, A, y, lam_diag):
        """A, y and Λ as fp32 tensors on the service's device."""
        dev = self.device
        A = torch.as_tensor(A, dtype=torch.float32, device=dev)
        y = torch.as_tensor(y, dtype=torch.float32, device=dev)
        if lam_diag is not None:
            lam_diag = torch.as_tensor(lam_diag, dtype=torch.float32, device=dev)
        return A, y, lam_diag

    def _new_id(self) -> int:
        rid = self._next_id
        self._next_id += 1
        self.stats["requests"] += 1
        return rid

    @staticmethod
    def _deadline(deadline_s: float | None) -> float | None:
        return None if deadline_s is None else time.perf_counter() + float(deadline_s)

    def _reject(self, rid: int, reason: str, solution) -> None:
        """Quarantine an inadmissible request (strict=False): it never joins
        a packed batch and comes back REJECTED at flush."""
        self._quarantined[rid] = solution
        self.rejection_reasons[rid] = reason
        self.stats["rejected"] += 1

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

    def _pad_ids(self, ids: list[int]) -> list[int]:
        """Slot ids of a packed batch: the real slots' ids, then the reserved
        ids 2³²−1−slot of the padded slots, so padding never aliases a real
        request's sketch."""
        return list(ids) + [0xFFFFFFFF - s for s in range(len(ids), self.batch_size)]

    def _pack(self, cls: ShapeClass, reqs: list[RidgeRequest],
              slot_ids: list[int] | None = None):
        """Pad each request to the class shape and stack on the device; pad
        the batch to ``batch_size`` with trivial (b = 0) problems. The real
        slots' sketch ids are their request ids, or ``slot_ids`` (the ladder
        cache keys slots by fingerprint). Sharded, the requests hold this
        rank's row blocks (``_rows_kept``), so q's A is this rank's row block
        of the packed batch and b the whole batch's. Returns (q, seeds)."""
        B, dev = self.batch_size, self.device
        n_rows = cls.n
        if self.mesh is not None:
            from repro_torch.core.distributed import n_data_shards

            n_rows = cls.n // n_data_shards(self.mesh)
        A = torch.zeros((B, n_rows, cls.d), device=dev)
        b = torch.zeros((B, cls.d), device=dev)
        nu = torch.ones(B, device=dev)
        lam = torch.ones((B, cls.d), device=dev)
        for i, r in enumerate(reqs):
            ni, di = r.A.shape
            A[i, :ni, :di] = r.A
            b[i, :di] = r.A.T @ r.y if r.b is None else r.b
            nu[i] = r.nu
            if r.lam_diag is not None:
                lam[i, :di] = r.lam_diag
        ids = [r.req_id for r in reqs] if slot_ids is None else slot_ids
        q = Quadratic(A=A, b=b, nu=nu, lam_diag=lam, batched=True)
        return q, self._slot_seeds(self._pad_ids(ids))

    def _pack_glm(self, cls: ShapeClass, reqs: list[GLMRequest]):
        """Pad each GLM request to the class shape and stack (A, y, ν, Λ);
        empty slots are all-zero problems (x = 0 is optimal, decrement 0, so
        the driver freezes them at its first step). Same seeds as ``_pack``."""
        with trace.span("service.pack"):
            B, dev = self.batch_size, self.device
            A = torch.zeros((B, cls.n, cls.d), device=dev)
            y = torch.zeros((B, cls.n), device=dev)
            nu = torch.ones(B, device=dev)
            lam = torch.ones((B, cls.d), device=dev)
            for i, r in enumerate(reqs):
                ni, di = r.A.shape
                A[i, :ni, :di] = r.A
                y[i, :ni] = r.y
                nu[i] = r.nu
                if r.lam_diag is not None:
                    lam[i, :di] = r.lam_diag
            return A, y, nu, lam, self._slot_seeds(self._pad_ids([r.req_id for r in reqs]))

    # -- solving -----------------------------------------------------------
    def flush(self, deadline_s: float | None = None) -> dict:
        """Solve everything queued; returns {req_id: solution}, ridge, GLM
        and path answers in one map, each with its own solution type.
        Chunks of all three queues go earliest-deadline-first (requests
        without a deadline last, in insertion order); quarantined (REJECTED)
        requests come back first and cost no solve time.

        ``deadline_s`` (default: the service's ``flush_deadline_s``) is a
        budget for the whole flush. Each chunk gets the least of what is
        left of it and of its most urgent request's budget; a chunk whose
        budget is spent before dispatch expires. A ridge chunk's budget
        binds mid-solve through the segmented driver, a GLM chunk's between
        Newton steps; a path chunk's only before dispatch."""
        with trace.span("service.flush"):
            if deadline_s is None:
                deadline_s = self.flush_deadline_s
            t0 = time.perf_counter()
            out: dict = dict(self._quarantined)
            self._quarantined = {}
            sources = ([(cls, None, self._queues, cls) for cls in self.shape_classes]
                       + [(cls, fam, self._glm_queues, (cls, fam))
                          for cls, fam in list(self._glm_queues)]
                       + [(cls, ("path", P), self._path_queues, (cls, P))
                          for cls, P in list(self._path_queues)])
            queues = []
            for cls, kind, store, key in sources:
                queues.append((cls, kind, store[key]))
                store[key] = []
            rel = self._relative_deadlines([r for _, _, q in queues for r in q], t0)
            # (urgency, seq, cls, kind, chunk): kind None for ridge, the family
            # name for GLM, ("path", P) for path; urgency in seconds from t0
            chunks = []
            for cls, kind, queue in queues:
                queue.sort(key=lambda r: (r.req_id not in rel, rel.get(r.req_id, 0.0)))
                for i in range(0, len(queue), self.batch_size):
                    chunk = queue[i: i + self.batch_size]
                    dl = [rel[r.req_id] for r in chunk if r.req_id in rel]
                    chunks.append((min(dl) if dl else None, len(chunks), cls, kind, chunk))
            chunks.sort(key=lambda c: (c[0] is None, c[0] or 0.0, c[1]))
            for chunk_deadline, _, cls, kind, chunk in chunks:
                spent = time.perf_counter() - t0
                budgets = []
                if deadline_s is not None:
                    budgets.append(deadline_s - spent)
                if chunk_deadline is not None:
                    budgets.append(chunk_deadline - spent)
                budget = min(budgets) if budgets else None
                expired = budget is not None and budget <= 0
                if budget is not None and self.mesh is not None:
                    from repro_torch.core.distributed import host_verdict

                    _, expired = host_verdict(self.mesh, stop=False, expired=expired)
                with trace.span("service.chunk", cls=cls, kind=kind,
                                req_ids=[r.req_id for r in chunk]):
                    if expired:
                        out.update(self._expire_chunk(cls, chunk, family=kind))
                    elif kind is None:
                        out.update(self._solve_chunk(cls, chunk, budget_s=budget))
                    elif isinstance(kind, tuple):
                        out.update(self._solve_path_chunk(cls, chunk))
                    else:
                        out.update(self._solve_glm_chunk(cls, kind, chunk, budget_s=budget))
            return out

    def _relative_deadlines(self, reqs, t0: float) -> dict[int, float]:
        """{req_id: seconds from the flush's start t0 to the request's
        deadline} for the queued requests that carry one. Sharded, these are
        the lead rank's (``lead_values``, one broadcast a flush): ranks stamp
        their submissions at different instants, and the chunks, their EDF
        order and their budgets must be the same on every rank."""
        timed = [r for r in reqs if r.deadline is not None]
        left = [r.deadline - t0 for r in timed]
        if self.mesh is not None and timed:
            from repro_torch.core.distributed import lead_values

            left = lead_values(self.mesh, left)
        return {r.req_id: v for r, v in zip(timed, left)}

    def _chunk_checkpoint(self, cls: ShapeClass, reqs):
        """A ridge chunk's CheckpointManager under ``checkpoint_dir``, named
        by a hash of its class and request ids: a restarted process that
        replays the same submissions finds the same directory."""
        if self.checkpoint_dir is None:
            return None
        from repro_torch.ft.checkpoint import CheckpointManager

        ids = ",".join(str(r.req_id) for r in reqs)
        token = f"{cls.n}x{cls.d}x{cls.m_max}:ridge:{ids}"
        tag = hashlib.sha1(token.encode()).hexdigest()[:12]
        return CheckpointManager(Path(self.checkpoint_dir) / f"chunk_{tag}")

    def _expire_chunk(self, cls: ShapeClass, reqs, family=None):
        """DEADLINE_EXCEEDED solutions for a chunk that was not dispatched:
        ``family`` None for ridge, a family name for GLM, ("path", P)."""
        out = {}
        name = SolveStatus.DEADLINE_EXCEEDED.name
        sketch = cls.sketch or self.sketch
        cd = cls.compute_dtype or self.compute_dtype
        for r in reqs:
            zero = torch.zeros(r.A.shape[1], device=self.device)
            if family is None:
                out[r.req_id] = RidgeSolution(
                    req_id=r.req_id, x=zero, delta_tilde=float("nan"), m_final=0,
                    iters=0, doublings=0, shape_class=cls, batch_index=-1,
                    sketch=sketch, compute_dtype=cd, status=name, converged=False)
            elif isinstance(family, tuple):
                out[r.req_id] = PathSolution(
                    req_id=r.req_id, points=tuple(PathPoint(
                        nu=v, x=zero, delta_tilde=float("nan"), m_final=0, iters=0,
                        doublings=0, status=name, converged=False) for v in r.nus),
                    shape_class=cls, batch_index=-1, sketch=sketch, compute_dtype=cd,
                    status=name, converged=False, sketch_passes=0)
            else:
                out[r.req_id] = GLMSolution(
                    req_id=r.req_id, x=zero, family=family, decrement=float("nan"),
                    converged=False, newton_iters=0, m_trajectory=(), m_final=0,
                    inner_iters=0, shape_class=cls, batch_index=-1, sketch=sketch,
                    compute_dtype=cd, status=name)
            self.stats["deadline_exceeded"] += 1
        return out

    # -- the λ-free ladder cache ---------------------------------------------
    def _ladder_fingerprint(self, A, lam_diag, cls: ShapeClass, sketch: str,
                            cd: str) -> str:
        """Content identity of a slot's λ-free ladder: SHA-1 of the class,
        the family, the sketch-pass dtype and every byte of A and Λ (fp32,
        C order; Λ, not ν: the ladder Grams are λ-free). A costs one copy
        to the host."""
        h = hashlib.sha1()
        h.update(f"{cls.n}x{cls.d}x{cls.m_max}:{sketch}:{cd}:".encode())
        h.update(A.detach().to(torch.float32).contiguous().cpu().numpy().tobytes())
        h.update(b"|lam:")
        if lam_diag is not None:
            h.update(lam_diag.detach().to(torch.float32).contiguous().cpu()
                     .numpy().tobytes())
        return h.hexdigest()

    @staticmethod
    def _fp_slot_id(fp: str) -> int:
        """The sketch id of a fingerprinted slot: the same content draws the
        same sketch. Bit 31 is clear, so the ids never meet the padded
        slots' reserved ones."""
        return int(fp[:8], 16) & 0x7FFFFFFF

    def _ladder_assets(self, cls: ShapeClass, fps: list[str], q: Quadratic,
                       seeds: torch.Tensor, sketch: str, cd: str):
        """A chunk's λ-free ladder through the cache. All real slots cached:
        the (L, B, d, d) Grams and the (B, d, d) true Gram are assembled
        from the stored slices and the chunk skips its sketch pass (padded
        slots have A = 0, so zero Grams). Any miss: one pass for the whole
        chunk (``prepare_path_ladder``), and the new slices are stored.
        Returns ``(grams, gram_full, skipped)``."""
        B, dev = self.batch_size, self.device
        hits = [fp in self._ladder_store for fp in fps]
        if all(hits):
            L = len(doubling_ladder(cls.m_max))
            grams = torch.zeros((L, B, cls.d, cls.d), device=dev)
            gfull = torch.zeros((B, cls.d, cls.d), device=dev)
            for i, fp in enumerate(fps):
                grams[:, i], gfull[i] = self._ladder_store[fp]
                self._ladder_store.move_to_end(fp)
            self.stats["ladder_cache_hits"] += len(fps)
            self.stats["sketch_passes_saved"] += 1
            return grams, gfull, True
        grams, gfull = prepare_path_ladder(q, seeds, m_max=cls.m_max, sketch=sketch,
                                           gram_hvp=True, compute_dtype=cd, mesh=self.mesh,
                                           device=dev)
        for i, (fp, hit) in enumerate(zip(fps, hits)):
            if hit:
                self.stats["ladder_cache_hits"] += 1
                self._ladder_store.move_to_end(fp)
            else:
                self.stats["ladder_cache_misses"] += 1
                self._ladder_store[fp] = (grams[:, i].clone(), gfull[i].clone())
        while len(self._ladder_store) > self.ladder_cache_size:
            self._ladder_store.popitem(last=False)
        return grams, gfull, False

    def _pack_cached(self, cls: ShapeClass, reqs, sketch: str, cd: str):
        """``_pack``, and under the ladder cache the chunk's ladder with the
        slots keyed by fingerprint. Returns (q, seeds, grams, gram_full,
        skipped); grams and gram_full are None without the cache."""
        with trace.span("service.pack"):
            if not self.ladder_cache:
                return (*self._pack(cls, reqs), None, None, False)
            fps = [r.fp or self._ladder_fingerprint(r.A, r.lam_diag, cls, sketch, cd)
                   for r in reqs]
            q, seeds = self._pack(cls, reqs, slot_ids=[self._fp_slot_id(f) for f in fps])
            return (q, seeds, *self._ladder_assets(cls, fps, q, seeds, sketch, cd))

    def _finish_chunk(self, n_reqs: int) -> None:
        if self.device.type == "cuda":
            with trace.span("service.sync"):
                torch.cuda.synchronize(self.device)
        self.stats["batches"] += 1
        self.stats["padded_slots"] += self.batch_size - n_reqs

    def _solve_path_chunk(self, cls: ShapeClass, reqs: list[PathRequest]):
        """One packed chunk of grids: one shared λ-free ladder (from the
        cache or one sketch pass), then warm-started robust solves point by
        point (``core.robust.robust_path_solve_batched``)."""
        P = len(reqs[0].nus)
        sketch = cls.sketch or self.sketch
        cd = cls.compute_dtype or self.compute_dtype
        # the ridge packer, with a placeholder ν: the path reads the grid
        proxies = [RidgeRequest(req_id=r.req_id, A=r.A, y=r.y, nu=1.0, lam_diag=r.lam_diag,
                                deadline=r.deadline, b=r.b, fp=r.fp) for r in reqs]
        q, seeds, grams, gfull, skipped = self._pack_cached(cls, proxies, sketch, cd)
        nus = torch.ones((P, self.batch_size))
        for i, r in enumerate(reqs):
            nus[:, i] = torch.tensor(r.nus)
        xs, stats = robust_path_solve_batched(
            q, seeds, nus.to(self.device), m_max=cls.m_max, method=self.method,
            sketch=sketch, max_iters=self.max_iters, rho=self.rho, tol=self.tol,
            max_retries=self.max_retries, fallback=self.fallback, compute_dtype=cd,
            grams=grams, gram_full=gfull, mesh=self.mesh, device=self.device)
        self._finish_chunk(len(reqs))
        self.stats["trips_run"] += stats["trips_run"]
        self.stats["trips_needed"] += stats["trips"]
        passes = int(stats["sketch_passes"]) - (1 if skipped else 0)
        out = {}
        with trace.span("service.answers"):
            for i, r in enumerate(reqs):
                di = r.A.shape[1]
                pts = []
                for p in range(P):
                    self.stats["retries"] += int(stats["retries"][p, i])
                    self.stats["fallbacks"] += int(stats["fell_back"][p, i])
                    pts.append(PathPoint(
                        nu=r.nus[p], x=xs[p, i, :di],
                        delta_tilde=float(stats["dtilde"][p, i]),
                        m_final=int(stats["m_final"][p, i]),
                        iters=int(stats["iters"][p, i]),
                        doublings=int(stats["doublings"][p, i]),
                        status=status_name(stats["status"][p, i]),
                        converged=bool(stats["converged"][p, i]),
                        retries=int(stats["retries"][p, i]),
                        fell_back=bool(stats["fell_back"][p, i])))
                bad = [pt for pt in pts if not pt.converged]
                out[r.req_id] = PathSolution(
                    req_id=r.req_id, points=tuple(pts), shape_class=cls, batch_index=i,
                    sketch=sketch, compute_dtype=cd,
                    status=bad[0].status if bad else "OK", converged=not bad,
                    cache_hit=skipped, sketch_passes=passes)
        return out

    def _solve_glm_chunk(self, cls: ShapeClass, family: str, reqs: list[GLMRequest],
                         budget_s: float | None = None):
        A, y, nu, lam, seeds = self._pack_glm(cls, reqs)
        sketch = cls.sketch or self.sketch
        cd = cls.compute_dtype or self.compute_dtype
        x, stats = adaptive_newton_solve_batched(
            family, A, y, nu, lam_diag=lam, seeds=seeds, m_max=cls.m_max,
            method=self.method, sketch=sketch, newton_iters=self.newton_iters,
            tol=self.newton_tol, inner_max_iters=self.max_iters, rho=self.rho,
            inner_tol=self.tol, compute_dtype=cd, deadline_s=budget_s,
            mesh=self.mesh, device=self.device)
        self._finish_chunk(len(reqs))
        out = {}
        with trace.span("service.answers"):
            host = {k: v.cpu() for k, v in stats.items() if torch.is_tensor(v)}
            m_traj = stats["m_trajectory"]                       # (T, B)
            for i, r in enumerate(reqs):
                if int(host["status"][i]) == int(SolveStatus.DEADLINE_EXCEEDED):
                    self.stats["deadline_exceeded"] += 1
                out[r.req_id] = GLMSolution(
                    req_id=r.req_id, x=x[i, :r.A.shape[1]], family=family,
                    decrement=float(host["decrement"][i]),
                    converged=bool(host["converged"][i]),
                    newton_iters=int(host["newton_iters"][i]),
                    m_trajectory=tuple(int(m) for m in m_traj[:, i] if m > 0),
                    m_final=int(host["m_final"][i]),
                    inner_iters=int(host["inner_iters"][i]),
                    shape_class=cls, batch_index=i, sketch=sketch, compute_dtype=cd,
                    status=status_name(host["status"][i]),
                    stalled=bool(host["stalled"][i]))
        return out

    def _solve_chunk(self, cls: ShapeClass, reqs: list[RidgeRequest],
                     budget_s: float | None = None):
        sketch = cls.sketch or self.sketch
        cd = cls.compute_dtype or self.compute_dtype
        q, seeds, grams, gfull, skipped = self._pack_cached(cls, reqs, sketch, cd)
        # a budget, a checkpoint directory or a preemption flag routes the
        # solve through the segmented driver; with none the call, and its
        # numbers, are the monolithic ones
        seg = {}
        if budget_s is not None or self.checkpoint_dir is not None or self.preempt is not None:
            seg = dict(deadline_s=budget_s, segment_trips=self.segment_trips,
                       checkpoint=self._chunk_checkpoint(cls, reqs), preempt=self.preempt)
        x, stats = robust_padded_solve_batched(
            q, seeds, m_max=cls.m_max, method=self.method, sketch=sketch,
            max_iters=self.max_iters, rho=self.rho, tol=self.tol,
            max_retries=self.max_retries, fallback=self.fallback,
            compute_dtype=cd, grams=grams, gram_full=gfull, mesh=self.mesh,
            device=self.device, **seg)
        self._finish_chunk(len(reqs))
        self.stats["segments"] += stats["segments"]
        self.stats["resumed_chunks"] += int(stats["resumed"])
        self.stats["trips_run"] += stats["trips_run"]
        self.stats["trips_needed"] += stats["trips"]
        out = {}
        with trace.span("service.answers"):
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
                    fell_back=bool(stats["fell_back"][i]),
                    cache_hit=skipped)
        return out

    def solve_one(self, A, y, nu, lam_diag=None) -> RidgeSolution:
        """Convenience: submit + flush a single request (still batched —
        the padded slots ride along as no-op problems)."""
        rid = self.submit(A, y, nu, lam_diag)
        return self.flush()[rid]
