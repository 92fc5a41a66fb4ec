"""The audited surface: every public entry point of the port, run under the
op recorder at small shapes.

Port of ``repro.analysis.audit.entrypoints``, with the same names (55 in
all, 22 in ``quick``) and shapes. The registry is built from the port's own
``PADDED_SKETCHES``, ``PADDED_METHODS``, ``COMPUTE_DTYPES`` and
``DEFAULT_SHAPE_CLASSES``, so a new family, method, dtype or service class
is audited the moment it exists.

``port_targets()`` adds the entry points the reference has no counterpart
of (the sharded drivers' host verdicts); the runner audits both lists.

Each ``EntryPoint.build(device)`` runs its entry point under
``op_trace.record`` on ``device`` with inputs from a seeded
``torch.Generator`` there, and returns the trace. The sharded entry points
have ``rank_build(mesh, device)`` instead: the runner runs them in one rank
of ``launch.mesh.run_ranks`` (``rank_traces``), gloo on the CPU and a
one-rank NCCL group on the card, and each returns its trace.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.adaptive_padded import (
    PADDED_METHODS,
    doubling_ladder,
    finalize_padded_solve,
    padded_adaptive_solve_batched,
    padded_path_solve_batched,
    padded_solve_segment,
    prepare_padded_solve,
    prepare_path_ladder,
)
from repro_torch.core.level_grams import PADDED_SKETCHES, get_provider
from repro_torch.core.quadratic import Quadratic
from repro_torch.kernels.precision import COMPUTE_DTYPES

from . import op_trace as ot

# Audit shapes (the reference's): big enough that the memory claims bind,
# small enough that every d × d factorization is instant; n is not a power
# of two, so the SRHT's padded path runs.
B, N, D, M_MAX = 3, 2000, 16, 128
SEGMENT_TRIPS = 8
GRID_POINTS = 3


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One audited entry point: ``build(device)`` runs it under the recorder
    and returns its ``OpTrace``; a sharded one has ``rank_build(mesh,
    device)``, run inside a rank."""

    name: str
    kind: str          # provider | engine | segment | path | sharded | newton | service
    build: Callable[[torch.device], ot.OpTrace] | None
    meta: dict
    rank_build: Callable[[object, torch.device], ot.OpTrace] | None = None


def problem(device, *, b: int = B, n: int = N, d: int = D, weighted: bool = False,
            seed: int = 0) -> tuple[Quadratic, torch.Tensor]:
    """A seeded batched ridge problem (A ~ N(0, 1/n), ν = 0.1, Λ = I) and its
    (b,) uint32 seeds, made on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((b, n, d), generator=g, device=device) / n ** 0.5
    q = Quadratic(A=A, b=torch.randn((b, d), generator=g, device=device),
                  nu=torch.full((b,), 0.1, device=device),
                  lam_diag=torch.ones((b, d), device=device), batched=True,
                  row_weights=(torch.rand((b, n), generator=g, device=device) + 0.5
                               if weighted else None))
    seeds = torch.randint(0, 2 ** 32, (b,), generator=g, device=device, dtype=torch.int64)
    return q, seeds


def _meta(**kw) -> dict:
    return {"B": B, "n": N, "d": D, "m_max": M_MAX, **kw}


def provider_trace(family: str, cd: str | None, weighted: bool, device) -> ot.OpTrace:
    """One family's one-touch pass (sample + level Grams) at the audit shapes."""
    q, seeds = problem(device, weighted=weighted)
    prov = get_provider(family)
    ladder = doubling_ladder(M_MAX)
    return ot.record(lambda: prov.level_grams(prov.sample(seeds, M_MAX, N), q, ladder,
                                              compute_dtype=cd),
                     watch=[q.A], device=device)


def _provider_ep(family: str, cd: str, weighted: bool) -> EntryPoint:
    w = "weighted" if weighted else "unweighted"
    return EntryPoint(
        name=f"provider:{family}:{cd}:{w}", kind="provider",
        build=lambda dev: provider_trace(family, cd, weighted, dev),
        meta=_meta(family=family, compute_dtype=cd, weighted=weighted))


def _engine_ep(family: str, method: str, cd: str) -> EntryPoint:
    def build(dev):
        q, seeds = problem(dev)
        return ot.record(lambda: padded_adaptive_solve_batched(
            q, seeds, m_max=M_MAX, method=method, sketch=family, compute_dtype=cd,
            device=dev), watch=[q.A], device=dev)

    return EntryPoint(name=f"engine:{family}:{method}:{cd}", kind="engine", build=build,
                      meta=_meta(family=family, method=method, compute_dtype=cd))


def _segment_ep() -> EntryPoint:
    """One re-dispatched segment and finalize, from a prepared state
    (``prepare`` runs before the recorder starts)."""

    def build(dev):
        q, seeds = problem(dev)
        pre, st = prepare_padded_solve(q, seeds, m_max=M_MAX, device=dev)
        return ot.record(lambda: finalize_padded_solve(
            pre, padded_solve_segment(q, pre, st, SEGMENT_TRIPS, method="pcg", device=dev),
            m_max=M_MAX, device=dev), watch=[q.A], device=dev)

    return EntryPoint(name="engine:segment:pcg:fp32", kind="segment", build=build,
                      meta=_meta(family="gaussian", method="pcg", compute_dtype="fp32"))


def _path_ladder_ep(family: str) -> EntryPoint:
    """The λ-free path precompute: the one-touch ladder pass and the true
    Gram that one whole λ grid shares (the unit the ladder cache stores)."""

    def build(dev):
        q, seeds = problem(dev)
        return ot.record(lambda: prepare_path_ladder(q, seeds, m_max=M_MAX, sketch=family,
                                                     device=dev),
                         watch=[q.A], device=dev)

    return EntryPoint(name=f"path:ladder:{family}", kind="path", build=build,
                      meta=_meta(family=family, compute_dtype="fp32"))


def path_grid_trace(family: str, points: int, device) -> ot.OpTrace:
    """A whole λ grid of ``points`` warm-started solves off one ladder pass."""
    q, seeds = problem(device)
    nus = torch.logspace(-1, -2, points, device=device)
    return ot.record(lambda: padded_path_solve_batched(
        q, seeds, nus, m_max=M_MAX, method="pcg", sketch=family, device=device),
        watch=[q.A], device=device)


def _path_grid_ep(family: str, points: int = GRID_POINTS) -> EntryPoint:
    """The full grid; ``a_ref_build`` gives the one-touch rule the one-point
    run, so it can check that the grid adds no consumer of A."""
    return EntryPoint(
        name=f"path:grid:{family}", kind="path",
        build=lambda dev: path_grid_trace(family, points, dev),
        meta=_meta(family=family, method="pcg", compute_dtype="fp32", grid_points=points,
                   a_ref_build=lambda dev: path_grid_trace(family, 1, dev)))


def _rank_problem(mesh, dev, weighted=False):
    from repro_torch.core.distributed import shard_quadratic

    q, seeds = problem(dev, weighted=weighted)
    return shard_quadratic(q, mesh), seeds


def _sharded_ep(family: str) -> EntryPoint:
    """The one-all-reduce ladder pass, in a rank of a one-rank group: the
    collective inventory does not depend on the rank count."""

    def rank_build(mesh, dev):
        from repro_torch.core.distributed import shard_level_grams

        q, seeds = _rank_problem(mesh, dev)
        return ot.record(lambda: shard_level_grams(family, seeds, q, doubling_ladder(M_MAX),
                                                   mesh),
                         watch=[q.A], device=dev)

    L = len(doubling_ladder(M_MAX))
    return EntryPoint(name=f"sharded:{family}:fp32", kind="sharded", build=None,
                      rank_build=rank_build,
                      meta=_meta(family=family, compute_dtype="fp32", psum_budget=1,
                                 psum_shapes=[(L, B, D, D)]))


def _path_sharded_ep() -> EntryPoint:
    """The sharded path precompute: the per-shard one-touch pass and one
    all-reduce of the (L, B, d, d) level Grams serve the whole λ grid, and
    the true Gram takes one all-reduce of its own. The reference's jaxpr
    shows one psum because GSPMD inserts the true Gram's reduction below
    it; the port's all-reduces are all explicit, so its inventory lists
    both."""

    def rank_build(mesh, dev):
        q, seeds = _rank_problem(mesh, dev)
        return ot.record(lambda: prepare_path_ladder(q, seeds, m_max=M_MAX, sketch="gaussian",
                                                     mesh=mesh, device=dev),
                         watch=[q.A], device=dev)

    L = len(doubling_ladder(M_MAX))
    return EntryPoint(name="path:sharded:gaussian:fp32", kind="sharded", build=None,
                      rank_build=rank_build,
                      meta=_meta(family="gaussian", compute_dtype="fp32", psum_budget=2,
                                 psum_shapes=[(L, B, D, D), (B, D, D)]))


def _sharded_weighted_gram_ep() -> EntryPoint:
    def rank_build(mesh, dev):
        from repro_torch.core.distributed import shard_weighted_gram

        q, _ = _rank_problem(mesh, dev, weighted=True)
        return ot.record(lambda: shard_weighted_gram(q, mesh), watch=[q.A], device=dev)

    return EntryPoint(name="sharded:weighted_gram", kind="sharded", build=None,
                      rank_build=rank_build,
                      meta=_meta(family=None, compute_dtype="fp32", psum_budget=1,
                                 psum_shapes=[(B, D, D)]))


VERDICT_SHAPE = (2,)    # core.distributed.host_verdict's int32 (stop, expired)
RESUME_SHAPE = (1,)     # the lead rank's latest checkpoint step (lead_values)


def _segmented_mesh_trace(mesh, dev, *, preempt=None, **kw) -> ot.OpTrace:
    """A sharded segmented solve at the audit shapes that stops at its
    second segment boundary: two host verdicts, one a boundary. With
    ``preempt`` it checkpoints into a temporary directory."""
    import tempfile

    from repro_torch.core.robust import PreemptedError, segmented_padded_solve_batched

    q, seeds = _rank_problem(mesh, dev)
    with tempfile.TemporaryDirectory(prefix="audit_ckpt_") as ck:
        def fn():
            try:
                return segmented_padded_solve_batched(
                    q, seeds, m_max=M_MAX, segment_trips=SEGMENT_TRIPS, preempt=preempt,
                    checkpoint=None if preempt is None else ck, mesh=mesh, device=dev, **kw)
            except PreemptedError as e:
                return e

        return ot.record(fn, watch=[q.A], device=dev)


class _StopAtSecondPoll:
    """A preemption flag that turns on at its second read."""

    def __init__(self):
        self.reads = 0

    @property
    def should_stop(self):
        self.reads += 1
        return self.reads >= 2


def _mesh_ft_ep(what: str) -> EntryPoint:
    """The sharded segmented driver under a deadline that binds after the
    first segment, or with a checkpoint and a preemption flag that stops it
    at the second boundary: its precompute's all-reduces (the ladder's and
    the true Gram's, as ``path:sharded``), with a checkpoint the lead rank's
    latest step (one (1,) fp64 ``lead_values``: every rank resumes the same
    step, here none), and one (2,) int32 verdict a segment boundary, never
    one inside a trip."""

    def rank_build(mesh, dev):
        if what == "deadline":
            return _segmented_mesh_trace(mesh, dev, deadline_s=0.0)
        return _segmented_mesh_trace(mesh, dev, preempt=_StopAtSecondPoll())

    L = len(doubling_ladder(M_MAX))
    resume = [] if what == "deadline" else [RESUME_SHAPE]
    return EntryPoint(name=f"sharded:segmented:{what}:gaussian:fp32", kind="sharded",
                      build=None, rank_build=rank_build,
                      meta=_meta(family="gaussian", method="pcg", compute_dtype="fp32",
                                 psum_budget=4 + len(resume),
                                 psum_shapes=[(L, B, D, D), (B, D, D), *resume,
                                              VERDICT_SHAPE, VERDICT_SHAPE]))


def port_targets() -> list[EntryPoint]:
    """Entry points of the port beyond the reference's registry: the sharded
    drivers' host decisions (deadline, checkpoint and preemption under a
    mesh), which the reference's single controller makes without a
    collective."""
    return [_mesh_ft_ep("deadline"), _mesh_ft_ep("preempt")]


def _newton_inner_ep() -> EntryPoint:
    """The Newton driver's inner solve: the weighted engine with a warm
    ``init_level``, as ``core.newton`` runs it each step."""

    def build(dev):
        q, seeds = problem(dev, weighted=True)
        lvl = torch.full((B,), 3, dtype=torch.int64, device=dev)
        return ot.record(lambda: padded_adaptive_solve_batched(
            q, seeds, m_max=M_MAX, method="pcg", sketch="gaussian", init_level=lvl,
            device=dev), watch=[q.A], device=dev)

    return EntryPoint(name="newton:inner:gaussian:fp32", kind="newton", build=build,
                      meta=_meta(family="gaussian", method="pcg", compute_dtype="fp32",
                                 weighted=True))


def _newton_step_ep(family: str = "logistic") -> EntryPoint:
    """The driver's per-step pieces: gradient and Hessian weights, and the
    broadcast Armijo line search."""

    def build(dev):
        from repro_torch.core.newton import _line_search
        from repro_torch.core.objectives import get_objective, glm_grad_and_weights

        obj = get_objective(family)
        q, _ = problem(dev)
        g = torch.Generator(device=dev).manual_seed(1)
        y = (torch.rand((B, N), generator=g, device=dev) < 0.5).to(torch.float32)
        x = torch.zeros((B, D), device=dev)
        delta = torch.randn((B, D), generator=g, device=dev)
        active = torch.ones(B, dtype=torch.bool, device=dev)

        def fn():
            grad, w = glm_grad_and_weights(obj, q.A, y, q.nu, q.lam_diag, x)
            dec = -torch.sum(grad * delta, dim=-1)
            return _line_search(obj, q.A, y, q.nu, q.lam_diag, x, delta, dec, active,
                                backtracks=12, c1=1e-4), grad, w

        return ot.record(fn, watch=[q.A], device=dev)

    return EntryPoint(name=f"newton:step:{family}", kind="newton", build=build,
                      meta={"family": family, "compute_dtype": "fp32", "B": B, "n": N, "d": D})


def _service_pack_keys_ep() -> EntryPoint:
    """The pack path's slot seeds: one fold of the service seed over the
    slot-id vector (real slots: request ids; padded slots: 2³²−1−slot)."""

    def build(dev):
        from repro_torch.serve.solver_service import SolverService

        svc = SolverService(device=dev)
        return ot.record(lambda: svc._slot_seeds(svc._pad_ids(list(range(5)))), device=dev)

    return EntryPoint(name="service:pack_keys", kind="service", build=build,
                      meta={"compute_dtype": None})


def _service_class_ep(cls) -> EntryPoint:
    """The engine run a flush dispatches for one shape class, at the class's
    padded dims, sketch family and compute dtype."""
    fam = cls.sketch or "gaussian"
    cd = cls.compute_dtype or "fp32"

    def build(dev):
        q, seeds = problem(dev, b=4, n=cls.n, d=cls.d)
        return ot.record(lambda: padded_adaptive_solve_batched(
            q, seeds, m_max=cls.m_max, method="pcg", sketch=fam, compute_dtype=cd,
            device=dev), watch=[q.A], device=dev)

    return EntryPoint(
        name=f"service:class:n{cls.n}:d{cls.d}:{fam}:{cd}", kind="service", build=build,
        meta={"family": fam, "method": "pcg", "compute_dtype": cd,
              "B": 4, "n": cls.n, "d": cls.d, "m_max": cls.m_max})


def build_targets(quick: bool = False) -> list[EntryPoint]:
    """The whole audited surface, or the quick subset (one dtype, the
    engine's default method, the smallest service class)."""
    from repro_torch.serve.solver_service import DEFAULT_SHAPE_CLASSES

    eps: list[EntryPoint] = []
    dtypes = ("fp32",) if quick else COMPUTE_DTYPES
    for family in PADDED_SKETCHES:
        for cd in dtypes:
            for weighted in (False, True):
                eps.append(_provider_ep(family, cd, weighted))
    for family in PADDED_SKETCHES:
        eps.append(_engine_ep(family, "pcg", "fp32"))
    if not quick:
        for method in PADDED_METHODS:
            if method != "pcg":
                eps.append(_engine_ep("gaussian", method, "fp32"))
        for cd in ("bf16", "int8"):
            eps.append(_engine_ep("gaussian", "pcg", cd))
    eps.append(_segment_ep())
    for family in PADDED_SKETCHES:
        if quick and family != "gaussian":
            continue
        eps.append(_path_ladder_ep(family))
        eps.append(_path_grid_ep(family))
    for family in PADDED_SKETCHES:
        if quick and family != "gaussian":
            continue
        eps.append(_sharded_ep(family))
    eps.append(_path_sharded_ep())
    eps.append(_sharded_weighted_gram_ep())
    eps.append(_newton_inner_ep())
    eps.append(_newton_step_ep("logistic"))
    eps.append(_service_pack_keys_ep())
    for cls in DEFAULT_SHAPE_CLASSES[:1] if quick else DEFAULT_SHAPE_CLASSES:
        eps.append(_service_class_ep(cls))
    return eps


def trace_in_ranks(eps: list[EntryPoint], device) -> dict[str, ot.OpTrace]:
    """Run the ``rank_build`` of every entry point in ``eps`` inside one
    rank of a one-rank group (gloo on the CPU, NCCL on the card), in one
    process; returns {name: trace}."""
    from repro_torch.launch.mesh import run_ranks

    dev = torch.device(device)
    names = [ep.name for ep in eps if ep.rank_build is not None]
    if not names:
        return {}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    return run_ranks("repro_torch.analysis.audit.entrypoints:rank_traces", 1,
                     {"names": names}, backend=backend, device=dev.type, timeout=600)[0]


def rank_traces(mesh, payload: dict) -> dict[str, ot.OpTrace]:
    """The rank program of ``trace_in_ranks``: each named entry point's (or
    fixture's) ``rank_build`` on this rank's device."""
    from repro_torch.launch.mesh import rank_device

    from .fixtures import fixture_targets

    dev = rank_device(mesh)
    if dev.type == "cuda":
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    eps = {ep.name: ep for ep in [*build_targets(), *port_targets(), *fixture_targets()]}
    return {name: eps[name].rank_build(mesh, dev).without_result()
            for name in payload["names"]}
