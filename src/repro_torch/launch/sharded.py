"""Rank programs of the sharded pass, for ``launch.mesh.run_ranks``.

``run_tasks(mesh, payload)`` runs a list of named tasks on every rank and
returns ``{name: result}``; each task takes the full problem from the
payload (every rank holds the same one), cuts its own row block out of it
(``core.distributed.shard_quadratic``) and returns replicated results on
the CPU. The tests, ``chip_smoke.py`` and ``launch/serve.py --mesh`` drive
the sharded code through these, so a spawned rank imports only the port.

Payload: ``{"tasks": [(name, kind, args), ...]}`` with ``kind`` one of
``TASKS``; each rank computes on its mesh's device (``launch.mesh.rank_device``,
the ``device`` given to ``run_ranks``); ``launches`` holds each task's
kernel launches per Pallas body (``ops.BODY_LAUNCHES``) on this rank:

* ``"pass"``: args ``q`` (the full batched problem on the CPU), ``seeds``,
  ``ladder``, ``sketch``, ``compute_dtype`` → ``grams`` (the summed pass),
  ``per_shard`` and ``cache_total`` (``ShardLadderCache.from_mesh``); with
  ``time_reps`` also ``allreduce_ms`` (median, CUDA events on the card) and
  ``allreduce_bytes`` of the (L, B, d, d) stack;
* ``"weighted_gram"``: ``q`` (weighted) → ``gram``;
* ``"block_sketch"``: ``A``, ``seed``, ``kind``, ``m``, ``s`` → ``SA``, and
  with ``nu`` and ``v`` also ``solve``, H_S⁻¹v of
  ``distributed_sketch_and_factorize``;
* ``"engine"``: ``q``, ``seeds`` and ``padded_adaptive_solve_batched``'s
  keywords (``kw``) → ``x`` and ``stats``, through ``sharded_padded_solve``;
* ``"robust"``: the same through ``robust_padded_solve_batched``;
* ``"segmented"``: ``q``, ``seeds`` and ``segmented_padded_solve_batched``'s
  keywords (``kw``), optional ``deadlines`` (each rank's own ``deadline_s``,
  by rank, in place of kw's), ``checkpoint`` (a directory every rank
  shares, or a list of one directory a rank), ``resume`` and ``preempt`` =
  (rank, poll): that rank's flag turns on at its poll-th read, every other
  rank's stays off → ``x``,
  ``stats`` (with ``segments``, ``deadline_hit``, ``resumed``,
  ``verdicts``, ``verdict_s``), ``preempted`` (the segment of the
  ``PreemptedError``, else None), ``saves`` (checkpoints this rank wrote),
  ``wall_s``; a ``ValueError`` (a fingerprint mismatch) comes back as
  ``error``;
* ``"newton"``: ``A``, ``y``, ``nu`` and ``adaptive_newton_solve_batched``'s
  keywords (``kw``) → ``x`` and ``stats``;
* ``"service"``: ``requests`` [(A, y, ν)] (or the keywords of
  ``ridge_requests``, which each rank then draws on its device one at a
  time, submitting each before it draws the next), optional ``glm``
  [(A, y, ν)] (logistic) and ``paths`` [(A, y, ν grid)], ``service``
  (``SolverService`` keywords) and ``deadlines`` (each ridge request's
  ``deadline_s`` or None) → per request x, δ̃, m_final, iters, status
  (a GLM answer its decrement and convergence, a path its points' x and
  statuses), the service's stats, the rows of each ridge and path request
  that the rank kept queued, the request ids in the order the flush
  answered them (its dispatch order) and the flush's wall seconds;
* ``"meshes"``: no args → the shapes, data dims and this rank's data index
  of ``launch.mesh.make_host_mesh()`` and ``make_elastic_mesh(world)``;
* ``"imports"``: no args → the top-level packages of JAX or the reference
  that this rank has loaded (none, the port standing alone).
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import torch
import torch.distributed as dist

from repro_torch.core import distributed as D
from repro_torch.core.quadratic import Quadratic


def _to(q: Quadratic, dev) -> Quadratic:
    return Quadratic(**{f.name: (getattr(q, f.name).to(dev)
                                 if torch.is_tensor(getattr(q, f.name))
                                 else getattr(q, f.name))
                        for f in dataclasses.fields(q)})


def _cpu(obj):
    if torch.is_tensor(obj):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    return obj


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pass(mesh, dev, a):
    q = D.shard_quadratic(_to(a["q"], dev), mesh)
    seeds = a["seeds"].to(dev)
    kw = dict(compute_dtype=a.get("compute_dtype"))
    out = {"grams": D.shard_level_grams(a["sketch"], seeds, q, a["ladder"], mesh, **kw),
           "per_shard": D.shard_level_grams_per_shard(a["sketch"], seeds, q, a["ladder"],
                                                      mesh, **kw),
           "cache_total": D.ShardLadderCache.from_mesh(a["sketch"], seeds, q, a["ladder"],
                                                       mesh, **kw).total()}
    reps = a.get("time_reps", 0)
    if reps:
        buf = out["grams"].clone()
        times = []
        for _ in range(reps + 2):
            dist.barrier()                        # the ranks start together
            _sync(dev)
            t0 = time.perf_counter()
            D.all_reduce_sum(buf, mesh)
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        out["allreduce_ms"] = sorted(times[2:])[reps // 2]
        out["allreduce_bytes"] = buf.numel() * buf.element_size()
    return out


def _weighted_gram(mesh, dev, a):
    return {"gram": D.shard_weighted_gram(D.shard_quadratic(_to(a["q"], dev), mesh), mesh)}


def _block_sketch(mesh, dev, a):
    A = a["A"].to(dev)
    n_loc = A.shape[0] // D.n_data_shards(mesh)
    k = D.data_index(mesh)
    block = A[k * n_loc:(k + 1) * n_loc].contiguous()
    out = {"SA": D.block_sketch_gram(block, a["seed"], a["kind"], a["m"], mesh,
                                     s=a.get("s", 1))}
    if "nu" in a:
        d = A.shape[1]
        q = Quadratic(A=block, b=torch.zeros(d, device=dev), nu=torch.tensor(a["nu"]),
                      lam_diag=torch.ones(d, device=dev))
        P = D.distributed_sketch_and_factorize(q, a["seed"], a["kind"], a["m"], mesh,
                                               s=a.get("s", 1))
        out["solve"] = P.solve(a["v"].to(dev))
    return out


def _engine(mesh, dev, a):
    x, stats = D.sharded_padded_solve(_to(a["q"], dev), a["seeds"].to(dev), mesh,
                                      device=dev, **a["kw"])
    return {"x": x, "stats": {k: v for k, v in stats.items() if torch.is_tensor(v)}}


def _robust(mesh, dev, a):
    from repro_torch.core.robust import robust_padded_solve_batched

    q = D.shard_quadratic(_to(a["q"], dev), mesh)
    x, stats = robust_padded_solve_batched(q, a["seeds"].to(dev), mesh=mesh, device=dev,
                                           **a["kw"])
    return {"x": x, "stats": {k: v for k, v in stats.items() if torch.is_tensor(v)}}


def _segmented(mesh, dev, a):
    from repro_torch.core.robust import PreemptedError, segmented_padded_solve_batched
    from repro_torch.ft.checkpoint import CheckpointManager

    class Counting(CheckpointManager):
        saves = 0

        def save(self, *args, **kwargs):
            self.saves += 1
            return super().save(*args, **kwargs)

    class FlagAt:
        """Turns on at its ``poll``-th read, on rank ``rank`` only."""

        def __init__(self, rank, poll):
            self.on_this_rank, self.poll, self.reads = rank == D.data_index(mesh), poll, 0

        @property
        def should_stop(self):
            self.reads += 1
            return self.on_this_rank and self.reads >= self.poll

    rank = D.data_index(mesh)
    q = D.shard_quadratic(_to(a["q"], dev), mesh)
    ck = a.get("checkpoint")
    ckpt = Counting(ck[rank] if isinstance(ck, (list, tuple)) else ck) if ck else None
    preempt = FlagAt(*a["preempt"]) if a.get("preempt") else None
    kw = dict(a["kw"])
    if a.get("deadlines") is not None:
        kw["deadline_s"] = a["deadlines"][rank]
    out = {"preempted": None, "error": None}
    _sync(dev)
    t0 = time.perf_counter()
    try:
        x, stats = segmented_padded_solve_batched(
            q, a["seeds"].to(dev), checkpoint=ckpt, resume=a.get("resume", True),
            preempt=preempt, mesh=mesh, device=dev, **kw)
        out.update(x=x, stats=dict(stats))
    except PreemptedError as e:
        out["preempted"] = e.segment
    except ValueError as e:
        out["error"] = str(e)
    _sync(dev)
    out.update(wall_s=time.perf_counter() - t0, saves=0 if ckpt is None else ckpt.saves,
               deadline_s=kw.get("deadline_s"))
    return out


def _newton(mesh, dev, a):
    from repro_torch.core.newton import adaptive_newton_solve_batched

    x, stats = adaptive_newton_solve_batched(
        a.get("family", "logistic"), a["A"].to(dev), a["y"].to(dev), a["nu"], mesh=mesh,
        device=dev, **a["kw"])
    return {"x": x, "stats": {k: v for k, v in stats.items() if torch.is_tensor(v)}}


def ridge_request(g: torch.Generator, device, n_range, d_range, decay: float = 0.95):
    """One ridge request (A, y, ν) from generator ``g`` on ``device``:
    A = U·diag(decay^i)·Vᵀ with orthonormal U, V (ill-conditioned, so the
    ladders climb), y ~ N(0, I), ν log-uniform in [1e-3, 1e-1]; n and d
    uniform in their inclusive ranges."""
    n = int(torch.randint(n_range[0], n_range[1] + 1, (), generator=g, device=device))
    d = int(torch.randint(d_range[0], d_range[1] + 1, (), generator=g, device=device))
    U, _ = torch.linalg.qr(torch.randn((n, d), generator=g, device=device))
    V, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=device))
    sv = decay ** torch.arange(d, device=device, dtype=torch.float32)
    A = (U * sv[None, :]) @ V.T
    y = torch.randn((n,), generator=g, device=device)
    nu = 10.0 ** (-3.0 + 2.0 * float(torch.rand((), generator=g, device=device)))
    return A, y, nu


def ridge_requests(seed: int, count: int, n_range, d_range, device, decay: float = 0.95):
    """Yields ``count`` ``ridge_request``s, one at a time, from a generator
    seeded ``seed``: the same requests in every process that asks on the
    same kind of device."""
    g = torch.Generator(device=device).manual_seed(seed)
    for _ in range(count):
        yield ridge_request(g, device, n_range, d_range, decay)


def _service(mesh, dev, a):
    from repro_torch.serve.solver_service import SolverService

    svc = SolverService(mesh=mesh, device=dev, **a.get("service", {}))
    reqs = a["requests"]
    if isinstance(reqs, dict):
        reqs = ridge_requests(device=dev, **reqs)
    deadlines = a.get("deadlines") or itertools.repeat(None)
    ids = [svc.submit(A.to(dev), y.to(dev), nu, deadline_s=dl)
           for (A, y, nu), dl in zip(reqs, deadlines)]
    glm = [svc.submit_glm(A.to(dev), y.to(dev), nu) for A, y, nu in a.get("glm", ())]
    paths = [svc.submit_path(A.to(dev), y.to(dev), nus) for A, y, nus in a.get("paths", ())]
    queued = [r.A.shape[0] for store in (svc._queues, svc._path_queues)
              for queue in store.values() for r in queue]
    dist.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    sols = svc.flush()
    _sync(dev)
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "stats": dict(svc.stats), "queued_rows": queued,
            "order": list(sols),
            "answers": [dict(x=sols[i].x, delta_tilde=sols[i].delta_tilde,
                             m_final=sols[i].m_final, iters=sols[i].iters,
                             status=sols[i].status, shape_class=tuple(sols[i].shape_class))
                        for i in ids],
            "glm": [dict(x=sols[i].x, decrement=sols[i].decrement,
                         converged=sols[i].converged, status=sols[i].status) for i in glm],
            "paths": [dict(xs=torch.stack([p.x for p in sols[i].points]),
                           statuses=[p.status for p in sols[i].points],
                           iters=[p.iters for p in sols[i].points]) for i in paths]}


def _meshes(mesh, dev, a):
    from repro_torch.launch.mesh import make_elastic_mesh, make_host_mesh

    out = {}
    for name, m in (("host", make_host_mesh(device_type=dev.type)),
                    ("elastic", make_elastic_mesh(dist.get_world_size(),
                                                  device_type=dev.type))):
        out[name] = dict(shape=tuple(m.shape), names=tuple(m.mesh_dim_names),
                         data_axes=D.data_axes(m), n_data_shards=D.n_data_shards(m),
                         data_index=D.data_index(m))
    return out


def _imports(mesh, dev, a):
    import sys

    return sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"})


TASKS = {"pass": _pass, "weighted_gram": _weighted_gram, "block_sketch": _block_sketch,
         "engine": _engine, "robust": _robust, "segmented": _segmented, "newton": _newton,
         "service": _service, "meshes": _meshes, "imports": _imports}


def run_tasks(mesh, payload: dict) -> dict:
    """Every task of the payload, in order, on this rank (module docstring)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import rank_device

    dev = rank_device(mesh)
    if dev.type == "cuda":
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": D.data_index(mesh), "launches": {}}
    for name, kind, args in payload["tasks"]:
        before = dict(ops.BODY_LAUNCHES)
        out[name] = _cpu(TASKS[kind](mesh, dev, args))
        out["launches"][name] = {k: v - before[k] for k, v in ops.BODY_LAUNCHES.items()}
    return out
