"""Row-sharded problems over ``torch.distributed``: the one-touch ladder
pass with one all-reduce, the per-shard Grams behind elastic recovery, and
the summed block sketch.

Port of ``repro.core.distributed``. The reference runs one controller over
a JAX mesh (``shard_map`` and ``psum``); here every rank is a process of
its own (``launch.mesh.run_ranks`` starts them) that holds its row block,
and a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``"data"``, and ``"model"``, which holds replicas) carries the process
groups. Rank k of the K data shards keeps rows [k·n/K, (k+1)·n/K) of A and
of its row weights, contiguous (``shard_quadratic``); b, ν and Λ are
replicated. Every function below that takes ``mesh`` takes that local
block as ``q`` (or ``A``), and returns replicated results.

* ``shard_level_grams``: each rank runs its family's one-touch pass on its
  block under ``fold_seeds(seed, k)``, and ONE all-reduce (sum) of the
  (L, B, d, d) fp32 stack over the data dims gives the Grams of the
  concatenated block sketch S = blockdiag(S_k): (SA)ᵀ(SA) = Σ_k (S_kA_k)ᵀ(S_kA_k)
  exactly, with no rescale (Gaussian entries are already N(0, 1/m); SJLT
  and SRHT blocks have E[S_kᵀS_k] = I). The all-reduce adds in the
  backend's order, not in shard order, so it matches the one-device
  ``level_grams.BlockEmulationProvider`` to rounding, not bitwise.
* ``shard_level_grams_per_shard``: the same pass, gathered as (K, L, B, d,
  d) in rank order by an all-reduce of a zero-filled buffer in which each
  rank writes only its slice (x + 0 = x, so it is exact; gloo, which the
  ranks sharing one card use, all-reduces CUDA tensors but does not gather
  them). ``ShardLadderCache.from_mesh`` sums it in shard order, so its
  total is bitwise ``from_emulation``'s.
* ``block_sketch_gram``: the summed sketch SA = Σ_k S_kA_k of a global m
  rows (``core.sketches``), one all-reduce of (m, d); no rescale either.

The padded engine takes ``mesh=`` (``sharded_padded_solve``): its ladder
pass is ``shard_level_grams``, its true Gram the local AᵀA plus one
all-reduce, and with ``gram_hvp`` off its matrix-free H·v all-reduces AᵀAv
every trip, the only collective inside the loop. Everything after the
reductions is replicated, so every rank takes the same host decisions.

Host decisions. The reference has one controller, which reads one clock
and one signal; here every rank has its own. A decision that reads them
goes through one collective at a point every rank reaches on replicated
control flow: ``host_verdict`` (a MAX all-reduce of a (2,) int32: any
rank's preemption flag, and the lead rank's deadline, ``is_lead``) at a
segment boundary or between Newton steps, and ``lead_values`` (the lead
rank's fp64 budgets, one all-reduce in which the others send zeros)
before a retry or a flush's dispatch. The lead rank alone writes a
checkpoint of replicated state, and ``barrier`` holds the others until it
is committed.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .level_grams import fold_seeds, get_provider, shard_block, shard_quadratics
from .precond import factorize
from .quadratic import Quadratic, weighted_gram
from .sketches import make_sketch


def data_axes(mesh) -> tuple[str, ...]:
    """The mesh dims that shard data: every named dim but ``"model"``."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def _dim_size(mesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def n_data_shards(mesh) -> int:
    """The number of row shards: the product of the data dims' sizes."""
    k = 1
    for a in data_axes(mesh):
        k *= _dim_size(mesh, a)
    return k


def data_index(mesh) -> int:
    """This rank's row shard: its coordinates on the data dims, row-major."""
    idx = 0
    for a in data_axes(mesh):
        idx = idx * _dim_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the data dims, in place (one all-reduce a data dim);
    returns it."""
    for a in data_axes(mesh):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(a))
    return t


def is_lead(mesh) -> bool:
    """Whether this rank is the mesh's first (coordinate 0 on every dim):
    the rank whose clock the host decisions read."""
    return all(mesh.get_local_rank(a) == 0 for a in mesh.mesh_dim_names)


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` computes on: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _all_reduce_mesh(t: torch.Tensor, mesh, op) -> torch.Tensor:
    """``t`` reduced with ``op`` over every rank of the mesh (one all-reduce
    a mesh dim: one on a one-dimensional mesh), in place."""
    for a in mesh.mesh_dim_names:
        dist.all_reduce(t, op=op, group=mesh.get_group(a))
    return t


def host_verdict(mesh, *, stop: bool, expired: bool) -> tuple[bool, bool]:
    """One host decision for every rank: ``(stop, expired)`` after one MAX
    all-reduce of a 2-element int32 tensor over the whole mesh, on the
    rank's device. ``stop`` is any rank's own (a scheduler may preempt one
    host, and one preempted rank stops them all); ``expired`` is the lead
    rank's alone (``is_lead``: only its clock counts, the others send 0).
    Every rank must call it at the same point, on replicated control flow."""
    flags = torch.tensor([int(bool(stop)), int(bool(expired) and is_lead(mesh))],
                         dtype=torch.int32, device=mesh_device(mesh))
    stop_all, expired_all = _all_reduce_mesh(flags, mesh, dist.ReduceOp.MAX).tolist()
    return bool(stop_all), bool(expired_all)


def barrier(mesh) -> None:
    """Wait until every rank of the mesh reaches this point (one barrier a
    mesh dim): the lead rank's checkpoint is committed before any rank goes
    on."""
    for a in mesh.mesh_dim_names:
        dist.barrier(group=mesh.get_group(a))


def lead_values(mesh, values) -> list[float]:
    """The lead rank's fp64 ``values`` (a number or a sequence), on every
    rank: one SUM all-reduce over the whole mesh in which the other ranks
    send zeros (x + 0 = x exactly). The budgets of a sharded solve come
    from here, so every rank dispatches on the lead rank's clock."""
    seq = [float(v) for v in (values if isinstance(values, (list, tuple)) else [values])]
    t = torch.tensor(seq if is_lead(mesh) else [0.0] * len(seq), dtype=torch.float64,
                     device=mesh_device(mesh))
    return _all_reduce_mesh(t, mesh, dist.ReduceOp.SUM).tolist()


def _check_divisible(n: int, mesh) -> int:
    k = n_data_shards(mesh)
    if n % k:
        raise ValueError(f"n={n} not divisible by {k} data shards")
    return k


def shard_quadratic(q: Quadratic, mesh) -> Quadratic:
    """This rank's row block of q (a single problem, a per-problem batch or
    a shared-A batch), A and the row weights copied contiguous; b, ν and Λ
    as they are (replicated)."""
    return shard_block(q, _check_divisible(q.n, mesh), data_index(mesh))


def _local_level_grams(provider, seeds, q: Quadratic, ladder, mesh, compute_dtype):
    if not q.batched:
        raise ValueError("the sharded ladder pass expects a batched Quadratic")
    provider = get_provider(provider)
    data = provider.sample(fold_seeds(seeds, data_index(mesh)), ladder[-1], q.n)
    return provider.level_grams(data, q, ladder, compute_dtype=compute_dtype)


def shard_level_grams(provider, seeds: torch.Tensor, q: Quadratic, ladder, mesh,
                      compute_dtype: str | None = None) -> torch.Tensor:
    """(L, B, d, d) ladder-level Grams of the concatenated block sketch,
    replicated: this rank's one-touch pass on its block ``q`` (its weights
    folded in, ``compute_dtype`` applied to the pass only) under
    ``fold_seeds(seeds, k)``, then one all-reduce of the fp32 stack, an
    exact fp32 sum in every pass precision. ``seeds`` (B,) int64."""
    return all_reduce_sum(
        _local_level_grams(provider, seeds, q, ladder, mesh, compute_dtype), mesh)


def shard_level_grams_per_shard(provider, seeds: torch.Tensor, q: Quadratic, ladder,
                                mesh, compute_dtype: str | None = None) -> torch.Tensor:
    """(K, L, B, d, d) per-shard Grams, in rank order, replicated: the pass
    of ``shard_level_grams``, each rank's stack written into its slice of a
    zero-filled buffer that one all-reduce completes, bitwise."""
    g = _local_level_grams(provider, seeds, q, ladder, mesh, compute_dtype)
    buf = torch.zeros((n_data_shards(mesh),) + tuple(g.shape), dtype=g.dtype,
                      device=g.device)
    buf[data_index(mesh)] = g
    return all_reduce_sum(buf, mesh)


class ShardLadderCache:
    """Cached per-shard ladder-level Gram contributions and their running
    total: the state behind elastic mid-solve shard recovery.

    Built once from the same one-touch pass the engine would run:
    ``from_mesh``, the sharded pass gathered per shard, or
    ``from_emulation``, ``level_grams.BlockEmulationProvider``'s dataflow on
    one device, with the same ``fold_seeds(seed, k)`` per shard (so both
    builds hold the same stacks). ``total()`` feeds the segmented driver's
    ``grams=``; when shard k dies mid-solve, ``drop(k)`` updates the total
    by one (L, B, d, d) subtraction, touching no surviving shard's rows,
    and the new total reaches ``reprecondition_padded`` through the
    driver's ``on_segment`` hook (``ft.faults.ShardLossInjector``). The
    post-drop total is the block sketch Gram of the surviving shards: a
    weaker but valid preconditioner of the whole problem, whose Hessian
    never read the cache."""

    def __init__(self, shard_grams: torch.Tensor):
        if shard_grams.dim() != 5:
            raise ValueError(f"expected (K, L, B, d, d) shard Grams, got shape "
                             f"{tuple(shard_grams.shape)}")
        self.shard_grams = shard_grams
        self.n_shards = int(shard_grams.shape[0])
        self.alive = set(range(self.n_shards))
        # summed in shard order: the provider's order, so the total is
        # bitwise BlockEmulationProvider's Grams
        total = shard_grams[0]
        for k in range(1, self.n_shards):
            total = total + shard_grams[k]
        self._total = total

    @classmethod
    def from_mesh(cls, provider, seeds: torch.Tensor, q: Quadratic, ladder, mesh,
                  compute_dtype: str | None = None) -> "ShardLadderCache":
        """From the sharded pass: ``q`` is this rank's block
        (``shard_quadratic``), ``seeds`` (B,) int64."""
        return cls(shard_level_grams_per_shard(provider, seeds, q, ladder, mesh,
                                               compute_dtype=compute_dtype))

    @classmethod
    def from_emulation(cls, inner, seeds: torch.Tensor, q: Quadratic, ladder,
                       n_shards: int, compute_dtype: str | None = None
                       ) -> "ShardLadderCache":
        """Shard k sketches rows [k·n/K, (k+1)·n/K) under
        ``fold_seeds(seeds, k)``; ``seeds`` (B,) int64."""
        inner = get_provider(inner)
        n_loc = q.n // n_shards
        per_shard = [inner.level_grams(inner.sample(fold_seeds(seeds, k), ladder[-1], n_loc),
                                       q_k, ladder, compute_dtype=compute_dtype)
                     for k, q_k in enumerate(shard_quadratics(q, n_shards))]
        return cls(torch.stack(per_shard))

    def total(self) -> torch.Tensor:
        """(L, B, d, d) level Grams summed over the shards still alive."""
        return self._total

    def drop(self, k: int) -> torch.Tensor:
        """Shard k died: subtract its contribution from the total (no
        surviving shard is read again) and return the new (L, B, d, d)
        Grams."""
        if k not in self.alive:
            raise ValueError(f"shard {k} is not alive (alive: {sorted(self.alive)})")
        if len(self.alive) <= 1:
            raise ValueError("cannot drop the last remaining shard")
        self.alive.discard(k)
        self._total = self._total - self.shard_grams[k]
        return self._total


def shard_weighted_gram(q: Quadratic, mesh) -> torch.Tensor:
    """(B, d, d) AᵀWA of a row-sharded weighted batch: the chunked Gram
    (``quadratic.weighted_gram``, no weighted copy of A) of this rank's
    block, then one all-reduce (AᵀWA = Σ_k A_kᵀW_kA_k: W is row-diagonal)."""
    if not q.batched or q.row_weights is None:
        raise ValueError("shard_weighted_gram expects a batched, weighted Quadratic")
    return all_reduce_sum(weighted_gram(q.A, q.row_weights), mesh)


def sharded_padded_solve(q: Quadratic, seeds, mesh, **kw):
    """Cut this rank's row block out of the full batched ``q`` and run the
    padded engine on it with ``mesh=`` (the sharded ladder pass and Gram;
    with ``gram_hvp`` off, one all-reduce of AᵀAv a trip). Every rank
    returns the same replicated answer."""
    from .adaptive_padded import padded_adaptive_solve_batched

    return padded_adaptive_solve_batched(shard_quadratic(q, mesh), seeds, mesh=mesh, **kw)


def block_sketch_gram(A: torch.Tensor, seed, kind: str, m: int, mesh, *,
                      s: int = 1) -> torch.Tensor:
    """The summed block sketch SA = Σ_k S_kA_k (m, d), replicated: ``A`` is
    this rank's row block, S_k a ``make_sketch`` of m rows under
    ``fold_seeds(seed, k)`` (independent, zero-mean blocks, so E[(SA)ᵀSA] =
    AᵀA with no rescale), and one all-reduce sums the (m, d) partials."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=A.device)
    sk = make_sketch(kind, m, A.shape[0], fold_seeds(seed, data_index(mesh)), s=s,
                     device=A.device)
    return all_reduce_sum(sk.apply(A), mesh)


def distributed_sketch_and_factorize(q: Quadratic, seed, kind: str, m: int, mesh, *,
                                     s: int = 1):
    """The summed block sketch of this rank's block ``q``, and the
    replicated factorization of H_S."""
    return factorize(block_sketch_gram(q.A, seed, kind, m, mesh, s=s), q.nu, q.lam_diag)


def quadratic_shardings(mesh, q: Quadratic | None = None) -> Quadratic:
    """Each ``Quadratic`` field's placement over the mesh, as DTensor
    placements (one per mesh dim): A's row axis (axis 1 of a per-problem
    batch, else 0) and the row weights' ``Shard`` over the data dims and
    ``Replicate`` over ``"model"``; b, ν and Λ ``Replicate`` everywhere.
    Without ``q`` the single-problem (n, d) layout is assumed."""
    from torch.distributed.tensor import Replicate, Shard

    def rows(axis):
        return tuple(Shard(axis) if a != "model" else Replicate()
                     for a in mesh.mesh_dim_names)

    rep = (Replicate(),) * len(mesh.mesh_dim_names)
    batched = bool(q.batched) if q is not None else False
    per_problem = q is not None and q.batched and not q.shared_A
    weighted = q is not None and q.row_weights is not None
    return Quadratic(A=rows(1 if per_problem else 0), b=rep, nu=rep, lam_diag=rep,
                     batched=batched,
                     row_weights=rows(1 if batched else 0) if weighted else None)
