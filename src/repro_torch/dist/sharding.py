"""Placements of the LM's parameters, decode caches and input batches over
a ``("data", "model")`` mesh, as ``torch.distributed.tensor`` placements
(port of ``repro.dist.sharding``), and the DTensor plumbing of the sharded
train and decode steps.

The rules are the reference's, applied to whatever leaf shapes they are
given (a tensor, an array, a ``torch.Size`` or a tuple of ints):

* params: a leaf of 2 or more dims shards its last axis that the ``model``
  size divides (and is at least) over ``model``; with ``fsdp`` the first
  other axis that the product of the data axes divides goes over the data
  axes. A 1-D leaf replicates.
* caches: axis 0 over the data axes, axis 1 over ``model``, each where its
  size is divisible and at least the axis size.
* inputs: axis 0 over the data axes where the data size divides it.

A placement is one entry per mesh dim, ``Shard(ax)`` or ``Replicate()``;
several data dims that shard one axis split it in mesh order, major to
minor, as a ``P(("pod", "data"))`` does. ``to_partition_names`` renders a
placement tuple as the reference's ``P(...)`` entries. A mesh is a
``DeviceMesh`` or anything with ``.shape`` (a mapping from axis name to
size, or sizes in axis order) and ``.axis_names``, so the dry-run can
place a pod-scale model without a device.

**Per-layer leaves (ROADMAP queue 3, F5).** The reference applies these
rules to *stacked* leaves, ``(n_blocks, …)`` per pattern position, so they
reach axes its docstring does not name: a stacked norm scale
``(n_blocks, d)`` shards ``d`` over ``model``, a stacked cache ``k`` of
``(n_blocks, B, S, KV, hd)`` puts the layer axis over the data axes and the
batch over ``model``, and fsdp may take the layer axis. The port's
parameters and caches are per layer, so the same rules give the port
another layout: norm scales replicate, a cache's batch goes over the data
axes and its sequence (``k``, ``v``) or width (``h``) over ``model``.
Layout moves no number here: the steps gather every sharded operand whole
before they compute, and gathering is exact, so the sharded steps compute
the single-device program on every rank, up to the order of the
reductions over the data axes.

**Gathering.** gloo, which ranks sharing one card use, all-reduces CUDA
tensors but does not gather them, so ``gather`` writes the local shard into
a zero buffer of the full shape and all-reduces it over the dims that
shard it, summed as integers of the buffer's bytes: each bit comes from one
rank and every other rank adds zeros, so the full tensor is bitwise the
shards, signed zeros and NaN payloads included. ``distribute_tensor`` is
called with ``src_data_rank=None``: every rank holds the same full tensor
(made from one seed) and keeps its slice, with no collective.
``TRAFFIC`` counts the bytes every rank all-reduces, gathered and
reduced, since the caller last set it to 0.
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Mapping

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

TRAFFIC = {"gathered": 0, "reduced": 0}


# ---------------------------------------------------------------------------
# Meshes and leaves
# ---------------------------------------------------------------------------

def _axes(mesh) -> tuple[tuple[str, ...], dict[str, int]]:
    """(axis names in mesh order, {name: size}) of a DeviceMesh or a
    duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), dict(zip(names, mesh.shape))
    names = tuple(mesh.axis_names)
    shape = mesh.shape
    return names, (dict(shape) if isinstance(shape, Mapping) else dict(zip(names, shape)))


def _data(names, sizes) -> tuple[tuple[str, ...], int]:
    da = tuple(a for a in names if a != "model")
    return da, math.prod(sizes[a] for a in da)


def _is_shape(x) -> bool:
    return isinstance(x, torch.Size) or (type(x) is tuple and all(type(i) is int for i in x))


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf) if _is_shape(leaf) else tuple(leaf.shape)


def _is_leaf(x) -> bool:
    return _is_shape(x) or hasattr(x, "shape")


def tree_map(fn, tree, *others):
    """``fn(leaf, *other leaves)`` over a tree of dicts, lists, tuples and
    NamedTuples (a module is its ``named_parameters()``), ``others`` walked
    in parallel by the same keys; None stays None."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(tree, *others)
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(getattr(o, f) for o in others))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree))
    raise TypeError(f"not a tree of tensors or shapes: {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """The leaves of a tree, in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def _placements(dims, names) -> tuple:
    """One placement per mesh dim from per-axis sets of mesh dim names."""
    out = []
    for n in names:
        ax = next((a for a, d in enumerate(dims) if n in d), None)
        out.append(Replicate() if ax is None else Shard(ax))
    return tuple(out)


# ---------------------------------------------------------------------------
# The reference's rules
# ---------------------------------------------------------------------------

def _param_rule(shape, names, sizes, fsdp) -> tuple:
    model = sizes.get("model", 1)
    da, dsize = _data(names, sizes)
    dims: list = [()] * len(shape)
    if len(shape) >= 2 and model > 1:
        for ax in reversed(range(len(shape))):
            if shape[ax] % model == 0 and shape[ax] >= model:
                dims[ax] = ("model",)
                break
    if fsdp and len(shape) >= 2 and dsize > 1:
        for ax in range(len(shape)):
            if not dims[ax] and shape[ax] % dsize == 0 and shape[ax] >= dsize:
                dims[ax] = da
                break
    return _placements(dims, names)


def _cache_rule(shape, names, sizes) -> tuple:
    model = sizes.get("model", 1)
    da, dsize = _data(names, sizes)
    dims: list = [()] * len(shape)
    if len(shape) >= 1 and dsize > 1 and shape[0] % dsize == 0 and shape[0] >= dsize:
        dims[0] = da
    if len(shape) >= 2 and model > 1 and shape[1] % model == 0 and shape[1] >= model:
        dims[1] = ("model",)
    return _placements(dims, names)


def _input_rule(shape, names, sizes) -> tuple:
    da, dsize = _data(names, sizes)
    dims: list = [()] * len(shape)
    if len(shape) >= 1 and dsize > 1 and shape[0] % dsize == 0:
        dims[0] = da
    return _placements(dims, names)


def param_placements(cfg, tree_or_shapes, mesh, *, fsdp: bool = False):
    """Placements of every parameter leaf (a module's ``{name: placements}``,
    or the tree given), by the reference's ``param_specs`` rule."""
    del cfg                                     # shape-driven, as the reference's
    names, sizes = _axes(mesh)
    return tree_map(lambda leaf: _param_rule(_shape(leaf), names, sizes, fsdp), tree_or_shapes)


def cache_placements(cfg, cache, mesh):
    """Placements of every decode-cache leaf, by ``cache_specs``'s rule."""
    del cfg
    names, sizes = _axes(mesh)
    return tree_map(lambda leaf: _cache_rule(_shape(leaf), names, sizes), cache)


def input_placements(batch, mesh):
    """Placements of every input leaf, by ``input_specs_for``'s rule."""
    names, sizes = _axes(mesh)
    return tree_map(lambda leaf: _input_rule(_shape(leaf), names, sizes), batch)


def to_partition_names(placements, mesh, ndim: int | None = None) -> tuple:
    """A placement tuple as the reference's ``tuple(P(...))``: per tensor
    axis None, a mesh axis name, or a tuple of names (mesh order) when
    several shard it; ``ndim`` entries, or up to the last sharded axis."""
    names, _ = _axes(mesh)
    by_axis: dict[int, list[str]] = {}
    for n, p in zip(names, placements):
        if isinstance(p, Shard):
            by_axis.setdefault(p.dim, []).append(n)
    n_out = ndim if ndim is not None else 1 + max(by_axis, default=-1)
    return tuple(None if ax not in by_axis else
                 by_axis[ax][0] if len(by_axis[ax]) == 1 else tuple(by_axis[ax])
                 for ax in range(n_out))


def from_partition_names(entries, mesh) -> tuple:
    """``to_partition_names``'s inverse: the placement tuple of a
    reference ``P(...)``'s entries."""
    names, _ = _axes(mesh)
    dims = [() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in entries]
    return _placements(dims, names)


# ---------------------------------------------------------------------------
# Placing and gathering
# ---------------------------------------------------------------------------

def _slices(shape, placements, mesh) -> tuple:
    """This rank's block of a tensor of ``shape`` under ``placements``: each
    Shard(ax) splits ax's current extent evenly, in mesh order."""
    start, size = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            k = mesh.size(i)
            if size[p.dim] % k:
                raise ValueError(f"axis {p.dim} of {tuple(shape)} does not split "
                                 f"evenly over {k} ranks")
            size[p.dim] //= k
            start[p.dim] += mesh.get_local_rank(i) * size[p.dim]
    return tuple(slice(s, s + n) for s, n in zip(start, size))


def local_part(full: torch.Tensor, placements, mesh) -> torch.Tensor:
    """A contiguous copy of this rank's block of ``full``."""
    return full[_slices(full.shape, placements, mesh)].clone()


def placed(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A DTensor of global ``shape`` (contiguous) from this rank's block."""
    shape = torch.Size(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                              stride=stride)


def place_tree(tree, mesh, placements):
    """Every tensor leaf of ``tree`` as a DTensor with the matching leaf of
    ``placements``: the rank keeps its block of the full tensor it holds."""
    return tree_map(lambda t, p: distribute_tensor(t.detach(), mesh, p, src_data_rank=None),
                tree, placements)


def place_model(model: nn.Module, mesh, placements: dict) -> nn.Module:
    """Make every parameter of ``model`` a DTensor parameter with its
    placements (``{name: placements}``), in place; returns the model."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        dt = distribute_tensor(p.detach(), mesh, placements[name], src_data_rank=None)
        setattr(model.get_submodule(owner), leaf, nn.Parameter(dt, requires_grad=False))
    return model


def place_state(state, mesh, placements: dict):
    """AdamW's moments (an ``OptState``) placed as their parameters are; the
    step replicated."""
    return type(state)(mu=place_tree(state.mu, mesh, placements),
                       nu=place_tree(state.nu, mesh, placements), step=state.step)


def _all_reduce(t: torch.Tensor, mesh, dims, counter: str) -> None:
    """Sum ``t`` in place over the mesh dims ``dims``: one all-reduce over the
    default group when they are every dim of a mesh that spans it, else one
    a dim."""
    names, _ = _axes(mesh)
    dims = sorted(dims)
    if len(dims) == len(names) and mesh.size() == dist.get_world_size():
        groups = [None]
    else:
        groups = [mesh.get_group(i) for i in dims]
    for g in groups:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
        TRAFFIC[counter] += t.numel() * t.element_size()


def gather(t, mesh, dims=None) -> torch.Tensor:
    """The full tensor of a DTensor, bitwise, on every rank (a plain tensor
    is returned as it is). ``dims`` limits the gather to those mesh dims
    (default: every dim that shards it); the result keeps its block of the
    others."""
    if not isinstance(t, DTensor):
        return t
    local = t.to_local()
    if dims is None:
        dims = [i for i, p in enumerate(t.placements) if isinstance(p, Shard)]
    if not dims:
        return local
    kept = {p.dim for i, p in enumerate(t.placements) if isinstance(p, Shard) and i not in dims}
    if any(isinstance(t.placements[i], Shard) and t.placements[i].dim in kept for i in dims):
        raise ValueError("a partial gather must not split an axis that a kept dim shards")
    partial = tuple(p if i not in dims else Replicate() for i, p in enumerate(t.placements))
    shape = [s.stop - s.start for s in _slices(t.shape, partial, mesh)]
    buf = torch.zeros(shape, dtype=local.dtype, device=local.device)
    inner = tuple(p if i in dims else Replicate() for i, p in enumerate(t.placements))
    buf[_slices(shape, inner, mesh)] = local
    flat = buf.view(-1).view(torch.uint8)
    _all_reduce(flat.view(torch.int32) if flat.numel() % 4 == 0 else flat, mesh, dims,
                "gathered")
    return buf


def gather_tree(tree, mesh):
    """``gather`` over every leaf: the full tensors on every rank (a lead
    rank writes them to a checkpoint; tests compare them)."""
    return tree_map(lambda t: gather(t, mesh), tree)


def reduce_mesh(t: torch.Tensor, mesh) -> None:
    """Sum ``t`` in place over every rank of the mesh."""
    _all_reduce(t, mesh, range(mesh.ndim), "reduced")


def reduce_data(tensors, mesh) -> None:
    """Sum each tensor in place over the mesh's data dims (the grads of a
    data-split batch)."""
    names, _ = _axes(mesh)
    dims = [i for i, n in enumerate(names) if n != "model" and mesh.size(i) > 1]
    if dims:
        for t in tensors:
            _all_reduce(t, mesh, dims, "reduced")


@contextlib.contextmanager
def materialized(model: nn.Module, full: dict):
    """``model`` with each named parameter replaced by the parameter given
    in ``full`` (the gathered tensors), its placed parameters back on exit."""
    saved = []
    for name, p in full.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        saved.append((mod, leaf, mod._parameters[leaf]))
        setattr(mod, leaf, p)
    try:
        yield model
    finally:
        for mod, leaf, p in saved:
            setattr(mod, leaf, p)
