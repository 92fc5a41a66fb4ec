"""The state carried between the JAX reference and the port.

The solver has no weights: its state is the problem data and the sketch
randomness. The LM scaffold's state is a parameter tree, a decode cache and
AdamW's state. One mapping (``to_ref_tree``/``from_ref_tree``) carries the
parameters, their grads and the optimizer's moments between the port's
per-layer names and the reference's stacked tree; it serves the parity
tests and the training checkpoints, which either package restores.
These helpers turn numpy arrays (what ``np.asarray`` gives for the
reference's arrays) into the port's tensors and modules on an explicit
device, and the port's results back into numpy, so the two packages can be
run on the same inputs.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .core.quadratic import Quadratic
from .device import resolve_device
from .dist.sharding import from_partition_names, to_partition_names
from .models.transformer import Transformer
from .train.optimizer import OptState


def _tensor(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=dev)


def quadratic_from_numpy(A, b, nu, lam_diag, row_weights=None, *,
                         device=None) -> Quadratic:
    """A batched ``Quadratic`` from numpy arrays: A (B, n, d) or shared
    (n, d), b (B, d), ν (B,), Λ (B, d), optional row weights (B, n)."""
    dev = resolve_device(device)
    f32 = torch.float32
    return Quadratic(
        A=_tensor(A, f32, dev), b=_tensor(b, f32, dev), nu=_tensor(nu, f32, dev),
        lam_diag=_tensor(lam_diag, f32, dev), batched=True,
        row_weights=None if row_weights is None else _tensor(row_weights, f32, dev))


def sample_from_numpy(sample: dict, *, device=None) -> dict:
    """A provider's sample dict from numpy: ``seeds`` (B,) uint32 → int64,
    the SRHT's ``signs`` (B, n) → fp32 and ``rows`` (B, m_max) → int64, or
    the SJLT's ``u`` (B, n) → fp32 and ``signs``."""
    dev = resolve_device(device)
    out = {}
    for k, v in sample.items():
        v = np.asarray(v)
        if k == "seeds":
            out[k] = _tensor(v.astype(np.uint32).astype(np.int64), torch.int64, dev)
        elif k == "rows":
            out[k] = _tensor(v.astype(np.int64), torch.int64, dev)
        elif k in ("signs", "u"):
            out[k] = _tensor(v, torch.float32, dev)
        else:
            raise ValueError(f"unknown sample field {k!r}")
    return out


def to_numpy(obj):
    """Tensors → numpy, recursively through dicts, lists, tuples and
    dataclasses (e.g. a ``RidgeSolution``, as a dict of fields)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def _ref_path(key: str) -> tuple[tuple[str, ...], int | None]:
    """Where a port parameter lives in the reference's tree:
    ``blocks.p0_attn.3.attn.wq`` is ``("blocks", "p0_attn", "attn", "wq")``
    at index 3 of the leading axis (the reference stacks a pattern
    position's layers), ``enc_blocks.3.…`` the same under ``enc_blocks``,
    anything else the path itself with no index."""
    parts, idx = key.split("."), None
    if parts[0] == "blocks":
        parts, idx = parts[:2] + parts[3:], int(parts[2])
    elif parts[0] == "enc_blocks":
        parts, idx = parts[:1] + parts[2:], int(parts[1])
    return tuple(parts), idx


def _walk(tree: dict, parts):
    for p in parts:
        tree = tree[p]
    return tree


def _ref_leaf(tree: dict, key: str):
    parts, idx = _ref_path(key)
    node = _walk(tree, parts)
    return np.asarray(node if idx is None else node[idx])


def to_ref_tree(named: Mapping[str, torch.Tensor]) -> dict:
    """The reference's tree of a map keyed by the port's parameter names
    (parameters, their grads, AdamW's moments): each pattern position's
    and the encoder's layers stacked on a leading axis, in layer order;
    ``blocks`` and ``rem`` are there, empty or not, as in the reference's."""
    leaves: dict = {}
    for key, t in named.items():
        parts, idx = _ref_path(key)
        if idx is None:
            leaves[parts] = t
        else:
            leaves.setdefault(parts, {})[idx] = t
    tree: dict = {"blocks": {}, "rem": {}}
    for parts, v in leaves.items():
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = (torch.stack([v[j] for j in range(len(v))]) if isinstance(v, dict)
                           else v)
    return tree


def from_ref_tree(tree: dict, names) -> dict[str, torch.Tensor]:
    """``to_ref_tree``'s inverse: {name: tensor} for the port's parameter
    ``names``, a stacked leaf's layers as views of it."""
    out = {}
    for key in names:
        parts, idx = _ref_path(key)
        node = _walk(tree, parts)
        out[key] = node if idx is None else node[idx]
    return out


def model_to_numpy(model: Transformer) -> dict:
    """The reference's ``init_params`` tree (numpy) holding the port
    model's numbers: ``model_from_numpy``'s exact inverse."""
    return to_numpy(to_ref_tree({k: p.detach() for k, p in model.named_parameters()}))


def grads_to_numpy(model: Transformer) -> dict:
    """The port's ``.grad`` of every parameter in the reference's tree, as
    ``jax.grad`` of a loss over the reference's parameters gives it."""
    return to_numpy(to_ref_tree({k: p.grad for k, p in model.named_parameters()}))


def opt_state_to_numpy(state: OptState) -> OptState:
    """AdamW's state in the reference's layout: (mu, nu) trees and the
    int32 step, as numpy."""
    return OptState(mu=to_numpy(to_ref_tree(state.mu)), nu=to_numpy(to_ref_tree(state.nu)),
                    step=to_numpy(state.step))


def opt_state_from_numpy(state_np, model: Transformer, *, device=None) -> OptState:
    """The reference's ``OptState`` (numpy leaves) keyed by the port
    model's parameter names, on ``device`` (default cuda)."""
    dev = resolve_device(device)
    names = [k for k, _ in model.named_parameters()]

    def moments(tree):
        return {k: _tensor(v, torch.float32, dev)
                for k, v in from_ref_tree(tree, names).items()}
    return OptState(mu=moments(state_np[0]), nu=moments(state_np[1]),
                    step=_tensor(state_np[2], torch.int32, dev))


def train_tree(model, state: OptState) -> tuple:
    """The training state as the reference checkpoints it, ``(params,
    OptState)`` in its tree layout: ``ft.CheckpointManager`` writes its
    leaves under the reference's paths (``0/embed``, ``1/.mu/embed``,
    ``1/.step``), so either package restores the other's directory.
    ``model`` is a ``Transformer`` or its ``{name: tensor}`` map (a sharded
    run's gathered parameters)."""
    named = model.named_parameters() if isinstance(model, Transformer) else model.items()
    params = {k: p.detach() for k, p in named}
    return to_ref_tree(params), OptState(to_ref_tree(state.mu), to_ref_tree(state.nu),
                                         state.step)


@torch.no_grad()
def load_train_tree(tree: tuple, model: Transformer, state: OptState | None = None):
    """Copy a ``train_tree``-shaped tree (as ``CheckpointManager.restore``
    returns it) into ``model`` and, unless it is None, ``state``, in place.
    ``state`` may be None in the tree and here (a server reads the
    parameters alone)."""
    params, opt = tree
    named = dict(model.named_parameters())
    for k, v in from_ref_tree(params, named).items():
        named[k].copy_(v)
    if state is not None:
        for mine, theirs in ((state.mu, opt.mu), (state.nu, opt.nu)):
            for k, v in from_ref_tree(theirs, named).items():
                mine[k].copy_(v)
        state.step.copy_(opt.step)


def model_from_numpy(params_np: dict, cfg, *, device=None) -> Transformer:
    """The port's ``Transformer`` holding the numbers of the reference's
    ``init_params`` tree (as numpy arrays): each stacked
    ``blocks["p{i}_{kind}"]`` leaf is split into position i's layers, the
    remainder and encoder layers likewise. Every reference number is used
    exactly once."""
    max_seq = np.shape(params_np["pos"])[0] if "pos" in params_np else 4096
    model = Transformer(cfg, max_seq=max_seq, device=device)
    total = 0
    with torch.no_grad():
        for key, p in model.named_parameters():
            leaf = _ref_leaf(params_np, key)
            if leaf.shape != tuple(p.shape):
                raise ValueError(f"{key}: reference shape {leaf.shape}, port {tuple(p.shape)}")
            p.copy_(torch.as_tensor(np.array(leaf, dtype=np.float32)))
            total += p.numel()

    def count(t):
        return sum(count(v) for v in t.values()) if isinstance(t, dict) else np.size(t)
    if total != count(params_np):
        raise ValueError(f"the port's model takes {total} of the reference's "
                         f"{count(params_np)} numbers")
    return model


def _spec_map(fn, tree):
    """``fn`` over a tree of dicts and lists whose leaves are tuples (a
    placement tuple, or a ``P(...)``'s entries)."""
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_map(fn, v) for v in tree]
    return fn(tree)


def placements_from_specs(specs, mesh):
    """A tree of the reference's ``PartitionSpec`` entries, each given as
    ``tuple(P)`` (None, an axis name or a tuple of names per tensor axis),
    as placement tuples over ``mesh``."""
    return _spec_map(lambda e: from_partition_names(e, mesh), specs)


def specs_from_placements(placements, mesh, ndims):
    """``placements_from_specs``'s inverse: each placement tuple as
    ``tuple(P)`` of its leaf's ``ndims`` (a tree of ints) entries."""
    flat = []
    _spec_map(flat.append, ndims)
    it = iter(flat)
    return _spec_map(lambda pl: to_partition_names(pl, mesh, next(it)), placements)


def _shape_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _shape_leaves(v, path + (k,))
    else:
        yield path, tuple(tree.shape)


def layer_shapes(tree: dict) -> dict[str, tuple]:
    """The port's per-layer parameter shapes, ``{name: shape}``, of the
    reference's stacked tree (arrays or shape structs): a stacked leaf's
    leading axis is the layer index (``_ref_path``'s inverse)."""
    out = {}
    for parts, shape in _shape_leaves(tree):
        if parts[0] == "blocks":
            for j in range(shape[0]):
                out[".".join(parts[:2] + (str(j),) + parts[2:])] = shape[1:]
        elif parts[0] == "enc_blocks":
            for j in range(shape[0]):
                out[".".join(parts[:1] + (str(j),) + parts[1:])] = shape[1:]
        else:
            out[".".join(parts)] = shape
    return out


def cache_layer_shapes(cache: dict) -> dict:
    """The port's cache layout of shapes (``{"blocks": {name: [one dict a
    layer]}, "rem": {name: dict}}``) of the reference's stacked cache."""
    def shapes(c):
        return {leaf: tuple(v.shape) for leaf, v in c.items()}
    return {"blocks": {name: [{leaf: tuple(v.shape[1:]) for leaf, v in c.items()}
                              for _ in range(next(iter(c.values())).shape[0])]
                       for name, c in cache["blocks"].items()},
            "rem": {name: shapes(c) for name, c in cache["rem"].items()}}


def cache_to_numpy(cache: dict) -> dict:
    """A port cache in the reference's layout: each position's per-layer
    dicts stacked on a leading axis."""
    return {"blocks": {name: {leaf: np.stack([to_numpy(c[leaf]) for c in layers])
                              for leaf in layers[0]}
                       for name, layers in cache["blocks"].items()},
            "rem": {name: {leaf: to_numpy(t) for leaf, t in c.items()}
                    for name, c in cache["rem"].items()}}


def cache_from_numpy(cache_np: dict, *, device=None) -> dict:
    """The reference's cache tree (numpy) in the port's layout, on
    ``device`` (default cuda)."""
    dev = resolve_device(device)

    def tensors(c, j=None):
        return {leaf: torch.as_tensor(np.array(v if j is None else v[j]), device=dev)
                for leaf, v in c.items()}
    return {"blocks": {name: [tensors(c, j) for j in range(len(next(iter(c.values()))))]
                       for name, c in cache_np["blocks"].items()},
            "rem": {name: tensors(c) for name, c in cache_np["rem"].items()}}
