"""Serving steps (port of ``repro.serve.step``): prefill (fill the KV or
state cache from a prompt) and decode (one token), and a greedy loop.

The model takes the place of the reference's ``params``; ``cfg`` must be
the model's. Each function runs on ``device`` (default cuda) and refuses
tensors or a model that lie elsewhere. ``cache_pos`` is a host int: the
loop is driven from the host, one step a token.

With ``mesh`` (a library path, as in the reference, whose LM launcher has
no mesh) the model's parameters are DTensors placed by
``dist.sharding.param_placements`` and the cache's by ``cache_placements``;
the tokens (and whisper's ``enc_feats``) are split over the data dims by
``input_placements`` or whole on every rank, and the cache's batch axis
must be placed as the tokens are. A step gathers every weight whole and
each cache leaf whole but for its batch rows (gathering is exact), runs
the single-device step on this rank's rows, and returns the logits placed
as the tokens and the new cache placed as the old one, which it leaves
unchanged. The device is the mesh's unless given.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.distributed import mesh_device
from repro_torch.device import require_on, resolve_device
from repro_torch.dist import sharding
from repro_torch.models import Transformer, init_cache
from repro_torch.models.config import ModelConfig


def _check(model: Transformer, cfg: ModelConfig, device, **tensors) -> torch.device:
    dev = resolve_device(device)
    if model.cfg != cfg:
        raise ValueError(f"cfg {cfg.name} is not the model's ({model.cfg.name})")
    require_on(dev, model=model.embed, **tensors)
    return dev


def _merge(cache: dict, cross: dict) -> dict:
    """The cache with each decoder layer's ``ck``/``cv`` from ``cross``."""
    return {
        "blocks": {n: [c | x for c, x in zip(layers, cross["blocks"][n])]
                   if n in cross["blocks"] else layers
                   for n, layers in cache["blocks"].items()},
        "rem": {n: c | cross["rem"][n] if n in cross["rem"] else c
                for n, c in cache["rem"].items()},
    }


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _on_mesh(model: Transformer, mesh, step, tokens, cache, enc_feats=None):
    """``step(local tokens, local cache, local enc_feats)`` on this rank's
    rows with the weights gathered (module docstring); returns the logits
    placed as the tokens and the new cache placed as ``cache``."""
    whole = (Replicate(),) * mesh.ndim
    tp = tuple(tokens.placements) if isinstance(tokens, DTensor) else whole
    rows = {i for i, p in enumerate(tp) if isinstance(p, Shard)}
    if any(p.dim != 0 for p in tp if isinstance(p, Shard)):
        raise ValueError(f"tokens placed {tp}: only the batch axis may be split")

    def cache_in(leaf):
        if not isinstance(leaf, DTensor):
            return leaf
        pl = leaf.placements
        if {i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == 0} != rows:
            raise ValueError(f"a cache leaf placed {pl} splits its batch otherwise than the "
                             f"tokens ({tp})")
        return sharding.gather(leaf, mesh, [i for i, p in enumerate(pl)
                                     if isinstance(p, Shard) and p.dim != 0])

    def cache_out(new, old):
        if not isinstance(old, DTensor):
            return new
        inner = tuple(p if isinstance(p, Shard) and p.dim != 0 else Replicate()
                      for p in old.placements)
        return sharding.placed(sharding.local_part(new, inner, mesh), mesh, old.placements, old.shape)

    full = {k: nn.Parameter(sharding.gather(p, mesh), requires_grad=False)
            for k, p in model.named_parameters()}
    with sharding.materialized(model, full):
        logits, new = step(_local(tokens), sharding.tree_map(cache_in, cache),
                           _local(enc_feats))
    del full
    return (sharding.placed(logits, mesh, tp, (tokens.shape[0],) + tuple(logits.shape[1:])),
            sharding.tree_map(cache_out, new, cache))


@torch.no_grad()
def prefill_step(model: Transformer, cfg: ModelConfig, tokens, cache, *, enc_feats=None,
                 compute_dtype=torch.bfloat16, device=None, mesh=None):
    """Process a (B, S) prompt from an empty cache. Returns (last-token
    logits (B, V), filled cache)."""
    if mesh is not None:
        dev = device or mesh_device(mesh)
        return _on_mesh(model, mesh, lambda t, c, e: prefill_step(
            model, cfg, t, c, enc_feats=e, compute_dtype=compute_dtype, device=dev),
            tokens, cache, enc_feats)
    _check(model, cfg, device, tokens=tokens, enc_feats=enc_feats)
    if cfg.n_enc_layers and enc_feats is not None:
        enc_out = model.encode(enc_feats, compute_dtype)
        cache = _merge(cache, model.build_cross_cache(enc_out))
    logits, cache = model(tokens, cache=cache, cache_pos=0, compute_dtype=compute_dtype)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(model: Transformer, cfg: ModelConfig, token, cache, cache_pos: int, *,
                compute_dtype=torch.bfloat16, device=None, mesh=None):
    """One decode step. token: (B, 1); ``cache_pos``: the number of tokens
    already in the cache. Returns (logits (B, V), cache)."""
    if mesh is not None:
        dev = device or mesh_device(mesh)
        return _on_mesh(model, mesh, lambda t, c, _: decode_step(
            model, cfg, t, c, cache_pos, compute_dtype=compute_dtype, device=dev),
            token, cache)
    _check(model, cfg, device, token=token)
    logits, cache = model(token, cache=cache, cache_pos=cache_pos,
                          compute_dtype=compute_dtype)
    return logits[:, -1], cache


@torch.no_grad()
def greedy_generate(model: Transformer, cfg: ModelConfig, prompt, max_new: int, *,
                    max_seq: int, enc_feats=None, compute_dtype=torch.float32, device=None,
                    mesh=None):
    """Batched greedy generation: (B, S) prompt → (B, max_new) token ids.
    With ``mesh`` the cache is placed by ``cache_placements`` and the ids
    come back placed as the prompt."""
    if mesh is None:
        dev = _check(model, cfg, device, prompt=prompt, enc_feats=enc_feats)
    else:
        dev = device or mesh_device(mesh)
    B, S = prompt.shape
    cache = init_cache(cfg, B, max_seq, dtype=compute_dtype, device=dev)
    if mesh is not None:
        cache = sharding.place_tree(cache, mesh, sharding.cache_placements(cfg, cache, mesh))

    def argmax(logits):
        tok = torch.argmax(_local(logits), dim=-1)[:, None]
        return tok if mesh is None else sharding.placed(tok, mesh, logits.placements, (B, 1))

    logits, cache = prefill_step(model, cfg, prompt, cache, enc_feats=enc_feats,
                                 compute_dtype=compute_dtype, device=dev, mesh=mesh)
    tok = argmax(logits)
    out = [tok]
    for pos in range(S, S + max_new - 1):
        logits, cache = decode_step(model, cfg, tok, cache, pos,
                                    compute_dtype=compute_dtype, device=dev, mesh=mesh)
        tok = argmax(logits)
        out.append(tok)
    ids = torch.cat([_local(t) for t in out], dim=1)
    return ids if mesh is None else sharding.placed(ids, mesh, tok.placements, (B, max_new))
