"""Serving steps (port of ``repro.serve.step``): prefill (fill the KV or
state cache from a prompt) and decode (one token), and a greedy loop.

The model takes the place of the reference's ``params``; ``cfg`` must be
the model's. Each function runs on ``device`` (default cuda) and refuses
tensors or a model that lie elsewhere. ``cache_pos`` is a host int: the
loop is driven from the host, one step a token.
"""

from __future__ import annotations

import torch

from repro_torch.device import require_on, resolve_device
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


@torch.no_grad()
def prefill_step(model: Transformer, cfg: ModelConfig, tokens, cache, *, enc_feats=None,
                 compute_dtype=torch.bfloat16, device=None):
    """Process a (B, S) prompt from an empty cache. Returns (last-token
    logits (B, V), filled cache)."""
    _check(model, cfg, device, tokens=tokens, enc_feats=enc_feats)
    if cfg.n_enc_layers and enc_feats is not None:
        enc_out = model.encode(enc_feats, compute_dtype)
        cache = _merge(cache, model.build_cross_cache(enc_out))
    logits, cache = model(tokens, cache=cache, cache_pos=0, compute_dtype=compute_dtype)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(model: Transformer, cfg: ModelConfig, token, cache, cache_pos: int, *,
                compute_dtype=torch.bfloat16, device=None):
    """One decode step. token: (B, 1); ``cache_pos``: the number of tokens
    already in the cache. Returns (logits (B, V), cache)."""
    _check(model, cfg, device, token=token)
    logits, cache = model(token, cache=cache, cache_pos=cache_pos,
                          compute_dtype=compute_dtype)
    return logits[:, -1], cache


@torch.no_grad()
def greedy_generate(model: Transformer, cfg: ModelConfig, prompt, max_new: int, *,
                    max_seq: int, enc_feats=None, compute_dtype=torch.float32, device=None):
    """Batched greedy generation: (B, S) prompt → (B, max_new) token ids."""
    dev = _check(model, cfg, device, prompt=prompt, enc_feats=enc_feats)
    B, S = prompt.shape
    cache = init_cache(cfg, B, max_seq, dtype=compute_dtype, device=dev)
    logits, cache = prefill_step(model, cfg, prompt, cache, enc_feats=enc_feats,
                                 compute_dtype=compute_dtype, device=dev)
    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    for pos in range(S, S + max_new - 1):
        logits, cache = decode_step(model, cfg, tok, cache, pos,
                                    compute_dtype=compute_dtype, device=dev)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
