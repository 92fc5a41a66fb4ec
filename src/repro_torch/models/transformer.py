"""The model stack (port of ``repro.models.transformer``): layers of
heterogeneous kinds, caches, logits.

* ``Transformer.blocks[f"p{i}_{kind}"]`` holds the ``n_blocks`` layers of
  pattern position i, and ``rem[f"r{i}_{kind}"]`` the remainder layers.
  ``forward`` runs them **position-major**, as the reference's scan over
  each position's stack does: every layer of position 0, then every layer
  of position 1, …, then the remainder. That is not ``cfg.layer_kinds()``'s
  interleaved order (ROADMAP queue 3, F1); weights loaded into the stack
  must follow it.
* A cache mirrors the stack: ``{"blocks": {name: [one dict per layer]},
  "rem": {name: dict}}``, each dict with the reference's leaf names and
  shapes (``k``, ``v``, ``ck``, ``cv``, ``h``, ``conv``, ``S``, ``tm_x``,
  ``cm_x``).
* Whisper (enc-dec) adds an encoder stack and cross-attention caches.
* ``forward(..., remat=True)`` recomputes each decoder layer in the
  backward pass (training only: it raises with a cache); the encoder's
  layers are not recomputed, as in the reference. ``hidden`` is
  ``forward`` without the head, for the blocked cross-entropy.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import layers as L
from .config import ATTN_KINDS, MOE_KINDS, WINDOWED_KINDS, ModelConfig


class Layer(nn.Module):
    """Pre-norm residual layer of one kind (the reference's ``init_layer``
    and ``apply_layer``)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device=None):
        super().__init__()
        if kind not in ATTN_KINDS + ("rnn", "rwkv"):
            raise ValueError(kind)
        d, eps = cfg.d_model, cfg.norm_eps
        self.kind = kind
        self.ln1, self.ln2 = L.RMSNorm(d, eps, device=device), L.RMSNorm(d, eps, device=device)
        if kind in ATTN_KINDS:
            self.attn = L.Attention(cfg, device=device)
        if kind == "dec":
            self.cross = L.Attention(cfg, cross=True, device=device)
            self.ln_cross = L.RMSNorm(d, eps, device=device)
        if kind == "rnn":
            self.rnn = L.RGLRUBlock(cfg, device=device)
        if kind == "rwkv":
            self.rwkv = L.RWKVBlock(cfg, device=device)
        elif kind in MOE_KINDS:
            self.moe = L.MoE(cfg, device=device)
        else:
            self.mlp = L.MLP(cfg, device=device)

    def forward(self, x, positions, cache=None, cache_pos=None, enc_out=None):
        kind = self.kind
        if kind == "rwkv":
            return self.rwkv(x, self.ln1, self.ln2, cache)
        if kind == "rnn":
            h, new_cache = self.rnn(self.ln1(x), cache)
            x = x + h
            return x + self.mlp(self.ln2(x)), new_cache

        h, new_cache = self.attn(self.ln1(x), positions, kind=kind, cache=cache,
                                 cache_pos=cache_pos)
        x = x + h
        if kind == "dec":
            xc = self.ln_cross(x)
            if cache is not None:
                h = self.cross.cross_cached(xc, cache)
            else:
                h, _ = self.cross(xc, positions, kind=kind, enc_out=enc_out)
            x = x + h
        y = self.ln2(x)
        x = x + (self.moe(y) if kind in MOE_KINDS else self.mlp(y))
        if kind == "dec" and new_cache is not None:
            new_cache = new_cache | {"ck": cache["ck"], "cv": cache["cv"]}
        return x, new_cache


class Transformer(nn.Module):
    """The reference's parameter tree as modules: ``embed`` (V, d),
    ``final_norm``, ``lm_head`` (d, V) unless tied, ``pos`` (max_seq, d)
    for learned positions, ``blocks``, ``rem``, and for whisper
    ``enc_blocks``, ``enc_norm``, ``enc_pos``. Parameters are zeros until
    ``init_params`` or ``bridge.model_from_numpy`` fills them."""

    def __init__(self, cfg: ModelConfig, *, max_seq: int = 4096, device=None):
        super().__init__()
        d, V = cfg.d_model, cfg.vocab
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = L._param(V, d, device=dev)
        self.final_norm = L.RMSNorm(d, cfg.norm_eps, device=dev)
        if not cfg.tie_embeddings:
            self.lm_head = L._param(d, V, device=dev)
        if cfg.pos_embedding == "learned":
            self.pos = L._param(max_seq, d, device=dev)
        self.blocks = nn.ModuleDict({
            f"p{i}_{kind}": nn.ModuleList(Layer(cfg, kind, device=dev)
                                          for _ in range(cfg.n_blocks))
            for i, kind in enumerate(cfg.pattern) if cfg.n_blocks > 0})
        self.rem = nn.ModuleDict({f"r{i}_{cfg.pattern[i]}": Layer(cfg, cfg.pattern[i], device=dev)
                                  for i in range(cfg.n_rem)})
        if cfg.n_enc_layers:
            self.enc_blocks = nn.ModuleList(Layer(cfg, "enc", device=dev)
                                            for _ in range(cfg.n_enc_layers))
            self.enc_norm = L.RMSNorm(d, cfg.norm_eps, device=dev)
            self.enc_pos = L._param(cfg.enc_seq, d, device=dev)

    def init_(self, g: torch.Generator) -> None:
        L._normal_(self.embed, g, 1.0 / math.sqrt(self.cfg.d_model))
        if not self.cfg.tie_embeddings:
            L._normal_(self.lm_head, g, 1.0 / math.sqrt(self.cfg.d_model))
        if self.cfg.pos_embedding == "learned":
            L._normal_(self.pos, g, 0.02)
        if self.cfg.n_enc_layers:
            L._normal_(self.enc_pos, g, 0.02)

    def embed_tokens(self, tokens, compute_dtype):
        cfg = self.cfg
        if cfg.onehot_embed:
            x = F.one_hot(tokens, cfg.vocab).to(compute_dtype) @ self.embed.to(compute_dtype)
        else:
            x = self.embed[tokens].to(compute_dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype, device=x.device)
        return x

    def encode(self, enc_feats, compute_dtype=torch.bfloat16):
        """Whisper encoder over precomputed frame embeddings (B, enc_seq, d)."""
        x = enc_feats.to(compute_dtype)
        x = x + self.enc_pos[None, : x.shape[1]].to(compute_dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        for layer in self.enc_blocks:
            x, _ = layer(x, positions)
        return self.enc_norm(x)

    def build_cross_cache(self, enc_out):
        """Per-decoder-layer cross K/V of the encoder output, in the cache's
        layout: ``{"blocks": {name: [{"ck", "cv"}, …]}, "rem": {…}}``."""
        def kv(layer):
            ck, cv = layer.cross.kv(enc_out)
            return {"ck": ck, "cv": cv}

        return {"blocks": {n: [kv(lyr) for lyr in s] for n, s in self.blocks.items()
                           if n.split("_", 1)[1] == "dec"},
                "rem": {n: kv(lyr) for n, lyr in self.rem.items() if lyr.kind == "dec"}}

    def layers(self, *, remainder: bool = True):
        """(cache group, name, index or None, layer) in the order ``forward``
        runs them: position-major, then the remainder."""
        for name, stack in self.blocks.items():
            for j, layer in enumerate(stack):
                yield "blocks", name, j, layer
        if remainder:
            for name, layer in self.rem.items():
                yield "rem", name, None, layer

    def hidden(self, tokens, *, cache=None, cache_pos: int | None = None, enc_feats=None,
               compute_dtype=torch.bfloat16, remat: bool = False):
        """The final-normed hidden states (B, S, d) in ``compute_dtype`` and
        the new cache (None without one): ``forward`` without the head, which
        ``train.step.blocked_lm_loss`` reads without building logits.
        ``remat`` recomputes each layer's activations in the backward pass
        (``torch.utils.checkpoint``, as the reference wraps ``apply_layer``
        in ``jax.checkpoint``); it applies only without a cache, and the
        values are the same either way."""
        cfg = self.cfg
        if remat and cache is not None:
            raise ValueError("remat applies only without a cache (training)")
        S = tokens.shape[1]
        x = self.embed_tokens(tokens, compute_dtype)
        start = 0 if cache is None else int(cache_pos)
        positions = torch.arange(start, start + S, device=tokens.device)
        if cfg.pos_embedding == "learned":
            if start + S > self.pos.shape[0]:
                raise ValueError(f"positions {start}..{start + S - 1} exceed the "
                                 f"{self.pos.shape[0]} learned positions")
            x = x + self.pos[None, start:start + S].to(compute_dtype)

        enc_out = None
        if cfg.n_enc_layers and enc_feats is not None:
            enc_out = self.encode(enc_feats, compute_dtype)

        new_cache = None if cache is None else {"blocks": {n: [] for n in self.blocks},
                                                "rem": {}}
        for group, name, j, layer in self.layers():
            lc = None
            if cache is not None:
                lc = cache[group][name] if j is None else cache[group][name][j]
            # the layers draw no randomness: no RNG state to replay
            fn = (functools.partial(checkpoint, layer, use_reentrant=False,
                                    preserve_rng_state=False) if remat else layer)
            x, nc = fn(x, positions, lc, start, enc_out)
            if cache is not None:
                if j is None:
                    new_cache[group][name] = nc
                else:
                    new_cache[group][name].append(nc)
        return self.final_norm(x), new_cache

    def head(self) -> torch.Tensor:
        """The (d, V) output projection: ``embed``ᵀ when tied."""
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head

    def forward(self, tokens, *, cache=None, cache_pos: int | None = None, enc_feats=None,
                compute_dtype=torch.bfloat16, remat: bool = False):
        """tokens (B, S) int64 → (logits fp32 (B, S, V), new_cache or None).
        With a cache, ``cache_pos`` is the absolute position of tokens[:, 0];
        ``remat`` as in ``hidden``."""
        x, new_cache = self.hidden(tokens, cache=cache, cache_pos=cache_pos,
                                   enc_feats=enc_feats, compute_dtype=compute_dtype,
                                   remat=remat)
        logits = (x @ self.head().to(compute_dtype)).float()
        return L.softcap(logits, self.cfg.final_softcap), new_cache


# ---------------------------------------------------------------------------
# Parameter and cache init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, generator: torch.Generator, device=None,
                max_seq: int = 4096) -> Transformer:
    """A ``Transformer`` on ``device`` (default cuda) with the reference's
    distributions and scales, drawn from ``generator`` (which must live on
    that device). The values are the port's own, not JAX's."""
    model = Transformer(cfg, max_seq=max_seq, device=device)
    for mod in model.modules():
        if hasattr(mod, "init_"):
            mod.init_(generator)
    return model


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype, device) -> dict:
    KV, hd = cfg.n_kv_heads, cfg.head_dim

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if kind in ("attn", "attn_moe", "enc"):
        return {"k": z(batch, max_seq, KV, hd), "v": z(batch, max_seq, KV, hd)}
    if kind in WINDOWED_KINDS:
        S = min(cfg.window, max_seq)
        return {"k": z(batch, S, KV, hd), "v": z(batch, S, KV, hd)}
    if kind == "dec":
        return {"k": z(batch, max_seq, KV, hd), "v": z(batch, max_seq, KV, hd),
                "ck": z(batch, cfg.enc_seq, KV, hd), "cv": z(batch, cfg.enc_seq, KV, hd)}
    if kind == "rnn":
        w = cfg.rnn_width_eff
        return {"h": z(batch, w, dt=torch.float32), "conv": z(batch, cfg.conv_width - 1, w)}
    if kind == "rwkv":
        H, hd_r = cfg.n_rwkv_heads, cfg.rwkv_head_dim
        return {"S": z(batch, H, hd_r, hd_r, dt=torch.float32),
                "tm_x": z(batch, cfg.d_model), "cm_x": z(batch, cfg.d_model)}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    """An empty decode cache on ``device`` (default cuda), one dict per
    layer in the stack's layout."""
    dev = resolve_device(device)
    return {
        "blocks": {f"p{i}_{kind}": [init_layer_cache(cfg, kind, batch, max_seq, dtype, dev)
                                    for _ in range(cfg.n_blocks)]
                   for i, kind in enumerate(cfg.pattern) if cfg.n_blocks > 0},
        "rem": {f"r{i}_{cfg.pattern[i]}": init_layer_cache(cfg, cfg.pattern[i], batch,
                                                           max_seq, dtype, dev)
                for i in range(cfg.n_rem)},
    }
