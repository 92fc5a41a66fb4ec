"""Training step: masked cross-entropy with a z-loss, microbatched grad
accumulation, remat, AdamW, mixed precision (port of
``repro.train.step``).

The model is the port's ``Transformer``; a step updates its parameters in
place. Parameters, grads and AdamW's moments stay fp32; with a bf16
``compute_dtype`` every weight is cast at its use, so the projections run
in bf16 as the reference's do. The reference's ``scan_unroll`` is left
out: it unrolls XLA loops so that XLA's cost analysis counts every body,
which has no meaning for eager PyTorch.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer

from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    z_loss: float = 1e-4
    num_microbatches: int = 1
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    ce_chunks: int = 0         # > 0: blocked cross-entropy, never the (B, S, V) logits


def _masked(ll, lse, mask, z_loss):
    """(ce + z-loss, {"ce", "tokens"}) from per-token log-likelihoods and
    log-sum-exps: masked means over max(Σ mask, 1) tokens."""
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = -(ll * mask).sum() / denom
    loss = ce + z_loss * (lse.square() * mask).sum() / denom if z_loss else ce
    return loss, {"ce": ce, "tokens": denom}


def lm_loss(model: Transformer, cfg: ModelConfig, tokens, labels, mask, *, enc_feats=None,
            z_loss: float = 1e-4, compute_dtype=torch.bfloat16, remat: bool = True):
    """Next-token cross-entropy with an optional z-loss on lse². tokens,
    labels (B, S) int64; mask (B, S) fp32. Returns (loss, {"ce", "tokens"})."""
    del cfg                                         # the model's own
    logits, _ = model(tokens, enc_feats=enc_feats, compute_dtype=compute_dtype, remat=remat)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0] - lse
    return _masked(ll, lse, mask, z_loss)


def _chunk(x, w_c, c_idx, labels, run_max, run_sum, tgt, *, softcap: float):
    """One vocab chunk of the streaming log-sum-exp: the chunk's fp32
    logits, the running max and sum rescaled to the new max, and the target
    logit of each label that falls in this chunk."""
    logits_c = L.softcap((x @ w_c.to(x.dtype)).float(), softcap)
    Vc = logits_c.shape[-1]
    new_max = torch.maximum(run_max, logits_c.amax(dim=-1))
    run_sum = run_sum * torch.exp(run_max - new_max) + torch.exp(
        logits_c - new_max[..., None]).sum(dim=-1)
    local = labels - c_idx * Vc
    in_chunk = (local >= 0) & (local < Vc)
    li = torch.gather(logits_c, -1, torch.clamp(local, 0, Vc - 1)[..., None])[..., 0]
    return new_max, run_sum, tgt + torch.where(in_chunk, li, 0.0)


def blocked_lm_loss(model: Transformer, cfg: ModelConfig, tokens, labels, mask, *,
                    ce_chunks: int, enc_feats=None, z_loss: float = 1e-4,
                    compute_dtype=torch.bfloat16, remat: bool = True):
    """``lm_loss`` without the (B, S, V) logits: the final hidden states are
    made once, and the vocab is taken in ``ce_chunks`` chunks of the head,
    reshaped to (nc, d, V/nc), with a streaming log-sum-exp. With remat each
    chunk's body is recomputed in the backward pass, so one chunk's logits
    are alive at a time. The chunk count must divide the vocab."""
    x, _ = model.hidden(tokens, enc_feats=enc_feats, compute_dtype=compute_dtype, remat=remat)
    head = model.head()
    V, nc = head.shape[1], ce_chunks
    if V % nc:
        raise ValueError(f"vocab {V} not divisible by ce_chunks {nc}")
    head_r = head.reshape(cfg.d_model, nc, V // nc).permute(1, 0, 2)      # (nc, d, Vc)
    body = functools.partial(_chunk, softcap=cfg.final_softcap)
    if remat:
        body = functools.partial(checkpoint, body, use_reentrant=False,
                                 preserve_rng_state=False)
    B, S = tokens.shape
    run_max = torch.full((B, S), float("-inf"), device=x.device)
    run_sum = torch.zeros((B, S), device=x.device)
    tgt = torch.zeros((B, S), device=x.device)
    for c in range(nc):
        run_max, run_sum, tgt = body(x, head_r[c], c, labels, run_max, run_sum, tgt)
    lse = run_max + torch.log(run_sum)
    return _masked(tgt - lse, lse, mask, z_loss)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``, which updates the model's parameters and the state's
    moments in place.

    batch: {"tokens": (B, S) int64, "labels": (B, S) int64, "mask": (B, S)
    fp32, ["enc_feats"]: (B, E, d)}, on the model's device. The batch is
    split on its leading axis into ``num_microbatches`` microbatches; their
    grads are summed in fp32 from zeros into each parameter's ``.grad``, in
    microbatch order, and divided by their count; loss and ce are averaged.
    metrics: {"loss", "ce", "grad_norm", "lr"}, 0-d fp32 tensors."""
    loss_fn = (functools.partial(blocked_lm_loss, ce_chunks=tcfg.ce_chunks) if tcfg.ce_chunks
               else lm_loss)

    def train_step(model: Transformer, opt_state: OptState, batch: dict):
        nmb = tcfg.num_microbatches
        B = batch["tokens"].shape[0]
        if B % nmb:
            raise ValueError(f"batch {B} does not split into {nmb} microbatches")
        mb_size = B // nmb
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
        loss_sum = torch.zeros((), device=batch["tokens"].device)
        ce_sum = torch.zeros((), device=batch["tokens"].device)
        for i in range(nmb):
            mb = {k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()}
            loss, aux = loss_fn(model, cfg, mb["tokens"], mb["labels"], mb["mask"],
                                enc_feats=mb.get("enc_feats"), z_loss=tcfg.z_loss,
                                compute_dtype=tcfg.compute_dtype, remat=tcfg.remat)
            loss.backward()
            loss_sum += loss.detach()
            ce_sum += aux["ce"].detach()
        grads = {k: p.grad for k, p in params.items()}
        if nmb > 1:
            torch._foreach_div_(list(grads.values()), nmb)
        _, opt_state, om = adamw_update(tcfg.opt, params, grads, opt_state)
        return model, opt_state, {"loss": loss_sum / nmb, "ce": ce_sum / nmb, **om}

    return train_step


__all__ = [
    "TrainConfig",
    "AdamWConfig",
    "OptState",
    "init_opt_state",
    "lm_loss",
    "blocked_lm_loss",
    "make_train_step",
]
