"""Training step: masked cross-entropy with a z-loss, microbatched grad
accumulation, remat, AdamW, mixed precision (port of
``repro.train.step``), on one device or under a ``("data", "model")`` mesh.

The model is the port's ``Transformer``; a step updates its parameters in
place. Parameters, grads and AdamW's moments stay fp32; with a bf16
``compute_dtype`` every weight is cast at its use, so the projections run
in bf16 as the reference's do. The reference's ``scan_unroll`` is left
out: it unrolls XLA loops so that XLA's cost analysis counts every body,
which has no meaning for eager PyTorch.

Under a mesh (the reference jits the same step over GSPMD-placed
parameters; here the placement is explicit, ``dist.sharding``) the model's
parameters and the AdamW moments are DTensors that stay sharded between
steps. A step gathers each weight whole once, keeps it for every
microbatch's forward, remat recompute and backward, sums the full grads
over the data dims, keeps this rank's block of them (``.grad`` of the
placed parameter) and runs AdamW on the blocks with the whole gradient's
norm; the gathered weights and full grads are dropped when it returns.
The batch is either split over the data dims (``input_placements``:
Shard(0) on every data dim) or whole on every rank (plain tensors, or
every placement Replicate). A split batch keeps the single-device
microbatches: microbatch i is global rows [i·B/nmb, (i+1)·B/nmb), each rank
runs the part of it that it holds (which may be none), and each
microbatch's Σ mask, the divisor of its ce and z-loss, is summed over the
data dims first, so the loss and grads are the single-device ones up to
the order of those sums.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.core.distributed import data_index
from repro_torch.dist import sharding as S
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


def _masked(ll, lse, mask, z_loss, denom=None):
    """(ce + z-loss, {"ce", "tokens"}) from per-token log-likelihoods and
    log-sum-exps: masked means over max(Σ mask, 1) tokens, or over
    ``denom`` (a split batch's microbatch count, summed over the ranks)."""
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
    ce = -(ll * mask).sum() / denom
    loss = ce + z_loss * (lse.square() * mask).sum() / denom if z_loss else ce
    return loss, {"ce": ce, "tokens": denom}


def lm_loss(model: Transformer, cfg: ModelConfig, tokens, labels, mask, *, enc_feats=None,
            z_loss: float = 1e-4, compute_dtype=torch.bfloat16, remat: bool = True,
            denom=None):
    """Next-token cross-entropy with an optional z-loss on lse². tokens,
    labels (B, S) int64; mask (B, S) fp32; ``denom`` as in ``_masked``.
    Returns (loss, {"ce", "tokens"})."""
    del cfg                                         # the model's own
    logits, _ = model(tokens, enc_feats=enc_feats, compute_dtype=compute_dtype, remat=remat)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0] - lse
    return _masked(ll, lse, mask, z_loss, denom)


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
                    compute_dtype=torch.bfloat16, remat: bool = True, denom=None):
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
    return _masked(tgt - lse, lse, mask, z_loss, denom)


def _accumulate(loss_fn, model, cfg, tcfg, batch, spans, denoms):
    """Sum the grads of each microbatch's loss (rows ``spans[i]`` of the
    batch, divisor ``denoms[i]``) into every parameter's ``.grad``, zeroed
    first, in microbatch order; an empty span is skipped. Returns the sums
    of the losses and ces."""
    for p in model.parameters():
        p.requires_grad_(True)
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()
    dev = batch["tokens"].device
    loss_sum, ce_sum = torch.zeros((), device=dev), torch.zeros((), device=dev)
    for (lo, hi), denom in zip(spans, denoms):
        if hi <= lo:
            continue
        mb = {k: v[lo:hi] for k, v in batch.items()}
        loss, aux = loss_fn(model, cfg, mb["tokens"], mb["labels"], mb["mask"],
                            enc_feats=mb.get("enc_feats"), z_loss=tcfg.z_loss,
                            compute_dtype=tcfg.compute_dtype, remat=tcfg.remat, denom=denom)
        loss.backward()
        loss_sum += loss.detach()
        ce_sum += aux["ce"].detach()
    return loss_sum, ce_sum


def _split_rows(batch: dict, mesh) -> bool:
    """Whether the batch's rows are split over the data dims (Shard(0) on
    every data dim, Replicate on ``model``) or whole on every rank."""
    names = mesh.mesh_dim_names
    split = tuple(Replicate() if n == "model" else Shard(0) for n in names)
    whole = (Replicate(),) * len(names)
    kinds = {tuple(v.placements) if isinstance(v, DTensor) else whole for v in batch.values()}
    if kinds == {whole}:
        return False
    if kinds == {split}:
        return True
    raise ValueError(f"batch placements {kinds}: each leaf must be split over the data dims "
                     f"({split}) or whole on every rank")


def _grad_norm(grads: dict, placed: dict, mesh) -> torch.Tensor:
    """The whole gradient's norm from this rank's blocks: each block's Σ g²,
    counted on the first rank of each mesh dim that replicates it, summed
    over the mesh (one all-reduce)."""
    keys = list(grads)
    sq = torch.stack(torch._foreach_norm([grads[k] for k in keys])).square()
    counted = [all(isinstance(pl, Shard) or mesh.get_local_rank(i) == 0
                   for i, pl in enumerate(placed[k].placements)) for k in keys]
    total = (sq * torch.tensor(counted, dtype=sq.dtype, device=sq.device)).sum()
    S.reduce_mesh(total, mesh)
    return total.sqrt()


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, mesh=None):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``, which updates the model's parameters and the state's
    moments in place.

    batch: {"tokens": (B, S) int64, "labels": (B, S) int64, "mask": (B, S)
    fp32, ["enc_feats"]: (B, E, d)}, on the model's device. The batch is
    split on its leading axis into ``num_microbatches`` microbatches; their
    grads are summed in fp32 from zeros into each parameter's ``.grad``, in
    microbatch order, and divided by their count; loss and ce are averaged.
    metrics: {"loss", "ce", "grad_norm", "lr"}, 0-d fp32 tensors.

    With ``mesh`` (a ``("data", "model")`` DeviceMesh) the model and state
    are placed (``dist.sharding.place_model``, ``place_state``) and the
    batch split over the data dims or whole (module docstring); the metrics
    are the same, on every rank, and each placed parameter's ``.grad`` holds
    this rank's block of the (clipped) gradient."""
    loss_fn = (functools.partial(blocked_lm_loss, ce_chunks=tcfg.ce_chunks) if tcfg.ce_chunks
               else lm_loss)
    nmb = tcfg.num_microbatches

    def spans(B: int, row0: int = 0, rows: int | None = None):
        if B % nmb:
            raise ValueError(f"batch {B} does not split into {nmb} microbatches")
        mb, rows = B // nmb, B if rows is None else rows
        return [(min(max(i * mb - row0, 0), rows), min(max((i + 1) * mb - row0, 0), rows))
                for i in range(nmb)]

    def train_step(model: Transformer, opt_state: OptState, batch: dict):
        loss_sum, ce_sum = _accumulate(loss_fn, model, cfg, tcfg, batch,
                                       spans(batch["tokens"].shape[0]), [None] * nmb)
        params = dict(model.named_parameters())
        grads = {k: p.grad for k, p in params.items()}
        if nmb > 1:
            torch._foreach_div_(list(grads.values()), nmb)
        _, opt_state, om = adamw_update(tcfg.opt, params, grads, opt_state)
        return model, opt_state, {"loss": loss_sum / nmb, "ce": ce_sum / nmb, **om}

    def sharded_step(model: Transformer, opt_state: OptState, batch: dict):
        split = _split_rows(batch, mesh)
        local = {k: v.to_local() if isinstance(v, DTensor) else v for k, v in batch.items()}
        rows = local["tokens"].shape[0]
        sp = spans(batch["tokens"].shape[0], data_index(mesh) * rows if split else 0, rows)
        counts = torch.stack([local["mask"][lo:hi].sum() for lo, hi in sp])
        if split:
            S.reduce_data([counts], mesh)
        placed = dict(model.named_parameters())
        full = {k: nn.Parameter(S.gather(p, mesh)) for k, p in placed.items()}
        with S.materialized(model, full):
            loss_sum, ce_sum = _accumulate(loss_fn, model, cfg, tcfg, local, sp,
                                           list(torch.clamp(counts, min=1.0)))
        grads = [full[k].grad for k in placed]
        if nmb > 1:
            torch._foreach_div_(grads, nmb)
        sums = torch.stack([loss_sum, ce_sum])
        if split:
            S.reduce_data(grads + [sums], mesh)
        with torch.no_grad():
            blocks = {k: S.local_part(full[k].grad, p.placements, mesh)
                      for k, p in placed.items()}
            del full, grads
            state = OptState({k: v.to_local() for k, v in opt_state.mu.items()},
                             {k: v.to_local() for k, v in opt_state.nu.items()}, opt_state.step)
            _, state, om = adamw_update(tcfg.opt, {k: p.to_local() for k, p in placed.items()},
                                        blocks, state, grad_norm=_grad_norm(blocks, placed, mesh))
        for k, p in placed.items():
            p.grad = S.placed(blocks[k], mesh, p.placements, p.shape)
        return (model, OptState(opt_state.mu, opt_state.nu, state.step),
                {"loss": sums[0] / nmb, "ce": sums[1] / nmb, **om})

    return train_step if mesh is None else sharded_step


__all__ = [
    "TrainConfig",
    "AdamWConfig",
    "OptState",
    "init_opt_state",
    "lm_loss",
    "blocked_lm_loss",
    "make_train_step",
]
