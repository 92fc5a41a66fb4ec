"""AdamW with global-norm clipping and a warmup-cosine schedule (port of
``repro.train.optimizer``).

The state mirrors the parameters: ``mu`` and ``nu`` are fp32 tensors keyed
by the model's parameter names (``bridge.to_ref_tree`` lays them out as the
reference's trees), ``step`` an int32 scalar tensor on the parameters'
device. The update runs in place under ``torch.no_grad`` with multi-tensor
(``torch._foreach_*``) ops and keeps the reference's arithmetic on the
port's fp32 parameters: fp32 moments, bias corrections 1 − bᵗ with t cast
to fp32, the decay applied to the fp32 parameter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    mu: dict
    nu: dict
    step: torch.Tensor


def _named(params) -> dict[str, torch.Tensor]:
    """{name: tensor} of a module's parameters, or of a mapping as given."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def init_opt_state(params) -> OptState:
    """Zero moments in fp32 and step 0, for a module or a {name: tensor} map."""
    named = _named(params)
    mu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in named.items()}
    dev = next(iter(named.values())).device
    return OptState(mu=mu, nu={k: torch.zeros_like(m) for k, m in mu.items()},
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·lr, in fp32."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(grads) -> torch.Tensor:
    """√(Σ g²) over a list of fp32 tensors."""
    return torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()


def clip_by_global_norm(grads, max_norm: float, gn: torch.Tensor | None = None) -> torch.Tensor:
    """Scale a list of fp32 tensors in place by min(1, max_norm / ‖g‖);
    returns ‖g‖ before the scaling. ``gn`` is ‖g‖ when the list is one
    rank's shards of the gradient (its norm is the whole gradient's)."""
    gn = global_norm(grads) if gn is None else gn
    limit = torch.tensor(max_norm, dtype=torch.float32, device=gn.device)
    torch._foreach_mul_(grads, torch.clamp(limit / torch.clamp(gn, min=1e-12), max=1.0))
    return gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads: dict, state: OptState, *,
                 grad_norm: torch.Tensor | None = None):
    """One AdamW step; returns (params, new_state, {"grad_norm", "lr"}).

    ``params`` (a module or a {name: tensor} map) and the state's moments
    are updated in place; fp32 ``grads`` are scaled in place when clipping
    applies (the norm in the metrics is the norm before it). A sharded step
    passes its shards with ``grad_norm``, the whole gradient's norm: the
    update is elementwise, so each shard's is the full update's block."""
    named = _named(params)
    names = list(named)
    p = [named[k] for k in names]
    g = [grads[k] for k in names]
    if any(t.dtype != torch.float32 for t in p + g):
        raise ValueError("adamw_update takes fp32 parameters and grads (the models keep "
                         "fp32 parameters and cast them at use)")
    if cfg.grad_clip and cfg.grad_clip > 0:
        gn = clip_by_global_norm(g, cfg.grad_clip, grad_norm)
    else:
        gn = global_norm(g) if grad_norm is None else grad_norm

    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    m = [state.mu[k] for k in names]
    v = [state.nu[k] for k in names]
    torch._foreach_mul_(m, cfg.b1)                              # m = b1·m + (1 − b1)·g
    torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - cfg.b1))
    g2 = torch._foreach_mul(g, g)                               # v = b2·v + (1 − b2)·g²
    torch._foreach_mul_(g2, 1.0 - cfg.b2)
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_add_(v, g2)
    del g2
    denom = torch._foreach_div(v, b2c)                          # √(v / b2c) + eps
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    delta = torch._foreach_div(m, b1c)                          # (m / b1c) / denom + wd·p
    torch._foreach_div_(delta, denom)
    del denom
    torch._foreach_add_(delta, torch._foreach_mul(p, cfg.weight_decay))
    torch._foreach_mul_(delta, lr)                              # p − lr·delta
    torch._foreach_sub_(p, delta)
    return params, OptState(mu=state.mu, nu=state.nu, step=step), {"grad_norm": gn, "lr": lr}
