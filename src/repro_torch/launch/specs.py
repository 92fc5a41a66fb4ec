"""Fake-tensor stand-ins for every model dry-run cell: nothing is allocated.

Port of ``repro.launch.specs``. ``cell_specs(arch, shape, mesh)`` returns
what the dry-run (``launch.dryrun``) needs to trace a cell: the step kind,
the port's own step function and its arguments as fake tensors, placed on
``mesh`` (a ``DeviceMesh``, in the dry-run one over a fake process group)
by ``dist.sharding``'s rules, with the placements beside them.

* train: ``make_train_step(cfg, tcfg, mesh=mesh)`` on a ``Transformer``
  built under ``FakeTensorMode`` (fp32 parameters, fsdp by default,
  ``max_seq`` = S for learned positions else 4096), its ``OptState``, and a
  batch of tokens, labels (int64), mask (fp32) and, for an encoder
  config, ``enc_feats`` (B, enc_seq, d_model) bf16, split over the data
  axes; ``microbatches_for(cfg, B)`` microbatches.
* prefill / decode: ``prefill_step`` / ``decode_step`` with ``mesh=`` on
  bf16 parameters placed without fsdp, a bf16 cache of ``seq_len``
  (``cache_placements``), the tokens split over the data axes; decode
  writes the cache's last slot (``cache_pos`` = S − 1, a host int in the
  port).

The reference builds ``ShapeDtypeStruct`` trees with ``jax.eval_shape``
and lowers one jitted program; the port has no compiler, so the arguments
are real modules and tensors whose storage is fake, and the dry-run runs
the step eagerly on them. The reference's ``scan_unroll`` has no meaning
here: the port's layers are a Python loop, not a scan, and its
``TrainConfig`` has no ``scan_unroll``, so every layer and microbatch is
traced as it runs. The reference's ``batch_axes`` (which its sharding
module lacks: it fails at import, ROADMAP queue 3, F6) is not needed: the
data axes are every mesh axis but ``model`` (``dist.sharding``), so a
``("pod", "data", "model")`` mesh splits the batch over pod and data.

Tokens are int64 (the port's index dtype), where the reference's are
int32; byte counts of the arguments follow the port's dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.dist import sharding
from repro_torch.models import Transformer, init_cache
from repro_torch.models.config import ModelConfig


def microbatches_for(cfg: ModelConfig, global_batch: int) -> int:
    """Keep per-microbatch logits + activations bounded: target a global
    microbatch of 32 sequences for wide models, 64 otherwise (the
    reference's rule)."""
    target = 32 if cfg.d_model >= 3584 or cfg.n_experts else 64
    nmb = max(1, global_batch // target)
    while global_batch % nmb:
        nmb -= 1
    return nmb


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: str
    step_kind: str                  # train | prefill | decode
    fn: Callable                    # fn(*args) runs the step on ``mesh``
    args: tuple                     # placed fake tensors (a Transformer first)
    placements: tuple               # per argument: its placement tree (None: a host int)
    mesh: Any
    fake_mode: Any                  # the FakeTensorMode that made ``args``
    nmb: int = 1


def params_dtype_struct(cfg: ModelConfig, max_seq: int, dtype=None, *,
                        fake_mode=None) -> Transformer:
    """A ``Transformer`` whose parameters are fake tensors (fp32, or
    ``dtype``): the port's counterpart of the reference's ``eval_shape``
    of ``init_params``. Made under ``fake_mode`` (a new one if None)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with fake_mode or FakeTensorMode():
        model = Transformer(cfg, max_seq=max_seq, device="cpu")
        if dtype is not None:
            for name, p in list(model.named_parameters()):
                owner, _, leaf = name.rpartition(".")
                setattr(model.get_submodule(owner), leaf,
                        torch.nn.Parameter(p.detach().to(dtype), requires_grad=False))
    return model


def cell_specs(arch: str, shape_name: str | ShapeSpec, mesh, *,
               force_nmb: int | None = None, cfg_overrides: dict | None = None,
               fsdp: bool = True, ce_chunks: int = 0) -> CellSpec:
    """The cell (module docstring). ``shape_name`` is a ``SHAPES`` key or a
    ``ShapeSpec`` of its own."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.serve.step import decode_step, prefill_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step

    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shp = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    B, S = shp.global_batch, shp.seq_len
    mode = FakeTensorMode()

    def inputs(batch):
        pl = sharding.input_placements(batch, mesh)
        return sharding.place_tree(batch, mesh, pl), pl

    if shp.step == "train":
        max_seq = S if cfg.pos_embedding == "learned" else 4096
        model = params_dtype_struct(cfg, max_seq, fake_mode=mode)
        with mode:
            p_pl = sharding.param_placements(cfg, model, mesh, fsdp=fsdp)
            opt = init_opt_state(model)
            sharding.place_model(model, mesh, p_pl)
            opt = sharding.place_state(opt, mesh, p_pl)
            batch = {"tokens": torch.zeros((B, S), dtype=torch.int64),
                     "labels": torch.zeros((B, S), dtype=torch.int64),
                     "mask": torch.zeros((B, S))}
            if cfg.n_enc_layers:
                batch["enc_feats"] = torch.zeros((B, cfg.enc_seq, cfg.d_model),
                                                 dtype=torch.bfloat16)
            batch, b_pl = inputs(batch)
        nmb = force_nmb or microbatches_for(cfg, B)
        tcfg = TrainConfig(opt=AdamWConfig(), num_microbatches=nmb, ce_chunks=ce_chunks)
        return CellSpec(arch=arch, shape=shp.name, step_kind="train",
                        fn=make_train_step(cfg, tcfg, mesh=mesh), args=(model, opt, batch),
                        placements=(p_pl, type(opt)(p_pl, p_pl, None), b_pl), mesh=mesh,
                        fake_mode=mode, nmb=nmb)

    # ---- inference cells: bf16 parameters, placed without fsdp ----
    model = params_dtype_struct(cfg, S, torch.bfloat16, fake_mode=mode)
    with mode:
        p_pl = sharding.param_placements(cfg, model, mesh, fsdp=False)
        sharding.place_model(model, mesh, p_pl)
        cache = init_cache(cfg, B, S, dtype=torch.bfloat16, device="cpu")
        c_pl = sharding.cache_placements(cfg, cache, mesh)
        cache = sharding.place_tree(cache, mesh, c_pl)
        if shp.step == "prefill":
            feeds = {"tokens": torch.zeros((B, S), dtype=torch.int64)}
            if cfg.n_enc_layers:
                feeds["enc_feats"] = torch.zeros((B, cfg.enc_seq, cfg.d_model),
                                                 dtype=torch.bfloat16)
        else:
            feeds = {"tokens": torch.zeros((B, 1), dtype=torch.int64)}
        feeds, f_pl = inputs(feeds)

    if shp.step == "prefill":
        def fn(model, tokens, cache, enc_feats=None):
            return prefill_step(model, cfg, tokens, cache, enc_feats=enc_feats, mesh=mesh)

        args = (model, feeds["tokens"], cache) + ((feeds["enc_feats"],) if "enc_feats" in feeds
                                                  else ())
        pls = (p_pl, f_pl["tokens"], c_pl) + ((f_pl["enc_feats"],) if "enc_feats" in f_pl
                                              else ())
        return CellSpec(arch=arch, shape=shp.name, step_kind="prefill", fn=fn,
                        args=args, placements=pls, mesh=mesh, fake_mode=mode)

    # decode: one new token against a seq_len cache, written at its last slot
    def dfn(model, token, cache, cache_pos):
        return decode_step(model, cfg, token, cache, cache_pos, mesh=mesh)

    return CellSpec(arch=arch, shape=shp.name, step_kind="decode", fn=dfn,
                    args=(model, feeds["tokens"], cache, S - 1),
                    placements=(p_pl, f_pl["tokens"], c_pl, None), mesh=mesh, fake_mode=mode)
