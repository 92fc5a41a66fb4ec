"""Rank programs of sharded LM training and decode, for
``launch.mesh.run_ranks``.

``run_tasks(mesh, payload)`` runs a list of named tasks on every rank and
returns ``{name: result}``, as ``launch.sharded.run_tasks`` does for the
solver. Each task builds its own ``("data", "model")`` mesh over every
rank (``make_host_mesh(model)``, so ``model`` picks the shape: (1, 1) on one
rank, (1, 2) or (2, 1) on two, (2, 2) on four), its model from the
reference's parameters (``params``, numpy, through ``bridge``) or from a
seed, and returns full tensors on the CPU, gathered from their placed
blocks. Payload: ``{"tasks": [(name, kind, args), ...]}``, ``kind`` one
of:

* ``"train"``: args ``arch``, ``reduced`` (default True), ``n_layers``
  (optional), ``max_seq``, ``params`` or ``seed``, ``model`` (the mesh's
  model size), ``fsdp``, ``opt`` (AdamWConfig keywords), ``nmb``,
  ``batch`` (numpy, the global batch, placed by ``input_placements``: over
  the data dims where they divide it), ``steps`` →
  ``metrics`` (one dict of floats a step), ``placements``, and unless
  ``tensors`` is False the full ``params``, ``mu``, ``nu`` and last step's
  ``grads`` ({name: tensor}); with
  ``single`` the lead rank first runs the single-device step from the same
  parameters (``single``: its metrics, params, moments and grads); with ``measure``
  (the card) also per step ``ms`` (CUDA events) and ``traffic`` (bytes
  gathered and reduced, ``dist.sharding.TRAFFIC``), ``peak`` (peak device
  memory of the last, warm step; None on the CPU), ``placed_bytes`` (this rank's blocks of
  parameters, moments and grads) and the ms of one gather of every weight
  and of one reduction of full-size grads, timed alone;
* ``"decode"``: args as above (no ``fsdp``: the reference's decode places
  parameters with fsdp off), ``prompt`` (numpy (B, P)), ``new`` tokens,
  ``max_seq`` → ``logits`` (one (B, V) a step: prefill, then each decode
  step), ``ids`` (the argmaxes, and unless ``greedy`` is False
  ``greedy_ids`` of ``greedy_generate`` under the mesh), ``placements_kept`` (every cache leaf came back placed
  as it went in), ``input_unchanged`` (a step left its input cache as it
  was); with ``single`` the lead rank's single-device ``single_logits`` and
  ``single_ids``; ``ms`` of each step (and ``single_ms``);
* ``"imports"``: no args → the top-level packages of JAX or the reference
  that this rank has loaded (none: the port stands alone).
"""

from __future__ import annotations

import copy
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.distributed import is_lead
from repro_torch.dist import sharding as S
from repro_torch.launch.mesh import make_host_mesh, rank_device
from repro_torch.launch.train import device_batch
from repro_torch.models import init_cache, init_params
from repro_torch.serve.step import decode_step, greedy_generate, prefill_step
from repro_torch.train import AdamWConfig, TrainConfig, init_opt_state, make_train_step

F32 = torch.float32


def _cpu(tree):
    return S.tree_map(lambda t: t.detach().cpu(), tree)


def _model(a: dict, dev: torch.device):
    cfg = get_config(a["arch"])
    if a.get("reduced", True):
        cfg = cfg.reduced()
    if a.get("n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=a["n_layers"])
    if "params" in a:
        return cfg, bridge.model_from_numpy(a["params"], cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(a.get("seed", 0))
    return cfg, init_params(cfg, generator=g, device=dev, max_seq=a["max_seq"])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev):
    """(fn(), ms): CUDA events on the card, the host clock on the CPU."""
    _sync(dev)
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _train(dev, a):
    cfg, model = _model(a, dev)
    mesh = make_host_mesh(a["model"], device_type=dev.type)
    tcfg = TrainConfig(opt=AdamWConfig(**a["opt"]), num_microbatches=a["nmb"],
                       compute_dtype=F32, remat=True)
    batch = device_batch(a["batch"], dev)
    out = {}
    if a.get("single") and is_lead(mesh):
        ref = copy.deepcopy(model)
        st, step, ms = init_opt_state(ref), make_train_step(cfg, tcfg), []
        for _ in range(a["steps"]):
            ref, st, m = step(ref, st, batch)
            ms.append(_floats(m))
        out["single"] = {"metrics": ms, **_cpu({"params": dict(ref.named_parameters()),
                                               "mu": st.mu, "nu": st.nu,
                                               "grads": {k: p.grad for k, p in
                                                         ref.named_parameters()}})}
        del ref, st
    opt = init_opt_state(model)
    placements = S.param_placements(cfg, model, mesh, fsdp=a["fsdp"])
    S.place_model(model, mesh, placements)
    opt = S.place_state(opt, mesh, placements)
    batch = S.place_tree(batch, mesh, S.input_placements(batch, mesh))
    step = make_train_step(cfg, tcfg, mesh=mesh)
    measure = a.get("measure", False)
    metrics, times, traffic = [], [], []
    for i in range(a["steps"]):
        if measure and i == a["steps"] - 1 and dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for k in S.TRAFFIC:
            S.TRAFFIC[k] = 0
        (model, opt, m), ms = _timed(lambda: step(model, opt, batch), dev)
        metrics.append(_floats(m))
        times.append(ms)
        traffic.append(dict(S.TRAFFIC))
    out.update(metrics=metrics, placements=placements)
    if measure:
        out.update(ms=times, traffic=traffic, peak=torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else None)
        params = dict(model.named_parameters())
        out["placed_bytes"] = sum(t.to_local().numel() * t.to_local().element_size()
                                  for p in params.values() for t in (p, p.grad))
        out["placed_bytes"] += sum(t.to_local().numel() * t.to_local().element_size()
                                   for t in list(opt.mu.values()) + list(opt.nu.values()))
        for k in S.TRAFFIC:
            S.TRAFFIC[k] = 0
        full, out["gather_ms"] = _timed(lambda: S.gather_tree(params, mesh), dev)
        out["gather_bytes"] = S.TRAFFIC["gathered"]
        _, out["reduce_ms"] = _timed(lambda: S.reduce_data(list(full.values()), mesh), dev)
        out["reduce_bytes"] = S.TRAFFIC["reduced"]
        del full
    if a.get("tensors", True):
        out.update(_cpu({"params": S.gather_tree(dict(model.named_parameters()), mesh),
                         "mu": S.gather_tree(opt.mu, mesh), "nu": S.gather_tree(opt.nu, mesh),
                         "grads": S.gather_tree({k: p.grad for k, p in
                                                 model.named_parameters()}, mesh)}))
    return out


def _decode_loop(model, cfg, prompt, new: int, max_seq: int, dev, mesh=None):
    """Prefill, then ``new - 1`` greedy decode steps: (ids, [logits]) on the
    CPU, the cache checks, and the ms of each step."""
    cache = init_cache(cfg, prompt.shape[0], max_seq, dtype=F32, device=dev)
    if mesh is not None:
        placements = S.cache_placements(cfg, cache, mesh)
        cache = S.place_tree(cache, mesh, placements)
    full = (lambda t: S.gather(t, mesh)) if mesh is not None else (lambda t: t)
    (logits, cache), ms0 = _timed(lambda: prefill_step(
        model, cfg, prompt, cache, compute_dtype=F32, device=dev, mesh=mesh), dev)
    out = {"logits": [full(logits).cpu()], "ms": [ms0], "placements_kept": True,
           "input_unchanged": True}
    tok = torch.argmax(full(logits), dim=-1)[:, None]
    ids = [tok.cpu()]
    for pos in range(prompt.shape[1], prompt.shape[1] + new - 1):
        before = _cpu(S.gather_tree(cache, mesh)) if mesh is not None else None
        t = S.place_tree(tok, mesh, S.input_placements(tok, mesh)) if mesh is not None else tok
        (logits, new_cache), ms = _timed(lambda: decode_step(
            model, cfg, t, cache, pos, compute_dtype=F32, device=dev, mesh=mesh), dev)
        if mesh is not None:
            out["placements_kept"] &= all(
                a.placements == b.placements for a, b in zip(S.tree_leaves(new_cache), S.tree_leaves(cache)))
            out["input_unchanged"] &= all(torch.equal(a, b) for a, b in zip(
                S.tree_leaves(before), S.tree_leaves(_cpu(S.gather_tree(cache, mesh)))))
        cache = new_cache
        out["logits"].append(full(logits).cpu())
        out["ms"].append(ms)
        tok = torch.argmax(full(logits), dim=-1)[:, None]
        ids.append(tok.cpu())
    out["ids"] = torch.cat(ids, dim=1)
    return out


def _decode(dev, a):
    cfg, model = _model(a, dev)
    mesh = make_host_mesh(a["model"], device_type=dev.type)
    prompt = torch.as_tensor(a["prompt"], device=dev).long()
    out = {}
    if a.get("single") and is_lead(mesh):
        single = _decode_loop(model, cfg, prompt, a["new"], a["max_seq"], dev)
        out.update(single_logits=single["logits"], single_ids=single["ids"],
                   single_ms=single["ms"])
    S.place_model(model, mesh, S.param_placements(cfg, model, mesh))
    out.update(_decode_loop(model, cfg, S.place_tree(prompt, mesh, S.input_placements(
        prompt, mesh)), a["new"], a["max_seq"], dev, mesh))
    if a.get("greedy", True):
        ids = greedy_generate(model, cfg, S.place_tree(prompt, mesh, S.input_placements(
            prompt, mesh)), a["new"], max_seq=a["max_seq"], device=dev, mesh=mesh)
        out["greedy_ids"] = S.gather(ids, mesh).cpu()
    return out


def _imports(dev, a) -> list[str]:
    """The top-level packages of JAX or the reference this rank has loaded."""
    import sys

    return sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "repro"})


TASKS = {"train": _train, "decode": _decode, "imports": _imports}


def run_tasks(mesh, payload: dict) -> dict:
    dev = rank_device(mesh)
    if dev.type == "cuda":
        torch.set_float32_matmul_precision("highest")
    out = {"rank": dist.get_rank()}
    for name, kind, args in payload["tasks"]:
        out[name] = TASKS[kind](dev, args)
    return out
