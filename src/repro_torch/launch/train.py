"""Training launcher (port of ``repro.launch.train``), on one device or on a
mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 200 --reduced --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]
        [--mesh K [--backend gloo|nccl]] [--deterministic]

Wires together: config → seeded parameters (``models.init_params``) →
``SyntheticLM`` → ``make_train_step`` → checkpoint manager, straggler
watchdog and preemption handler. It resumes on its own from the latest
committed step of ``--ckpt-dir`` (written by this launcher, with or
without a mesh, or by the reference's: the leaves are the reference's
``(params, OptState)`` paths), and on SIGTERM commits the step it is at and
returns. A second run with a larger ``--steps`` on the same directory
continues the first. It runs on the card unless ``--device cpu``.

``--mesh K`` runs the same loop on K ranks (``launch.mesh.run_ranks``) over
``make_host_mesh()``, (2, 2) at K = 4 as the reference picks it. The
parameters and AdamW moments are placed by ``param_placements`` (fsdp off,
as the reference's launcher places them) and the batch is whole on every
rank, as the reference leaves it unplaced. The lead rank writes each
checkpoint as the full tree (gathered on every rank); every rank restores
the lead rank's latest step and places it. A SIGTERM to any rank is one
``host_verdict`` at the end of a step: every rank commits that step and
ends with exit 75 (``RankExit``), and so does the launcher; ``--resume``
is not needed, a relaunch continues. ``--deterministic`` turns on
``torch.use_deterministic_algorithms`` (bitwise resumes on the card need
it: the embedding's backward accumulates with atomics otherwise).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.distributed import barrier, host_verdict, is_lead, lead_values
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as S
from repro_torch.ft import CheckpointManager, PreemptionHandler, StragglerWatchdog
from repro_torch.launch.mesh import EXIT_PREEMPTED, RankExit, make_host_mesh, rank_device
from repro_torch.models import init_params
from repro_torch.train import AdamWConfig, OptState, TrainConfig, init_opt_state, make_train_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def device_batch(batch: dict, dev: torch.device) -> dict:
    """A pipeline's numpy batch on ``dev``: token ids as int64 (the index
    dtype of gathers), the rest as it comes."""
    return {k: torch.as_tensor(v, device=dev).long() if k in ("tokens", "labels")
            else torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _full_tree(model, opt_state: OptState, mesh) -> tuple:
    """The checkpoint tree of the training state; under a mesh gathered
    whole (a collective: every rank calls it)."""
    if mesh is None:
        return bridge.train_tree(model, opt_state)
    named = S.gather_tree(dict(model.named_parameters()), mesh)
    return bridge.train_tree(named, OptState(S.gather_tree(opt_state.mu, mesh),
                                             S.gather_tree(opt_state.nu, mesh), opt_state.step))


def run(cfg, tcfg: TrainConfig, dev: torch.device, *, steps: int, batch: int, seq: int,
        ckpt: CheckpointManager | None = None, save_every: int = 50, log_every: int = 10,
        mesh=None, log=print):
    """Train ``cfg`` from seeded parameters on ``SyntheticLM`` for ``steps``
    steps in all: resume from ``ckpt``'s latest committed step, save every
    ``save_every`` steps without blocking, and on SIGTERM commit the step
    it is at and return. Returns the last step's metrics (None when no step
    ran). Under ``mesh`` (module docstring) every rank calls it; a SIGTERM
    ends every rank with ``RankExit(EXIT_PREEMPTED, {"step": committed})``."""
    model = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev, max_seq=seq)
    opt_state = init_opt_state(model)
    data = SyntheticLM(vocab=cfg.vocab, batch=batch, seq_len=seq)
    lead = mesh is None or is_lead(mesh)

    latest = ckpt.latest_step() if ckpt else None
    if ckpt and mesh is not None:           # every rank restores the lead rank's step
        latest = int(lead_values(mesh, -1 if latest is None else latest)[0])
        latest = None if latest < 0 else latest
    start = 0
    if latest is not None:
        tree, extra = ckpt.restore(bridge.train_tree(model, opt_state), step=latest)
        bridge.load_train_tree(tree, model, opt_state)
        data.restore(extra["data"])
        start = extra["step"]
        log(f"resumed from step {start}")
    if mesh is not None:
        placements = S.param_placements(cfg, model, mesh)
        S.place_model(model, mesh, placements)
        opt_state = S.place_state(opt_state, mesh, placements)
    step_fn = make_train_step(cfg, tcfg, mesh=mesh)

    def save(step: int, blocking: bool = True):
        tree = _full_tree(model, opt_state, mesh)
        if lead:
            ckpt.save(step, tree, extra={"step": step, "data": data.state()}, blocking=blocking)

    def commit(step: int):
        if ckpt:
            if lead:
                ckpt.wait()
            save(step)
        if mesh is not None:
            barrier(mesh)                   # the lead rank's step is committed

    metrics = None
    watchdog = StragglerWatchdog()
    with PreemptionHandler() as preempt:
        t0 = time.perf_counter()
        for step in range(start, steps):
            model, opt_state, metrics = step_fn(model, opt_state, device_batch(next(data), dev))
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            watchdog.record(dt)
            if (step + 1) % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                log(f"step {step+1:5d} loss={m['loss']:.4f} "
                    f"ce={m['ce']:.4f} gnorm={m['grad_norm']:.3f} "
                    f"lr={m['lr']:.2e} dt={dt*1e3:.0f}ms")
            if ckpt and (step + 1) % save_every == 0:
                save(step + 1, blocking=False)
            stop = preempt.should_stop
            if mesh is not None:
                stop, _ = host_verdict(mesh, stop=stop, expired=False)
            if stop:
                log("preemption requested — checkpointing and exiting")
                commit(step + 1)
                if mesh is not None:
                    raise RankExit(EXIT_PREEMPTED, {"step": step + 1})
                return metrics
        commit(steps)
    if watchdog.flagged:
        log(f"straggler hosts flagged: {watchdog.flagged}")
    log("training complete")
    return metrics


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--compute-dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--mesh", type=int, default=0,
                    help="train on this many ranks over make_host_mesh() (0: one process)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="process-group backend of --mesh")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    return ap


def _launch(args, dev: torch.device, mesh=None, log=print):
    """``run`` as the flags say, on ``dev`` (under ``mesh``: this rank's)."""
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    where = f"device={dev}" if mesh is None else f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
    log(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M {where}")
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
        num_microbatches=args.microbatches,
        compute_dtype=DTYPES[args.compute_dtype],
        remat=True,
    )
    return run(cfg, tcfg, dev, steps=args.steps, batch=args.batch, seq=args.seq,
               ckpt=CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None,
               save_every=args.save_every, log_every=args.log_every, mesh=mesh, log=log)


def mesh_rank(mesh, payload: dict) -> dict:
    """One rank of ``--mesh K``: ``run`` on ``make_host_mesh()`` over this
    rank's device. Returns its log lines and last metrics; a SIGTERM ends
    it with exit 75 and the step it committed."""
    args = build_parser().parse_args(payload["argv"])
    dev = rank_device(mesh)
    lines: list[str] = []

    def log(msg: str):
        print(msg, flush=True)             # the rank's log: run_ranks watches it
        lines.append(msg)

    try:
        metrics = _launch(args, dev, make_host_mesh(device_type=dev.type), log)
    except RankExit as e:
        e.result["log"] = lines
        raise
    return {"log": lines, "metrics": None if metrics is None else
            {k: float(v) for k, v in metrics.items()}}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if not args.mesh:
        return _launch(args, resolve_device(args.device))
    from repro_torch.launch.mesh import run_ranks

    results = run_ranks("repro_torch.launch.train:mesh_rank", args.mesh, {"argv": argv},
                        backend=args.backend, device=args.device)
    print("\n".join(results[0]["log"]))
    codes = [r.get("exit_code", 0) for r in results]
    if any(codes):
        steps = sorted({r["step"] for r in results})
        print(f"{args.mesh} ranks preempted: exit codes {codes}, committed step(s) {steps}")
        raise SystemExit(EXIT_PREEMPTED)
    return results[0]["metrics"]


if __name__ == "__main__":
    main()
