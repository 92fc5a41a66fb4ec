"""Training launcher (port of ``repro.launch.train``), on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 200 --reduced --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

Wires together: config → seeded parameters (``models.init_params``) →
``SyntheticLM`` → ``make_train_step`` → checkpoint manager, straggler
watchdog and preemption handler. It resumes on its own from the latest
committed step of ``--ckpt-dir`` (written by this launcher or by the
reference's: the leaves are the reference's ``(params, OptState)`` paths),
and on SIGTERM commits the step it is at and returns. A second run with a
larger ``--steps`` on the same directory continues the first. It runs on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.ft import CheckpointManager, PreemptionHandler, StragglerWatchdog
from repro_torch.models import init_params
from repro_torch.train import AdamWConfig, TrainConfig, init_opt_state, make_train_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def device_batch(batch: dict, dev: torch.device) -> dict:
    """A pipeline's numpy batch on ``dev``: token ids as int64 (the index
    dtype of gathers), the rest as it comes."""
    return {k: torch.as_tensor(v, device=dev).long() if k in ("tokens", "labels")
            else torch.as_tensor(v, device=dev) for k, v in batch.items()}


def run(cfg, tcfg: TrainConfig, dev: torch.device, *, steps: int, batch: int, seq: int,
        ckpt: CheckpointManager | None = None, save_every: int = 50, log_every: int = 10):
    """Train ``cfg`` from seeded parameters on ``SyntheticLM`` for ``steps``
    steps in all: resume from ``ckpt``'s latest committed step, save every
    ``save_every`` steps without blocking, and on SIGTERM commit the step
    it is at and return. Returns the last step's metrics (None when no step
    ran)."""
    model = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev, max_seq=seq)
    opt_state = init_opt_state(model)
    data = SyntheticLM(vocab=cfg.vocab, batch=batch, seq_len=seq)
    step_fn = make_train_step(cfg, tcfg)

    start = 0
    if ckpt and ckpt.latest_step() is not None:
        tree, extra = ckpt.restore(bridge.train_tree(model, opt_state))
        bridge.load_train_tree(tree, model, opt_state)
        data.restore(extra["data"])
        start = extra["step"]
        print(f"resumed from step {start}")

    def save(step: int, blocking: bool = True):
        ckpt.save(step, bridge.train_tree(model, opt_state),
                  extra={"step": step, "data": data.state()}, blocking=blocking)

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
                print(f"step {step+1:5d} loss={m['loss']:.4f} "
                      f"ce={m['ce']:.4f} gnorm={m['grad_norm']:.3f} "
                      f"lr={m['lr']:.2e} dt={dt*1e3:.0f}ms")
            if ckpt and (step + 1) % save_every == 0:
                save(step + 1, blocking=False)
            if preempt.should_stop:
                print("preemption requested — checkpointing and exiting")
                if ckpt:
                    ckpt.wait()
                    save(step + 1)
                return metrics
        if ckpt:
            ckpt.wait()
            save(steps)
    if watchdog.flagged:
        print("straggler hosts flagged:", watchdog.flagged)
    print("training complete")
    return metrics


def main(argv=None):
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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M device={dev}")

    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
        num_microbatches=args.microbatches,
        compute_dtype=DTYPES[args.compute_dtype],
        remat=True,
    )
    run(cfg, tcfg, dev, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt=CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None,
        save_every=args.save_every, log_every=args.log_every)


if __name__ == "__main__":
    main()
