"""The port's leg of ``examples/train_lm.py``: train a ~100M-parameter
qwen2-family model on the synthetic pipeline, with checkpointing and
resume.

    PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 300] [--device cpu]

(d_model 512, 8 layers, vocab 32k; AdamW, remat, bf16 compute, 2
microbatches.) It is ``launch.train.run`` with the example's config and
defaults, so it has the same watchdog, preemption handler and resume. It
runs on the card unless ``--device cpu``; a second run on the same
``--ckpt-dir`` resumes the first.
"""

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.ft import CheckpointManager
from repro_torch.launch.train import run
from repro_torch.train import AdamWConfig, TrainConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_config("qwen2-0.5b"),
        name="qwen2-100m",
        n_layers=8,
        d_model=512,
        n_heads=8,
        n_kv_heads=2,
        head_dim=64,
        d_ff=2048,
        vocab=32_768,
    )
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.0f}M  device={dev}")
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=3e-4, warmup_steps=50, total_steps=args.steps),
        num_microbatches=2,
        compute_dtype=torch.bfloat16,
    )
    m = run(cfg, tcfg, dev, steps=args.steps, batch=args.batch, seq=args.seq,
            ckpt=CheckpointManager(args.ckpt_dir, keep=2), save_every=100, log_every=25)
    print("done; final loss", None if m is None else float(m["loss"]))


if __name__ == "__main__":
    main()
