"""The paper's solver on backbone features: fit a 10-class ridge readout on
a qwen2-0.5b backbone's final hidden states with the adaptive PCG and an
SJLT sketch (the torch leg of ``examples/ridge_probe.py``).

    PYTHONPATH=src python -m repro_torch.launch.ridge_probe [--device cpu] [--reduced]

Parameters come from ``models.init_params`` with a seeded generator; tokens,
the hidden linear map and the noise from seeded generators on the chosen
device. The features (B·S, d) are the final-norm hidden states over the
pattern blocks (the remainder layers are skipped, as in the example; qwen2
has none). ``--reduced`` runs the example's sizes (B 64, S 32 on the
reduced config); the default is the full width at B 256, S 32. Prints the
fit's relative error against the direct solve, the MSE on the fitted rows
and on held-out rows (B/4 more sequences) against mean(y²), the PCG's
iterations and final sketch size, and the seconds taken. Runs on cuda
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import AdaptiveConfig, adaptive_solve
from repro_torch.core.quadratic import direct_solve, from_least_squares
from repro_torch.device import require_on, resolve_device
from repro_torch.models import Transformer, init_params

CLASSES = 10
NU = 0.3
SEQ = 32
PROBE_CONFIG = AdaptiveConfig(method="pcg", sketch="sjlt", max_iters=100, tol=1e-9)


@torch.no_grad()
def backbone_features(model: Transformer, tokens) -> torch.Tensor:
    """Final-norm hidden states (B, S, D) in fp32 over the pattern blocks,
    position-major as ``Transformer.forward`` runs them; no remainder."""
    x = model.embed_tokens(tokens, torch.float32)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for _, _, _, layer in model.layers(remainder=False):
        x, _ = layer(x, positions)
    return model.final_norm(x)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_probe(model: Transformer, *, batch: int, seq: int, seed: int = 1, device=None) -> dict:
    """Features of ``batch`` random sequences, targets Y = F·W + 0.05·noise
    (W ~ N(0, 1/64)), the adaptive PCG/SJLT fit at ν = 0.3 against the
    direct solve, and held-out rows of ``batch // 4`` more sequences."""
    dev = resolve_device(device)
    require_on(dev, model=model.embed)
    cfg = model.cfg
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch + batch // 4, seq), generator=g, device=dev)
    t0 = time.perf_counter()
    feats = backbone_features(model, tokens).reshape(-1, cfg.d_model)
    _sync(dev)
    t_feats = time.perf_counter() - t0
    W_true = torch.randn((cfg.d_model, CLASSES), generator=g, device=dev) / 8
    Y = feats @ W_true + 0.05 * torch.randn((feats.shape[0], CLASSES), generator=g, device=dev)
    n = batch * seq
    F_fit, Y_fit, F_out, Y_out = feats[:n], Y[:n], feats[n:], Y[n:]

    q = from_least_squares(F_fit, Y_fit, NU)
    t0 = time.perf_counter()
    res = adaptive_solve(q, PROBE_CONFIG, seed=seed + 3, device=dev)
    _sync(dev)
    t_solve = time.perf_counter() - t0
    W_star = direct_solve(q)
    return {
        "features": tuple(F_fit.shape), "x": res.x, "q": q,
        "rel_err": float(torch.linalg.norm(res.x - W_star) / torch.linalg.norm(W_star)),
        "mse": float(torch.mean((F_fit @ res.x - Y_fit) ** 2)),
        "heldout_mse": float(torch.mean((F_out @ res.x - Y_out) ** 2)),
        "heldout_base": float(torch.mean(Y_out ** 2)),
        "iters": res.iters, "m_final": res.m_final, "n_doublings": res.n_doublings,
        "feature_s": t_feats, "solve_s": t_solve,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--reduced", action="store_true",
                   help="the reduced config at the example's B 64 (default: full width, B 256)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("qwen2-0.5b")
    if args.reduced:
        cfg = cfg.reduced()
    batch = 64 if args.reduced else 256
    model = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev, max_seq=SEQ)
    r = run_probe(model, batch=batch, seq=SEQ, seed=1, device=dev)
    print(f"features: {r['features']} from {cfg.name} on {dev} ({r['feature_s']:.3f} s)")
    print(f"adaptive PCG/SJLT: {r['solve_s']:.3f} s  iters={r['iters']} "
          f"m_final={r['m_final']}  rel_err_vs_direct={r['rel_err']:.2e}  mse={r['mse']:.4f}  "
          f"heldout_mse={r['heldout_mse']:.4f} (mean y² {r['heldout_base']:.4f})")
    return r


if __name__ == "__main__":
    main()
