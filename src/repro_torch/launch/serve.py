"""Serving launcher: LM greedy decode of a seeded model, or random-shape
ridge, GLM and λ-path requests through the port's shape-class bucketing
and batched adaptive engine.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch qwen2-0.5b] \
        [--no-reduced] [--batch B] [--prompt-len S] [--new-tokens T] [--device cuda|cpu] \
        [--ckpt-dir D]
    PYTHONPATH=src python -m repro_torch.launch.serve --ridge --requests 64 \\
        [--glm N] [--path N] [--path-points P] \\
        [--sketch gaussian|gaussian_dense|sjlt|srht] [--dtype fp32|bf16|int8] \\
        [--device cuda|cpu] [--deadline-s T] [--segment-trips K] [--faulty N] \
        [--mesh K [--backend gloo|nccl]]
    PYTHONPATH=src python -m repro_torch.launch.serve --preempt-after S \\
        [--requests N] [--device cuda|cpu] [--mesh K [--backend gloo|nccl]]

Without ``--ridge`` or ``--preempt-after`` it serves LM traffic, as
``repro.launch.serve --arch`` does: the config (reduced unless
``--no-reduced``) gets seeded parameters (``models.init_params``), B random
prompts (and whisper's frame embeddings) come from a seeded generator, and
``serve.step.greedy_generate`` decodes them in fp32; it prints tokens/s and
the first sequence's ids. ``--ckpt-dir`` replaces the seeded parameters
with those of the latest training checkpoint there, written by the port's
``launch.train`` or the reference's (the ``0/…`` leaves of its ``(params,
OptState)`` tree), as ``repro.launch.serve --ckpt-dir`` does.

The ridge path mirrors ``repro.launch.serve --ridge``; the data is drawn
from a seeded ``torch.Generator`` on the chosen device. ``--glm N`` adds N logistic
requests (``synthetic_logistic_problem``, ν uniform in [0.1, 0.5]) solved
by sketched Newton; ``--path N`` adds N ridge requests over a grid of
``--path-points`` values of ν (geomspace(1, 1e-2)), each grid solved off one
sketch pass, with the ladder cache on, and then resubmits the first one to
show a cache hit. ``--sketch`` is the service's default family (the
n = 16384 class keeps its SRHT) and ``--dtype`` the sketch pass's precision;
certificates stay fp32 and record both. ``--deadline-s`` bounds the flush:
requests that run out of time come back DEADLINE_EXCEEDED with their best
iterates, the ridge solves running in segments of ``--segment-trips`` loop
trips. ``--faulty N`` adds N NaN-filled requests under ``strict=False``:
they come back REJECTED without touching their neighbours.

``--mesh K`` serves the same traffic on K ranks (``launch.mesh.run_ranks``),
a sharded service (``SolverService(mesh=)``) on each: every rank draws the
same requests, keeps its row block of each packed batch and gets the same
answers; rank 0's report is printed. The default classes then include the
pod-scale (65536, 256, 512, srht) class. The ranks use gloo unless
``--backend nccl`` (which needs a card per rank). ``--deadline-s`` binds
there too, on the lead rank's clock (one verdict a segment boundary).

``--preempt-after S`` runs the preemption cycle instead: it starts
``python -m repro_torch.launch.solve_service`` with a checkpoint directory
as a subprocess, sends it SIGTERM S seconds after its flush began, requires
exit code 75 (the in-flight chunk committed), restarts it with
``--resume``, and requires a clean exit with every answer finite and
audited against a direct solve. A flush that ends before the signal fails
the cycle. With ``--mesh K`` (K ≥ 2) the cycle runs on K ranks
(``launch.mesh.run_ranks``), each a sharded preemptible service on the
same requests: an uninterrupted run first; then SIGTERM goes to the last
rank only, and every rank must exit 75 after the same segment (the
verdict), rank 0 alone having written the checkpoints; then ``--resume``
must give answers bitwise the uninterrupted run's on every rank:

    PYTHONPATH=src python -m repro_torch.launch.serve --mesh 4 --preempt-after 0.3
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.level_grams import COMPUTE_DTYPES, PADDED_SKETCHES
from repro_torch.core.objectives import synthetic_logistic_problem
from repro_torch.device import resolve_device
from repro_torch.ft import CheckpointManager
from repro_torch.models import init_params
from repro_torch.serve.solver_service import GLMSolution, PathSolution, SolverService
from repro_torch.serve.step import greedy_generate


def _shape(g, dev) -> tuple[int, int]:
    n = int(torch.randint(64, 1800, (), generator=g, device=dev))
    d = int(torch.randint(8, 120, (), generator=g, device=dev))
    return n, d


def serve_ridge(args, mesh=None) -> dict:
    svc = SolverService(method="pcg", sketch=args.sketch, compute_dtype=args.dtype,
                        segment_trips=args.segment_trips, ladder_cache=bool(args.path),
                        strict=not args.faulty, mesh=mesh, device=args.device)
    dev = svc.device
    g = torch.Generator(device=dev).manual_seed(args.seed)
    for _ in range(args.requests):
        n, d = _shape(g, dev)
        A = torch.randn((n, d), generator=g, device=dev) / n ** 0.5
        y = torch.randn((n,), generator=g, device=dev)
        nu = 0.05 + 0.45 * float(torch.rand((), generator=g, device=dev))
        svc.submit(A, y, nu=nu)
    for _ in range(args.faulty):
        # quarantined at submit: REJECTED, never packed with the others
        svc.submit(torch.full((128, 16), float("nan"), device=dev),
                   torch.zeros(128, device=dev), nu=0.1)
    for _ in range(args.glm):
        A, y = synthetic_logistic_problem(g, *_shape(g, dev))
        nu = 0.1 + 0.4 * float(torch.rand((), generator=g, device=dev))
        svc.submit_glm(A, y, nu, family="logistic")
    paths = {}
    nus = np.geomspace(1.0, 1e-2, args.path_points)
    for _ in range(args.path):
        # strong → weak regularization, so the warm starts move downhill
        n, d = _shape(g, dev)
        A = torch.randn((n, d), generator=g, device=dev) / n ** 0.5
        y = torch.randn((n,), generator=g, device=dev)
        paths[svc.submit_path(A, y, nus)] = (A, y)
    t0 = time.perf_counter()
    sols = svc.flush(deadline_s=args.deadline_s)
    dt = time.perf_counter() - t0
    print(f"solver service on {dev} (sketch={args.sketch}, dtype={args.dtype}): "
          f"{len(sols)} requests in {dt:.2f}s "
          f"({len(sols) / dt:.1f} req/s) — {svc.stats['batches']} batches of "
          f"{svc.batch_size}, {svc.stats['padded_slots']} padded slots "
          f"({100 * svc.slot_utilization():.0f}% slot utilization"
          + ("" if mesh is None else f", {args.mesh} ranks in a data mesh") + ")")
    glm = [s for s in sols.values() if isinstance(s, GLMSolution)]
    path = [s for s in sols.values() if isinstance(s, PathSolution)]
    ok = [s for s in sols.values()
          if s.converged and not isinstance(s, (GLMSolution, PathSolution))]
    if ok:
        m = sorted(s.m_final for s in ok)
        print(f"ridge certificates: m_final min/median/max = "
              f"{m[0]}/{m[len(m) // 2]}/{m[-1]}, "
              f"max residual δ̃ = {max(s.delta_tilde for s in ok):.2e}")
    counts: dict[str, int] = {}
    for s in sols.values():
        counts[s.status] = counts.get(s.status, 0) + 1
    print("statuses: " + ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
          + f"; retries={svc.stats['retries']}, fallbacks={svc.stats['fallbacks']}, "
          f"rejected={svc.stats['rejected']}, "
          f"deadline_exceeded={svc.stats['deadline_exceeded']}, "
          f"segments={svc.stats['segments']}")
    if glm:
        outer = [s.newton_iters for s in glm]
        print(f"glm certificates (logistic): {sum(s.converged for s in glm)}/{len(glm)} "
              f"converged, outer iters min/max = {min(outer)}/{max(outer)}, "
              f"max decrement λ̃²/2 = {max(s.decrement for s in glm):.2e}, "
              f"m trajectory (req {glm[0].req_id}): {glm[0].m_trajectory}")
    if path:
        pts = [p for s in path for p in s.points]
        print(f"path certificates: {sum(s.converged for s in path)}/{len(path)} grids "
              f"converged ({args.path_points} λ points each), "
              f"{sum(s.sketch_passes for s in path)} one-touch passes total, "
              f"max δ̃ = {max(p.delta_tilde for p in pts):.2e}, warm m trajectory "
              f"(req {path[0].req_id}): {tuple(p.m_final for p in path[0].points)}")
        # the same grid again: its ladder comes from the fingerprint cache
        A, y = paths[min(paths)]
        rid = svc.submit_path(A, y, nus)
        warm = svc.flush()[rid]
        print(f"repeat-A path round: cache_hit={warm.cache_hit}, "
              f"sketch_passes={warm.sketch_passes} (ladder served from the "
              f"fingerprint cache; {svc.stats['sketch_passes_saved']} passes saved)")
    return sols


def mesh_rank(mesh, payload: dict) -> str:
    """One rank of ``--mesh K``: the sharded service on this rank's device;
    returns what ``serve_ridge`` printed."""
    import contextlib
    import io

    from repro_torch.launch.mesh import rank_device

    args = argparse.Namespace(**payload)
    args.device = str(rank_device(mesh))
    if args.device.startswith("cuda"):
        torch.set_float32_matmul_precision("highest")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_ridge(args, mesh=mesh)
    return out.getvalue()


def serve_mesh(args) -> None:
    from repro_torch.launch.mesh import run_ranks

    backend = args.backend or "gloo"
    texts = run_ranks("repro_torch.launch.serve:mesh_rank", args.mesh, vars(args),
                      backend=backend, device=args.device)
    print(texts[0], end="")
    if any(t.splitlines()[1:] != texts[0].splitlines()[1:] for t in texts[1:]):
        raise SystemExit("the ranks' certificates differ")
    print(f"{args.mesh} ranks ({backend}) gave the same certificates")


def preempt_rank(mesh, payload: dict) -> dict:
    """One rank of ``--mesh K --preempt-after S``: ``launch.solve_service``'s
    preemptible service (the cycle's flags, a SIGTERM handler) sharded over
    ``mesh``, on the same requests on every rank. A preemption ends the rank
    with exit 75 and its segment; a finished flush returns every answer."""
    from repro_torch.core import PreemptedError
    from repro_torch.launch.mesh import EXIT_PREEMPTED, RankExit, rank_device
    from repro_torch.launch.solve_service import (
        build_parser,
        preemptible_service,
        submit_requests,
    )

    args = build_parser().parse_args(payload["argv"])
    dev = rank_device(mesh)
    if dev.type == "cuda":
        torch.set_float32_matmul_precision("highest")
    svc = preemptible_service(args, mesh=mesh, device=dev)
    requests, _ = submit_requests(svc, args)
    print("FLUSH START", flush=True)
    try:
        sols = svc.flush()
    except PreemptedError as e:
        raise RankExit(EXIT_PREEMPTED, {"segment": e.segment}) from None
    return {"x": [sols[rid].x.cpu() for rid in requests],
            "status": [sols[rid].status for rid in requests],
            "resumed_chunks": svc.stats["resumed_chunks"]}


def serve_preempt_mesh(args) -> None:
    """The preemption cycle on ``--mesh K`` ranks: an uninterrupted run,
    then a run whose last rank (never rank 0) gets SIGTERM S seconds into
    its flush: every rank must exit 75 at the same segment; then a
    ``--resume`` run whose answers must be bitwise the uninterrupted ones."""
    from repro_torch.launch.mesh import EXIT_PREEMPTED, run_ranks

    job, K, victim = "repro_torch.launch.serve:preempt_rank", args.mesh, args.mesh - 1
    flags = [*PREEMPT_CHILD_FLAGS, "--requests", str(args.requests)]
    kw = dict(backend=args.backend or "gloo", device=args.device, timeout=CHILD_TIMEOUT_S)
    ref_dir, ck = tempfile.mkdtemp(prefix="preempt_ref_"), tempfile.mkdtemp(prefix="preempt_ck_")
    try:
        ref = run_ranks(job, K, {"argv": flags + ["--checkpoint-dir", ref_dir]}, **kw)
        pre = run_ranks(job, K, {"argv": flags + ["--checkpoint-dir", ck]}, **kw,
                        signal_rank=(victim, "FLUSH START", args.preempt_after))
        codes = [r.get("exit_code", 0) for r in pre]
        segments = {r["segment"] for r in pre if r.get("exit_code") == EXIT_PREEMPTED}
        print(f"preemption cycle on {K} ranks: SIGTERM to rank {victim} "
              f"{args.preempt_after} s into the flush; exit codes {codes}, preempted at "
              f"segment(s) {sorted(segments)}", flush=True)
        if codes != [EXIT_PREEMPTED] * K or len(segments) != 1:
            raise SystemExit("every rank must exit 75 after the same segment (a flush that "
                             "ends before the signal does not count)")
        res = run_ranks(job, K, {"argv": flags + ["--checkpoint-dir", ck, "--resume"]}, **kw)
        same = all(torch.equal(a, b) for r in res for a, b in zip(r["x"], ref[0]["x"]))
        same = same and all(r["status"] == ref[0]["status"] for r in res)
        resumed = res[0]["resumed_chunks"]
        print(f"resumed run: {resumed} chunks resumed; every rank's answers bitwise the "
              f"uninterrupted run's: {same}; statuses {ref[0]['status']}")
        if not (same and resumed > 0):
            raise SystemExit("the resumed answers are not the uninterrupted run's")
        print(f"preemption cycle OK on {K} ranks: SIGTERM on one rank → every rank exits 75 "
              f"→ --resume → bitwise the uninterrupted answers")
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
        shutil.rmtree(ck, ignore_errors=True)


# the preempted child: at tol = 0 a chunk iterates until δ̃ is exactly 0
# (70-80 iterations on this traffic) or the 1200-iteration cap, with no
# retry and no fallback, so the flush is long enough for the signal to land
# in it, and the restarted run still ends
PREEMPT_CHILD_FLAGS = ("--tol", "0", "--max-iters", "1200", "--max-retries", "0",
                       "--no-fallback", "--segment-trips", "16")
CHILD_TIMEOUT_S = 600


def serve_preempt(args) -> None:
    """SIGTERM → exit 75 → ``--resume``: the preemptible service end to end,
    each subprocess under its own time limit."""
    src = Path(__file__).resolve().parents[2]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(src)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))}
    ck = tempfile.mkdtemp(prefix="preempt_ck_")
    cmd = [sys.executable, "-u", "-m", "repro_torch.launch.solve_service",
           "--requests", str(args.requests), *PREEMPT_CHILD_FLAGS, "--checkpoint-dir", ck]
    if args.device:
        cmd += ["--device", args.device]
    try:
        print(f"preemption cycle: checkpoints in {ck}", flush=True)
        p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        # a child that hangs before its flush is killed, which ends the read
        watchdog = threading.Timer(CHILD_TIMEOUT_S, p.kill)
        watchdog.start()
        lines = []
        try:
            for line in p.stdout:        # S counts from the start of the flush
                lines.append(line)
                if line.startswith("FLUSH START"):
                    break
            time.sleep(args.preempt_after)
            p.send_signal(signal.SIGTERM)
            out, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
        finally:
            watchdog.cancel()
            p.kill()
        print("".join(lines) + out, end="")
        if p.returncode != 75:
            raise SystemExit(f"preempted service exited {p.returncode}, expected 75 (a "
                             f"flush that ends before the signal does not count)")
        r = subprocess.run(cmd + ["--resume"], env=env, capture_output=True, text=True,
                           timeout=CHILD_TIMEOUT_S)
        print(r.stdout, end="")
        if r.returncode != 0:
            raise SystemExit(f"resumed service exited {r.returncode}:\n{r.stderr[-2000:]}")
        for mark in ("ALL_FINITE=1", "AUDIT_OK=1"):
            if mark not in r.stdout:
                raise SystemExit(f"resumed service did not report {mark}")
        print("preemption cycle OK: SIGTERM → exit 75 → --resume → every answer finite "
              "and audited")
    finally:
        shutil.rmtree(ck, ignore_errors=True)


def serve_lm(args) -> torch.Tensor:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    max_seq = args.prompt_len + args.new_tokens + 1
    g = torch.Generator(device=dev).manual_seed(args.seed)
    model = init_params(cfg, generator=g, device=dev, max_seq=max_seq)
    if args.ckpt_dir:
        like = bridge.to_ref_tree({k: p.detach() for k, p in model.named_parameters()})
        tree, extra = CheckpointManager(args.ckpt_dir).restore((like, None))
        bridge.load_train_tree(tree, model)
        print(f"restored the parameters of training step {extra.get('step')} from "
              f"{args.ckpt_dir}")
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=g, device=dev)
    enc = (torch.randn((args.batch, cfg.enc_seq, cfg.d_model), generator=g, device=dev)
           if cfg.n_enc_layers else None)
    t0 = time.perf_counter()
    out = greedy_generate(model, cfg, prompts, args.new_tokens, max_seq=max_seq,
                          enc_feats=enc, device=dev)
    ids = out[0].tolist()                     # waits for the card
    dt = time.perf_counter() - t0
    print(f"{cfg.name} on {dev}: {args.batch}×{args.new_tokens} tokens in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    print("ids:", ids)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="qwen2-0.5b",
                   help="LM traffic (the default workload): the config to decode with")
    p.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                   help="the config's reduced form (--no-reduced: the published width)")
    p.add_argument("--batch", type=int, default=4, help="LM prompts (not the ridge batch)")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--ckpt-dir", default="",
                   help="decode with the parameters of the latest training checkpoint "
                        "here (written by either package's train launcher)")
    p.add_argument("--ridge", action="store_true",
                   help="serve solver traffic instead of LM decode")
    p.add_argument("--preempt-after", type=float, default=None,
                   help="run the preemption cycle instead: SIGTERM the checkpointing "
                        "service demo this many seconds into its flush, then resume it")
    p.add_argument("--requests", type=int, default=None,
                   help="ridge requests (default 24; 6 under --preempt-after)")
    p.add_argument("--faulty", type=int, default=0,
                   help="NaN-filled requests, served with strict=False: REJECTED")
    p.add_argument("--glm", type=int, default=0,
                   help="logistic GLM requests, solved by sketched Newton")
    p.add_argument("--path", type=int, default=0,
                   help="λ-path requests, each grid off one sketch pass (turns "
                        "the ladder cache on)")
    p.add_argument("--path-points", type=int, default=8,
                   help="grid points per λ-path request")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sketch", default="gaussian", choices=PADDED_SKETCHES,
                   help="sketch family of the ridge service")
    p.add_argument("--dtype", default="fp32", choices=COMPUTE_DTYPES,
                   help="sketch-pass compute dtype: bf16 rounds the sketch "
                        "operands to bfloat16 with fp32 sums, int8 also "
                        "quantizes A per row; certificates stay fp32")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="wall-clock budget for the flush; requests that run out "
                        "of it return DEADLINE_EXCEEDED with their best iterate")
    p.add_argument("--segment-trips", type=int, default=32,
                   help="loop trips per segment of a deadline-bound solve")
    p.add_argument("--mesh", type=int, default=0,
                   help="serve on this many ranks, each a sharded service holding "
                        "its row block (0: one process, no mesh)")
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                   help="process-group backend of --mesh (default gloo)")
    args = p.parse_args(argv)
    if args.preempt_after is not None:
        args.requests = 6 if args.requests is None else args.requests
        if args.mesh:
            if args.mesh < 2:
                p.error("--mesh K with --preempt-after needs K ≥ 2: the signal goes to a "
                        "rank other than rank 0")
            return serve_preempt_mesh(args)
        return serve_preempt(args)
    if not args.ridge:
        return serve_lm(args)
    args.requests = 24 if args.requests is None else args.requests
    if args.mesh:
        return serve_mesh(args)
    return serve_ridge(args)


if __name__ == "__main__":
    main()
