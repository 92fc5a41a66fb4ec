"""One run of one cell: set-up, the measured window, the optional traced
slice, the comparison with the reference, the metrics, the result line.

``main`` is the command (``bench/run.py``): it looks for the cards the
cell asks for and refuses to run without them. ``run_cell`` is the rest of
a run on any device, so the tests can drive it on the CPU at a small size.
A result's ``compiled`` says whether the run compiled the program's kernels
(a checkout's first run), whose set-up is not comparable with the others'.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time

import torch

from bench import check, manifest
from bench.trace import DeviceTrace, summarize

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a metric's reader reads (``bench/metrics/<name>.py``)."""
    setup_s: float
    window_s: float                # the measured window, whole steps
    records: dict                  # the entry's records of the window
    answers: list                  # check.Answer of the window and the traced slice
    verdict: check.Verdict
    counters: dict                 # the entry's counters over the window
    window_peak_bytes: int         # device memory peak inside the window
    trace: object = None           # trace.TraceSummary of the traced slice


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "power.limit not read"
    except (OSError, subprocess.SubprocessError):
        return "power.limit not read"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if isinstance(after[k], (int, float))}


def kernels_built() -> int:
    """Kernel libraries that the program compiled in this process (its
    ``kernels._build.COUNTS``): more than 0 in a run that compiled."""
    build = sys.modules.get("repro_torch.kernels._build")
    return build.COUNTS["builds"] if build is not None else 0


def steady() -> None:
    """Before the window: what set-up left behind is collected once and
    moved out of the collector's sight, so that no collection inside the
    window walks the imports' and the pool's objects."""
    gc.collect()
    gc.freeze()


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t0: float | None = None, control: bool = False
             ) -> tuple[dict, list[str]]:
    """Run ``cell`` once; returns (the result object, the lines for
    standard error). ``t0`` is the process's start on the host clock;
    ``control`` puts the control in the program's place before the
    comparison (a calibration, never a benchmark run)."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    t_entry = time.perf_counter()
    run = manifest.entry(cell.entry, cell.root).setup(cell, seed, dev)
    _sync(dev)
    t_warm = time.perf_counter()
    run.step(record=False)                 # warm: every shape the traffic uses
    _sync(dev)
    steady()
    t_start = time.perf_counter()
    setup_s = t_start - t0
    built = kernels_built()
    err = [f"setup {setup_s} s: imports {t_entry - t0} s, the traffic's pool {run.pool_s} s, "
           f"the program and the card {t_warm - t_entry - run.pool_s} s, "
           f"warm step {t_start - t_warm} s; kernel libraries compiled: {built}"]
    setup_peak = 0
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    before = run.counters()
    gc_before = [g["collections"] for g in gc.get_stats()]
    steps = []
    start = t = time.perf_counter()
    while t - start < seconds:
        run.step()
        steps.append(time.perf_counter() - t)
        t += steps[-1]
    if hasattr(run, "drain"):          # an open loop answers what arrived in the window
        run.drain()
        t = time.perf_counter()
    window_s = t - start
    gcs = [g["collections"] - b for g, b in zip(gc.get_stats(), gc_before)]
    slow = sorted(range(len(steps)), key=lambda k: -steps[k])[:3]
    err.append(f"window {window_s} s: {len(steps)} steps, ms median "
               f"{sorted(steps)[len(steps) // 2] * 1e3}, slowest "
               + ", ".join(f"{steps[k] * 1e3} (step {k}, at {sum(steps[:k])} s)" for k in slow)
               + f"; collections by generation {gcs}")
    counters = _delta(before, run.counters())
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    summary = None
    if trace:
        run.window = False
        with DeviceTrace(dev) as tr:
            t_slice = time.perf_counter()
            while time.perf_counter() - t_slice < float(cell.config["trace_seconds"]):
                run.step()
        summary = summarize(tr)

    answers = run.answers
    run.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checker = manifest.checker(cell.config["check"]["module"], cell.root)
    if control:
        answers = checker.control(run.pool, answers)
    verdict = checker.compare(run.pool, answers, run.attempted, cell.config["check"])
    ctx = Context(setup_s=setup_s, window_s=window_s, records=run.records,
                  answers=answers, verdict=verdict, counters=counters,
                  window_peak_bytes=window_peak, trace=summary)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(m["name"], cell.root)(ctx)
        if value is None:
            err.append(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace and dev.type == "cuda":
        card = card_power()
        for name, v in metrics.items():
            if name.endswith("_roofline"):
                err.append(f"{name} {v['value']} % of the data-sheet bound (bench/roofline.py), "
                           f"on {card}")

    failed = sum(1 for a in answers if not a.certified) + verdict.numbers["missing_answers"][0]
    result = {
        "correct": verdict.correct,
        "attempted": run.attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": cell.chips,
            "memory_peak_bytes": max(setup_peak, window_peak),
        },
        "compiled": built > 0,
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in verdict.numbers.items()}
    err += [f"check {k}: {v} (limit {lim})" for k, (v, lim) in verdict.numbers.items()]
    return result, err


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: float | None = None) -> int:
    args = parse(argv)
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, err = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda:0", t0=t0)
    found = forbidden_modules()
    if found:
        print(f"bench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for line in err:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
