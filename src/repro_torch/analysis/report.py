"""Render the dry-run's §Dry-run and §Roofline sections from its records.

    PYTHONPATH=src python -m repro_torch.analysis.report [--dir results/dryrun_torch]

Port of ``repro.analysis.report``. Both sections read one directory, where
``launch.dryrun`` (the model cells) and ``launch.dryrun_solver`` (the
solver's) write: the port has no scans to unroll, so the program the
dry-run traces is the production program and there is no separate
analysis sweep. On records in the reference's layout ``dryrun_table``
prints the reference's rows; a port record, traced and not compiled, says
``trace {trace_s}s`` where the reference says ``compile {compile_s}s``.
The roofline terms are H100 data-sheet arithmetic
(``analysis.roofline``), not measurements.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .roofline import analyze_record, markdown_table

RESULTS = "results/dryrun_torch"


def dryrun_table(results_dir=RESULTS) -> str:
    rows = []
    for f in sorted(Path(results_dir).glob("*/*.json")):
        r = json.loads(f.read_text())
        if r["status"] == "skipped":
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | skipped | — | — "
                f"| — | {r['reason'][:58]} |"
            )
            continue
        if r["status"] != "ok":
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR | — | — "
                f"| — | {r.get('error','')[:58]} |"
            )
            continue
        mem = r["memory"]
        args_gb = (mem.get("argument_size_in_bytes") or 0) / 2**30
        temp_gb = (mem.get("temp_size_in_bytes") or 0) / 2**30
        coll_gb = r["collectives"]["total_bytes"] / 2**30
        n_coll = sum(v["count"] for v in r["collectives"]["by_op"].values())
        note = (f"compile {r['compile_s']}s" if "compile_s" in r
                else f"trace {r['trace_s']}s")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {args_gb:.2f} | {temp_gb:.2f} | {coll_gb:.2f} ({n_coll}) "
            f"| {note} |"
        )
    hdr = (
        "| arch | shape | mesh | status | args GiB/dev | temp GiB/dev | "
        "collective GiB/dev (#ops) | notes |\n|---|---|---|---|---|---|---|---|\n"
    )
    return hdr + "\n".join(rows) + "\n"


def _sentence(bottleneck: str, solver: bool) -> str:
    """What would move a cell that ``bottleneck`` bounds, on the H100."""
    if bottleneck == "memory":
        if solver:
            return ("the A-stream dominates: the sketch and each PCG matvec re-read the "
                    "row shard from HBM3; bf16 matvecs halve the stream, fusing the "
                    "sketch with the first matvec removes one pass")
        return ("the eager step's HBM3 traffic dominates: every op reads and writes its "
                "operands unfused (attention's score matrices, the fp32 logits and their "
                "grads); fused attention and the blocked cross-entropy cut it")
    if bottleneck == "collective":
        if solver:
            return ("the per-iteration AᵀAv partial-sum all-reduce over NVLink dominates: "
                    "block PCG iterations or move to the one-all-reduce ladder precompute "
                    "(core.distributed)")
        return ("the whole-weight gathers (an all-reduce of every weight's bytes) and the "
                "full-grad reductions over NVLink dominate: gather a layer's weights as it "
                "runs and reduce-scatter the grads instead")
    return ("compute-bound at the tensor cores' bf16 peak (fp32 products at the fp32 "
            "peak): only fewer FLOPs or more of them in bf16 move it")


def roofline_section(results_dir=RESULTS) -> str:
    recs = []
    for f in sorted(Path(results_dir).glob("single/*.json")):
        r = analyze_record(json.loads(f.read_text()))
        if r:
            recs.append(r)
    out = [markdown_table(recs)]
    out.append("\nPer-cell bottleneck sentences:\n")
    for r in recs:
        s = _sentence(r.bottleneck, r.arch.startswith("solver"))
        out.append(f"* **{r.arch}/{r.shape}** → {r.bottleneck}-bound; {s}.\n")
    return "".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=RESULTS)
    args = ap.parse_args(argv)
    print("## §Dry-run (traced per rank, 16×16 and 2×16×16 fake meshes)\n")
    print(dryrun_table(args.dir))
    print("\n## §Roofline (single mesh, H100 SXM data-sheet terms)\n")
    print(roofline_section(args.dir))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
