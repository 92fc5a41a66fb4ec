"""Dry-run of the model cells: every (arch × shape × mesh) step traced per
rank on a fake 16×16 or 2×16×16 mesh, with nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out results/dryrun_torch] [--force]
        [--override k=v,...] [--ce-chunks N] [--no-fsdp] [--nmb1]

Port of ``repro.launch.dryrun``. The reference lowers and compiles each
cell's jitted program on 512 host devices and reads XLA's memory and cost
analyses; the port has no compiler, so each cell's step
(``launch.specs.cell_specs``: the port's own ``make_train_step``,
``prefill_step`` or ``decode_step`` under the mesh) runs eagerly as rank 0
of a mesh over a fake process group (``launch.mesh.make_production_mesh``)
under ``FakeTensorMode`` and the op recorder (``analysis.audit.op_trace``),
as ``launch.dryrun_solver`` traces the solver. Every tensor is a fake, every
collective moves no byte, and nothing is allocated on any device.

A record keeps the reference's layout (``arch``, ``shape``, ``mesh``,
``status`` ok / skipped / error with ``reason`` from
``configs.skip_reason``, ``params``, ``active_params``, ``step_kind``,
``flops``, ``hlo_dot_flops``, ``flops_by_dtype``, ``bytes_accessed``,
``collectives``, ``n_devices``), with ``trace_s`` in place of
``lower_s``/``compile_s``. What gives each number, per rank:

* ``hlo_dot_flops`` = ``flops``: the dot FLOPs of the traced step
  (``analysis.flops.dot_flops``, counted from the op trace), remat's
  recomputed forward included; ``flops_by_dtype`` splits them by operand dtype.
* ``bytes_accessed``: every computing op's tensor inputs and outputs
  (``analysis.flops.bytes_accessed``), the eager program's traffic with
  nothing fused.
* ``collectives``: the output bytes of every ``c10d`` collective the
  recorder saw (``analysis.collectives.collective_bytes_by_op``).
* ``memory``: ``argument_size_in_bytes``, the placed parameters, optimizer
  state and inputs, each leaf's local block (``local_bytes``: a DTensor's
  block is its placements' local shape); ``output_size_in_bytes``, the
  step's returned tensors counted alike, in-place updates included;
  ``temp_size_in_bytes``, the largest sum of storages the step itself made
  that were alive at once (``OpTrace.peak_live_bytes``: nothing the step
  was handed is in it; Python's cyclic collector is off while the step
  runs, so the figure is the same from run to run); ``memory_source``
  names each (``step_memory``, which the solver's records use too). None
  of them is a compiler's figure.

The records show the port as it is: under a mesh its steps gather every
weight whole by an all-reduce and reduce the full grads before slicing
them (``train.step``, ``serve.step``), so a train record's temp carries the
full fp32 weights and grads, and its collectives those bytes.

Records go to ``<out>/<mesh>/<arch>__<shape><tag>.json`` with the
reference's tags (``-<key>`` per override, ``-nofsdp``, ``-ce<N>``); a
cached ``ok``/``skipped`` record is reused unless ``--force``. A cell that
raises is recorded as ``error`` with its traceback, and the run exits 1 if
any cell is an error. ``analysis.roofline.analyze_record`` reads the
records; ``analysis.report`` renders them.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis.collectives import collective_bytes_by_op
from repro_torch.analysis.flops import DOTS, bytes_accessed, dot_flops, dot_flops_by_dtype
from repro_torch.configs import ALIASES, SHAPES, get_config, skip_reason

MEMORY_SOURCE = {
    "argument_size_in_bytes": "launch.dryrun.local_bytes of the step's arguments: each leaf's "
                              "local block (its placements' local shape) × itemsize",
    "output_size_in_bytes": "launch.dryrun.local_bytes of the step's result",
    "temp_size_in_bytes": "analysis.audit.op_trace peak_live_bytes: storages the traced step "
                          "made, alive at once, under FakeTensorMode, with Python's cyclic "
                          "collector off",
}


def local_bytes(tree) -> int:
    """Per-rank bytes of a step's arguments or result: a module's
    parameters, tensors (a DTensor's local block), and the trees holding
    them; host values 0."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, torch.nn.Module):
        return sum(local_bytes(p) for p in tree.parameters())
    if isinstance(tree, DTensor):
        return tree.to_local().numel() * tree.dtype.itemsize
    if torch.is_tensor(tree):
        return tree.numel() * tree.dtype.itemsize
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    return 0


def step_memory(args, trace) -> dict:
    """A record's ``memory`` from a traced step's arguments and its
    ``OpTrace`` (call it under the fake mode that made them)."""
    return {"argument_size_in_bytes": local_bytes(args),
            "output_size_in_bytes": local_bytes(trace.result),
            "temp_size_in_bytes": trace.peak_live_bytes,
            "memory_source": MEMORY_SOURCE}


def trace_cell(cell) -> dict:
    """Trace one cell's step (``specs.CellSpec``) as rank 0 of its mesh and
    return the record's measured fields."""
    from repro_torch.analysis.audit import op_trace as ot

    traffic = [0]

    def sink(site) -> bool:                  # keep the dots and collectives, count the bytes
        traffic[0] += bytes_accessed([site])
        return site.is_collective or site.base in DOTS

    t0 = time.perf_counter()
    with cell.fake_mode:
        trace = ot.record(lambda: cell.fn(*cell.args), sink=sink)
        memory = step_memory(cell.args, trace)
    dots = dot_flops(trace)
    by_dtype = dot_flops_by_dtype(trace)
    return dict(
        status="ok", step_kind=cell.step_kind, trace_s=round(time.perf_counter() - t0, 1),
        num_microbatches=cell.nmb,
        memory=memory,
        flops=float(dots), hlo_dot_flops=float(dots),
        flops_by_dtype={k: float(v) for k, v in by_dtype.items()},
        bytes_accessed=float(traffic[0]),
        collectives=collective_bytes_by_op(trace), n_devices=cell.mesh.size())


def run_cell(arch: str, shape, mesh_name: str, out_dir: Path | None,
             force: bool = False, force_nmb=None, cfg_overrides=None, tag: str = "",
             fsdp: bool = True, ce_chunks: int = 0, *, mesh_shape=None) -> dict:
    """One cell on one of the production meshes (or ``mesh_shape`` with its
    axis names), over a fake group; writes its record under ``out_dir``
    unless None. ``shape`` is a ``SHAPES`` key or a ``ShapeSpec``."""
    from repro_torch.launch.mesh import fake_mesh, make_production_mesh

    from .specs import cell_specs

    shape_name = shape if isinstance(shape, str) else shape.name
    out_file = None
    if out_dir is not None:
        out_file = Path(out_dir) / mesh_name / f"{arch}__{shape_name}{tag}.json"
        out_file.parent.mkdir(parents=True, exist_ok=True)
        if out_file.exists() and not force:
            rec = json.loads(out_file.read_text())
            if rec.get("status") in ("ok", "skipped"):
                print(f"[cached] {mesh_name}/{arch}/{shape_name}: {rec['status']}")
                return rec

    cfg = get_config(arch)
    if cfg_overrides:
        import dataclasses

        cfg = dataclasses.replace(cfg, **cfg_overrides)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "params": cfg.param_count(), "active_params": cfg.active_param_count()}
    reason = skip_reason(cfg, shape_name) if shape_name in SHAPES else None
    if reason:
        rec.update(status="skipped", reason=reason)
    else:
        if mesh_shape is None:
            mesh_cm = make_production_mesh(multi_pod=(mesh_name == "multi"))
        else:
            names = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
            mesh_cm = fake_mesh(tuple(mesh_shape), names)
        try:
            with mesh_cm as mesh:
                cell = cell_specs(arch, shape, mesh, force_nmb=force_nmb,
                                  cfg_overrides=cfg_overrides, fsdp=fsdp, ce_chunks=ce_chunks)
                rec.update(trace_cell(cell))
        except Exception as e:  # noqa: BLE001  a cell that fails is recorded: a bug to fix
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
    if out_file is not None:
        out_file.write_text(json.dumps(rec, indent=2))
    status = rec["status"]
    if status == "ok":
        mem = rec["memory"]
        extra = (f"trace={rec['trace_s']}s flops={rec['flops']:.3g} args "
                 f"{mem['argument_size_in_bytes'] / 2 ** 30:.2f} GiB temp "
                 f"{mem['temp_size_in_bytes'] / 2 ** 30:.2f} GiB/rank")
    else:
        extra = rec.get("reason") or rec.get("error", "")[:200]
    print(f"[{status:5s}] {mesh_name}/{arch}/{shape_name}: {extra}", flush=True)
    return rec


def _overrides(spec: str) -> tuple[dict | None, str]:
    """``k=v,...`` as ModelConfig overrides and their file tag, as the
    reference parses them."""
    if not spec:
        return None, ""
    out, tag = {}, ""
    for kv in spec.split(","):
        k, v = kv.split("=")
        out[k] = (v == "1" or v == "true") if v in ("0", "1", "true", "false") else (
            int(v) if v.isdigit() else v)
        tag += f"-{k.replace('_', '')}"
    return out, tag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--override", default="",
                    help="comma k=v ModelConfig overrides; adds '-<k>' to the file name")
    ap.add_argument("--ce-chunks", type=int, default=0,
                    help="blocked cross-entropy chunk count")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="TP-only parameter placement (tags the file)")
    ap.add_argument("--nmb1", action="store_true", help="force num_microbatches=1")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ALIASES)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    overrides, tag = _overrides(args.override)
    if args.no_fsdp:
        tag += "-nofsdp"
    if args.ce_chunks:
        tag += f"-ce{args.ce_chunks}"
    counts = {"ok": 0, "skipped": 0, "error": 0}
    t0 = time.perf_counter()
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_name, Path(args.out), args.force,
                               force_nmb=1 if args.nmb1 else None, cfg_overrides=overrides,
                               tag=tag, fsdp=not args.no_fsdp, ce_chunks=args.ce_chunks)
                counts[rec["status"]] += 1
    print(f"\ndone: {counts['ok']} ok, {counts['skipped']} skipped, {counts['error']} errors "
          f"in {time.perf_counter() - t0:.1f} s")
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
