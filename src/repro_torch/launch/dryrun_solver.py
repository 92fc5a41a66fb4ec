"""Dry-run of the paper's solver at pod scale: one adaptive phase, traced
per rank on a fake 16×16 or 2×16×16 mesh, with nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_solver \\
        [--variant all|baseline|2d|2d-bf16|flat|flat-bf16|gaussian] \\
        [--mesh single|multi|both] [--out results/dryrun_torch]

Port of ``repro.launch.dryrun_solver``. The workload is the reference's
distributed ridge-probe head fit at ``SOLVER_SHAPES["probe_2m_8k"]``: A
(n = 2²¹, d = 8192) row-sharded, B = AᵀY (d, c = 1024) replicated, and one
adaptive phase: sketch (m = 16384) → factorize H_S = (SA)ᵀSA + ν²I →
10 PCG iterations on the (d, c) block. The reference lowers one jitted
program with shardings and lets GSPMD partition it; the port writes out
the per-rank program that partitioning gives and traces it under
``FakeTensorMode`` on a mesh over a fake process group
(``launch.mesh.make_production_mesh``): every tensor is a fake, every
collective is a functional collective on the mesh's groups, and nothing is
allocated. The variants, with the reference's names:

* ``baseline``: A's rows over the data axes, the model axis idle (each model
  rank repeats its data rank's work); the SJLT sketch is a scatter-add of
  the local rows into (m, d) and one all-reduce over the data axes; each
  H·v all-reduces the (d, c) partial AᵀAv over the data axes.
* ``2d``: A's rows over the data axes and its columns over the model axis;
  the sketch's (m, d/M) partials are all-reduced over the data axes and
  all-gathered over the model axis into (m, d) for H_S; each H·v has one
  all-reduce per A-pass, of the (n/K, c) product Av over the model axis and
  of the (d/M, c) block of AᵀAv over the data axes, and an all-gather of
  the (d, c) result over the model axis (the PCG state stays replicated).
* ``flat``: A's rows over every rank of the mesh; the baseline's
  collectives over the whole mesh.
* ``2d-bf16``, ``flat-bf16``: A·v and Aᵀ(Av) in bf16 with fp32 results;
  the reductions stay fp32.
* ``gaussian``: the baseline's layout with a dense bf16 S of the rank's
  (m, n/K) columns: SA = S·A in bf16 with an fp32 result, scaled by 1/√m.

What the trace counts (the record says which numbers are analytic):

* ``hlo_dot_flops``: the per-rank program's dot FLOPs,
  ``torch.utils.flop_counter.FlopCounterMode`` (``analysis.flops``).
  Factorizations, triangular solves and the SJLT's scatter-add are not
  dots; ``analytic_flops`` counts them (d³/3 for the Cholesky, d²·c per
  triangular solve, two per preconditioner solve, and the sketch).
* ``sketch``: the port's sketch kernels launch through ``ctypes`` on real
  pointers and cannot run on fake tensors, so the trace runs the plain
  version's shape (the SJLT's scatter-add, the Gaussian's dense product)
  and the record counts the kernel's work from ``analysis.roofline``'s
  ``sjlt_terms`` / ``gauss_sa_terms``.
* ``collectives``: the output bytes of every functional collective the
  op recorder saw (``analysis.collectives.collective_bytes_by_op``; the
  recorder runs under ``FakeTensorMode``).
* ``bytes_accessed``: each computing op's tensor inputs and outputs (views
  excluded), the eager program's traffic with nothing fused.

Records go to ``<out>/<mesh>/solver__ridge-<variant>.json`` in the
reference's layout; ``analysis.roofline.analyze_record`` reads them.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis.collectives import collective_bytes_by_op
from repro_torch.analysis.flops import dot_flops, dot_flops_by_dtype
from repro_torch.analysis.roofline import SOLVER_SHAPES, gauss_sa_terms, sjlt_terms

VARIANTS = ("baseline", "2d", "2d-bf16", "flat", "flat-bf16", "gaussian")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
SHAPE = "probe_2m_8k"
NU = 1e-1
_VIEWS = frozenset({"aten.view", "aten._unsafe_view", "aten.permute", "aten.t",
                    "aten.transpose", "aten.slice", "aten.select", "aten.expand",
                    "aten.alias", "aten.unsqueeze", "aten.squeeze", "aten.as_strided",
                    "aten.detach", "prim.device", "_c10d_functional.wait_tensor"})


def _groups(mesh):
    """(the data axes' group, the model axis' group or None, the whole
    mesh's group), each a ``DeviceMesh`` a functional collective takes."""
    names = mesh.mesh_dim_names
    data = tuple(a for a in names if a != "model")
    data_mesh = mesh[data[0]] if len(data) == 1 else mesh[data]._flatten()
    model_mesh = mesh["model"] if "model" in names else None
    return data_mesh, model_mesh, mesh._flatten() if mesh.ndim > 1 else mesh


def per_rank_dims(variant: str, dims: dict, mesh) -> dict:
    """This variant's per-rank shapes: K data shards, M model ranks, the
    rank's rows ``n_l`` and A's columns ``d_l``."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    M = sizes.get("model", 1)
    K = math.prod(v for a, v in sizes.items() if a != "model")
    rows = K * M if variant.startswith("flat") else K
    if dims["n"] % rows:
        raise ValueError(f"n={dims['n']} does not divide over {rows} row shards")
    d_l = dims["d"] // M if variant.startswith("2d") else dims["d"]
    return dict(K=K, M=M, n_l=dims["n"] // rows, d_l=d_l)


def phase_program(variant: str, dims: dict, mesh):
    """The per-rank program of one adaptive phase; returns a function of no
    arguments that runs it on fake inputs (call it under ``FakeTensorMode``)."""
    import torch.distributed._functional_collectives as funcol

    n, d, c, m, iters = (dims[k] for k in ("n", "d", "c", "m", "pcg_iters"))
    pr = per_rank_dims(variant, dims, mesh)
    n_l, d_l = pr["n_l"], pr["d_l"]
    data_g, model_g, all_g = _groups(mesh)
    rows_g = all_g if variant.startswith("flat") else data_g
    mv = torch.bfloat16 if variant.endswith("bf16") else torch.float32
    two_d = variant.startswith("2d")

    def reduce(t, group):
        return funcol.all_reduce(t, "sum", group)

    def gather_cols(t):            # (rows, d/M) blocks → (rows, d), over the model axis
        return funcol.all_gather_tensor(t.T.contiguous(), 0, model_g).T

    def program():
        A = torch.empty((n_l, d_l), dtype=torch.float32)
        Y = torch.empty((d, c), dtype=torch.float32)          # B = AᵀY, replicated
        if variant == "gaussian":
            S = torch.empty((m, n_l), dtype=torch.bfloat16)
            SA = reduce((S @ A.to(torch.bfloat16)).float() / math.sqrt(m), rows_g)
        else:
            rows = torch.empty((n_l,), dtype=torch.int64)
            signs = torch.empty((n_l,), dtype=torch.float32)
            SA = torch.zeros((m, d_l)).index_add_(0, rows, A * signs[:, None])
            SA = reduce(SA, rows_g)
            if two_d:
                SA = gather_cols(SA)
        H_S = SA.T @ SA + NU * NU * torch.eye(d)
        L = torch.linalg.cholesky(H_S)

        def precond(z):
            y = torch.linalg.solve_triangular(L, z, upper=False)
            return torch.linalg.solve_triangular(L.T, y, upper=True)

        Am = A.to(mv)

        def hvp(v):
            if two_d:
                vb = v.reshape(pr["M"], d_l, c)[0]                 # this rank's columns
                av = reduce((Am @ vb.to(mv)).float(), model_g)
                g = reduce((Am.T @ av.to(mv)).float(), data_g)
                g = funcol.all_gather_tensor(g, 0, model_g)
            else:
                av = (Am @ v.to(mv)).float()
                g = reduce((Am.T @ av.to(mv)).float(), rows_g)
            return g + NU * NU * v

        x = torch.zeros((d, c))
        r = Y - hvp(x)
        rt = precond(r)
        p, dt = rt, torch.sum(r * rt)
        for _ in range(iters):
            Hp = hvp(p)
            alpha = dt / torch.clamp(torch.sum(p * Hp), min=1e-30)
            x = x + alpha * p
            r = r - alpha * Hp
            rt = precond(r)
            dt_new = torch.sum(r * rt)
            p = rt + dt_new / torch.clamp(dt, min=1e-30) * p
            dt = dt_new
        return x, dt

    return program


def analytic_flops(variant: str, dims: dict, mesh) -> dict:
    """Per-rank FLOPs the dot count leaves out: the Cholesky, the triangular
    solves (two a preconditioner solve, iters + 1 solves) and the SJLT's
    scatter-add (``sjlt_terms``; the Gaussian's product is a dot)."""
    d, c, m, iters = dims["d"], dims["c"], dims["m"], dims["pcg_iters"]
    pr = per_rank_dims(variant, dims, mesh)
    out = {"cholesky": d ** 3 / 3.0, "triangular_solves": 2.0 * (iters + 1) * d * d * c}
    if variant != "gaussian":
        out["sketch_scatter_add"] = sjlt_terms(1, pr["n_l"], pr["d_l"], m, shared=True,
                                               index_itemsize=8)[0]
    return out


def trace_record(variant: str, mesh, mesh_name: str, dims: dict, shape: str = SHAPE) -> dict:
    """Trace one variant's per-rank program on ``mesh`` and return its
    record (the reference's layout, plus the analytic fields)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.audit import op_trace as ot

    pr = per_rank_dims(variant, dims, mesh)
    rec = {"arch": f"solver-ridge-{variant}", "shape": shape, "mesh": mesh_name,
           "params": dims["d"] * dims["c"], "active_params": dims["d"] * dims["c"]}
    t0 = time.perf_counter()
    program = phase_program(variant, dims, mesh)
    with FakeTensorMode():
        dots, trace = dot_flops(lambda: ot.record(program))
    dots_by_dtype = dot_flops_by_dtype(trace)
    extra = analytic_flops(variant, dims, mesh)
    by_dtype = dict(dots_by_dtype)
    by_dtype["float32"] = by_dtype.get("float32", 0) + sum(extra.values())
    if variant == "gaussian":
        sk_flops, sk_bytes = gauss_sa_terms(1, pr["n_l"], pr["d_l"], dims["m"], shared=True,
                                            a_itemsize=2)
        kernel = "gaussian_sa (roofline.gauss_sa_terms; traced as the dense bf16 product)"
    else:
        sk_flops, sk_bytes = sjlt_terms(1, pr["n_l"], pr["d_l"], dims["m"], shared=True,
                                        index_itemsize=8)
        kernel = "sjlt (roofline.sjlt_terms; traced as the plain scatter-add)"
    rec.update(
        status="ok", step_kind="solver", trace_s=round(time.perf_counter() - t0, 3),
        flops=float(dots + sum(extra.values())), hlo_dot_flops=float(dots),
        dot_flops_by_dtype=dots_by_dtype,
        flops_by_dtype={k: float(v) for k, v in by_dtype.items()},
        analytic_flops=extra,
        sketch={"kernel": kernel, "analytic": True, "flops": sk_flops, "bytes": sk_bytes},
        bytes_accessed=float(sum(
            s.in_bytes() + sum(math.prod(sh) * dt.itemsize
                               for sh, dt in zip(s.out_shapes, s.out_dtypes))
            for s in trace.sites if s.base not in _VIEWS)),
        collectives=collective_bytes_by_op(trace), n_devices=mesh.size(),
        per_rank=pr, memory={"allocated": 0})
    return rec


def run(variant: str, mesh_name: str, out_dir: Path | None = Path("results/dryrun_torch"),
        *, dims: dict | None = None, mesh_shape=None, shape: str = SHAPE) -> dict:
    """One variant on one of ``MESHES`` (or ``mesh_shape`` with its names),
    over a fake group; writes the record under ``out_dir`` unless None."""
    from repro_torch.launch.mesh import fake_mesh

    shape_, names = MESHES[mesh_name]
    dims = dict(SOLVER_SHAPES[shape] if dims is None else dims)
    try:
        with fake_mesh(tuple(mesh_shape or shape_), names) as mesh:
            rec = trace_record(variant, mesh, mesh_name, dims, shape)
    except Exception as e:  # noqa: BLE001  a variant that fails is recorded, not fatal
        rec = {"arch": f"solver-ridge-{variant}", "shape": shape, "mesh": mesh_name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    if out_dir is not None:
        out = Path(out_dir) / mesh_name / f"solver__ridge-{variant}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="all", choices=("all",) + VARIANTS)
    ap.add_argument("--mesh", default="both", choices=("single", "multi", "both"))
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    from repro_torch.analysis.roofline import analyze_record

    variants = VARIANTS if args.variant == "all" else (args.variant,)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    bad = 0
    for mesh_name in meshes:
        for variant in variants:
            rec = run(variant, mesh_name, Path(args.out))
            if rec["status"] != "ok":
                bad += 1
                print(f"[error] {mesh_name}/solver-{variant}: {rec['error'][:200]}")
                continue
            r = analyze_record(rec)
            print(f"[ok   ] {mesh_name}/solver-{variant}: dot FLOPs/rank "
                  f"{rec['hlo_dot_flops']:.4g}, collectives "
                  f"{rec['collectives']['total_bytes'] / 2 ** 30:.3f} GiB/rank; H100 "
                  f"data-sheet terms compute {r.compute_s:.4g} s, memory {r.memory_s:.4g} s, "
                  f"collective {r.collective_s:.4g} s ({r.bottleneck}); traced in "
                  f"{rec['trace_s']} s", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
