"""Deliberately violating runs: every rule's and check's negative control.

Port of ``repro.analysis.audit.fixtures``. Each fixture breaks exactly the
invariant its name says: a dense sketch built at n = 4096, a weighted copy
of A, two all-reduces in one sharded pass, an all-reduce inside a loop
trip, a host verdict inside a loop trip, a bf16 ``mm`` left bf16, a bf16
loop carry, a bf16 factorization, a reused seed literal, a bare status
compare, a library opened per call, and on the card a segment that copies
the ladder. The auditor runs the real
rules on them and requires each to FAIL under its rule with a provenance
in ``src/repro_torch``: a rule that cannot catch its own seeded violation
is a rubber stamp, not a gate.

torch has no bf16 Cholesky on the CPU ("not implemented for 'BFloat16'")
or in cuSOLVER, so the factorization fixture cannot run one: it hands the
rule a hand-built site, a ``linalg_cholesky_ex`` whose recorded input is
bf16. That tests the rule's logic, not a run.

``ast_rules.lint_tree`` skips this module, because violating is its job.
"""

from __future__ import annotations

import ast
import ctypes.util
from pathlib import Path

import torch

from repro_torch.core import adaptive_padded as ap
from repro_torch.core.distributed import all_reduce_sum, host_verdict
from repro_torch.kernels import _build
from repro_torch.kernels.gaussian_gram import gaussian_s_dense

from . import op_trace as ot
from .entrypoints import VERDICT_SHAPE, EntryPoint, problem

# big enough that the chunk-aware one-touch allowances do not excuse the
# violation: n exceeds the 2048-column stream chunk
_B, _N, _D, _M = 2, 4096, 8, 64


def _meta(rule: str, **kw) -> dict:
    return {"family": "gaussian", "compute_dtype": "fp32", "B": _B, "n": _N, "d": _D,
            "m_max": _M, "expect": rule, **kw}


# ---------------------------------------------------------------------------
# one_touch
# ---------------------------------------------------------------------------

def dense_sketch_ep() -> EntryPoint:
    """A 'gaussian' pass that materializes the whole (B, m_max, n) sketch."""

    def build(dev):
        q, seeds = problem(dev, b=_B, n=_N, d=_D)

        def fn():
            S = gaussian_s_dense(seeds, _M, _N)
            SA = torch.bmm(S, q.A)
            return torch.bmm(SA.transpose(1, 2), SA)

        return ot.record(fn, watch=[q.A], device=dev)

    return EntryPoint("fixture:dense_sketch", "provider", build, _meta("one_touch"))


def a_copy_ep() -> EntryPoint:
    """A 'gaussian' pass that takes a second, full-size fp32 touch of A: the
    weighted copy every family promises to fuse."""

    def build(dev):
        q, _ = problem(dev, b=_B, n=_N, d=_D, weighted=True)

        def fn():
            Aw = q.A * q.row_weights[..., None]
            return torch.bmm(Aw.transpose(1, 2), Aw)

        return ot.record(fn, watch=[q.A], device=dev)

    return EntryPoint("fixture:a_copy", "provider", build, _meta("one_touch"))


# ---------------------------------------------------------------------------
# collective_inventory (run in a rank)
# ---------------------------------------------------------------------------

def double_allreduce_ep() -> EntryPoint:
    """A sharded pass that all-reduces its Gram twice ("for safety"): twice
    the documented collective bytes."""

    def rank_build(mesh, dev):
        q, _ = problem(dev, b=_B, n=_N, d=_D)

        def fn():
            G = all_reduce_sum(torch.bmm(q.A.transpose(1, 2), q.A), mesh)
            return all_reduce_sum(G, mesh)

        return ot.record(fn, watch=[q.A], device=dev)

    return EntryPoint("fixture:double_allreduce", "sharded", None,
                      _meta("collective_inventory", psum_budget=1,
                            psum_shapes=[(_B, _D, _D)]), rank_build=rank_build)


def loop_allreduce_ep() -> EntryPoint:
    """Engine trips whose H·v all-reduces: one collective per trip instead
    of one per pass."""

    def rank_build(mesh, dev):
        q, seeds = problem(dev, b=_B, n=256, d=_D)
        pre, st = ap.prepare_padded_solve(q, seeds, m_max=_M, device=dev)
        G = torch.bmm(q.A.transpose(1, 2), q.A)
        reg = (q.nu ** 2)[:, None] * q.lam_diag

        def leaky_hvp(v):
            return all_reduce_sum(torch.bmm(G, v[:, :, None])[:, :, 0], mesh) + reg * v

        def fn(st=st):
            for _ in range(3):
                st = ap._trip(q, pre, st, leaky_hvp, method="pcg", max_iters=100, rho=0.5,
                              tol=1e-10, guards=True, top=pre.pinvs.shape[0] - 1)
            return st

        return ot.record(fn, watch=[q.A], device=dev)

    return EntryPoint("fixture:loop_allreduce", "sharded", None,
                      _meta("collective_inventory", psum_budget=3,
                            psum_shapes=[(_B, _D)] * 3),
                      rank_build=rank_build)


def verdict_in_trip_ep() -> EntryPoint:
    """Engine trips whose H·v takes a host verdict: the segment-boundary
    decision of a sharded solve moved inside the loop."""

    def rank_build(mesh, dev):
        q, seeds = problem(dev, b=_B, n=256, d=_D)
        pre, st = ap.prepare_padded_solve(q, seeds, m_max=_M, device=dev)
        G = torch.bmm(q.A.transpose(1, 2), q.A)
        reg = (q.nu ** 2)[:, None] * q.lam_diag

        def deciding_hvp(v):
            host_verdict(mesh, stop=False, expired=False)
            return torch.bmm(G, v[:, :, None])[:, :, 0] + reg * v

        def fn(st=st):
            for _ in range(3):
                st = ap._trip(q, pre, st, deciding_hvp, method="pcg", max_iters=100,
                              rho=0.5, tol=1e-10, guards=True, top=pre.pinvs.shape[0] - 1)
            return st

        return ot.record(fn, watch=[q.A], device=dev)

    return EntryPoint("fixture:verdict_in_trip", "sharded", None,
                      _meta("collective_inventory", psum_budget=3,
                            psum_shapes=[VERDICT_SHAPE] * 3),
                      rank_build=rank_build)


# ---------------------------------------------------------------------------
# precision_boundary
# ---------------------------------------------------------------------------

def bf16_mm_ep() -> EntryPoint:
    """A bf16 pass that forgets to widen: its Gram contracts bf16 operands
    into a bf16 result."""

    def build(dev):
        q, _ = problem(dev, b=_B, n=_N, d=_D)

        def fn():
            Ah = q.A[0].to(torch.bfloat16)
            return torch.mm(Ah.T, Ah)

        return ot.record(fn, watch=[q.A], device=dev)

    return EntryPoint("fixture:bf16_mm", "provider", build,
                      _meta("precision_boundary", compute_dtype="bf16"))


def bf16_carry_ep() -> EntryPoint:
    """A segment whose loop state carries a bf16 δ̃ anchor."""

    def build(dev):
        q, seeds = problem(dev, b=_B, n=256, d=_D)
        pre, st = ap.prepare_padded_solve(q, seeds, m_max=_M, device=dev)
        st = st._replace(dtilde_I=st.dtilde_I.to(torch.bfloat16))
        return ot.record(lambda: ap._run_segment(q, pre, st, 2, method="pcg", max_iters=100,
                                                 rho=0.5, tol=1e-10, guards=True),
                         watch=[q.A], device=dev)

    return EntryPoint("fixture:bf16_carry", "engine", build,
                      _meta("precision_boundary", compute_dtype="bf16"))


def bf16_cholesky_ep() -> EntryPoint:
    """A bf16 factorization, as a hand-built site (no backend factors bf16)."""

    def build(dev):
        shape = (_B, _D, _D)
        site = ot.OpSite(
            op="aten.linalg_cholesky_ex.default", base="aten.linalg_cholesky_ex",
            in_shapes=(shape,), in_dtypes=(torch.bfloat16,),
            out_shapes=(shape, (_B,)), out_dtypes=(torch.bfloat16, torch.int32),
            new=(True, True), provenance=ot.provenance("aten.linalg_cholesky_ex.default"))
        return ot.OpTrace(sites=[site], launches={}, body_launches={},
                          device=str(torch.device(dev)))

    return EntryPoint("fixture:bf16_cholesky", "provider", build,
                      _meta("precision_boundary", compute_dtype="bf16"))


def fixture_targets() -> list[EntryPoint]:
    """The traced fixtures (run through the rules like entry points)."""
    return [dense_sketch_ep(), a_copy_ep(), double_allreduce_ep(), loop_allreduce_ep(),
            verdict_in_trip_ep(), bf16_mm_ep(), bf16_carry_ep(), bf16_cholesky_ep()]


# ---------------------------------------------------------------------------
# key_hygiene / status_lattice: violating SOURCE, as strings, so the tree
# lint over the real modules never sees them
# ---------------------------------------------------------------------------

REUSED_ROOT_SEED_SRC = """
import torch

def draw_a():
    return torch.Generator().manual_seed(42)

def draw_b():
    return torch.Generator().manual_seed(42)
"""

REUSED_FOLD_SEEDS_SRC = """
from repro_torch.core.level_grams import fold_seeds

def derive(seeds):
    sa = fold_seeds(seeds, 7)
    sb = fold_seeds(seeds, 7)
    return sa, sb
"""

BARE_STATUS_SRC = """
def converged(stats):
    return stats["status"] == 0
"""

CLEAN_STATUS_SRC = """
from repro_torch.core.status import SolveStatus

def converged(stats):
    return stats["status"] == SolveStatus.OK
"""

LINT_FIXTURES = {
    "fixture:reused_root_seed": ("REUSED_ROOT_SEED_SRC", "key_hygiene"),
    "fixture:reused_fold_seeds": ("REUSED_FOLD_SEEDS_SRC", "key_hygiene"),
    "fixture:bare_status": ("BARE_STATUS_SRC", "status_lattice"),
}


def lint_fixture(const: str, module_name: str = "fixture"):
    """Lint the source string ``const`` of this module, its findings placed
    at their lines in this file."""
    from .ast_rules import lint_module_source

    path = Path(__file__).resolve()
    tree = ast.parse(path.read_text())
    line = next(node.value.lineno for node in tree.body
                if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == const)
    return lint_module_source(globals()[const], module_name, str(ot.repo_relative(path)),
                              first_line=line)


# ---------------------------------------------------------------------------
# retrace_sentinel
# ---------------------------------------------------------------------------

def leaky_load_cycle(device, seed: int) -> None:
    """A call that opens a library every time it runs (the per-call load a
    cache keyed on a dynamic value gives)."""
    del device, seed
    _build.open_library(ctypes.util.find_library("c"))


def cloned_pinvs_segment(q, pre, st, trip_limit, **kw):
    """A segment that copies the whole (L, B, d, d) ladder of inverses."""
    return ap.padded_solve_segment(q, pre._replace(pinvs=pre.pinvs.clone()), st,
                                   trip_limit, **kw)
