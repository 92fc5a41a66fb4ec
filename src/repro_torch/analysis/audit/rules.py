"""The declarative invariant rules, over op traces.

Port of ``repro.analysis.audit.rules``: the same three rules with the same
allowances, read over an ``op_trace.OpTrace`` where the reference reads a
jaxpr ("equation" is an op site, "intermediate" a new tensor). Every rule
sees one traced entry point (an ``EntryPoint`` and its trace) and returns
the violations it finds; the runner applies every applicable rule to every
entry point, so a new family, method or shape class is audited the moment
the registry has it.

The allowances are the documented exceptions, word for word the
reference's:

* ``gaussian_dense`` is the materialized-S memory baseline: (B, m_max, n)
  is its entire point.
* ``sjlt``'s plain version materializes the sign-scaled stream copy of A
  before its one segment sum (the kernel fuses it); the copy is A-sized,
  not sketch-sized, so the O(B·m_max·n) claim is untouched.
* ``srht`` peaks at the (B, n_pad, d) FWHT stack: the transform runs in
  the padded index space by construction.
* ``int8`` mode quantizes A per row first; the |A| pass that computes the
  dequantization scales is fp32 and A-shaped.
* n within one stream chunk: the chunk slice of A is full-A-shaped there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import op_trace as ot


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    entry_point: str
    message: str
    provenance: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    description: str
    applies: Callable[[object], bool]
    check: Callable[[object, ot.OpTrace], list[Violation]]


@dataclasses.dataclass(frozen=True)
class RuleResult:
    rule: str
    entry_point: str
    passed: bool
    violations: tuple[Violation, ...] = ()

    def as_dict(self) -> dict:
        return {"rule": self.rule, "entry_point": self.entry_point,
                "passed": self.passed,
                "violations": [v.as_dict() for v in self.violations]}


def _v(rule: str, ep, msg: str, site: ot.OpSite | None = None) -> Violation:
    return Violation(rule=rule, entry_point=ep.name, message=msg,
                     provenance=site.provenance if site is not None else "")


# ---------------------------------------------------------------------------
# Rule 1: one-touch — no sketch-sized or A-copy tensor outside the family's
# documented allowance; the streamed pass stays under its budget.
# ---------------------------------------------------------------------------

def _one_touch_applies(ep) -> bool:
    m = ep.meta
    return bool(m.get("family")) and all(k in m for k in ("B", "n", "d", "m_max"))


def stream_chunk(n: int) -> int:
    """The Gaussian streamed pass's n-chunk: 256-column micro-tiles up to
    the 2048-column default (``kernels.gaussian_gram``)."""
    return min(-(-n // 256) * 256, 2048)


def gaussian_budget(B: int, n: int, d: int, m_max: int) -> int:
    """Rule (c)'s bytes: 2 × the documented live set of the streamed pass,
    the (B, m_max, 256) generated micro-tile, the (B, chunk, d) A chunk,
    the (L, B, d, d) Gram/inverse ladder and the (B, m_max, d) SA
    accumulator, at 4 bytes an entry."""
    from repro_torch.core.adaptive_padded import doubling_ladder

    L = len(doubling_ladder(m_max))
    return 2 * 4 * max(B * m_max * 256, B * stream_chunk(n) * d, L * B * d * d, B * m_max * d)


def _sjlt_segment_sums(trace: ot.OpTrace) -> int:
    """Segment sums over A: ``index_add_`` on the CPU, a launch of an SJLT
    leg on the card."""
    return (ot.count_op(trace, ("aten.index_add_", "aten.index_add"))
            + sum(v for k, v in trace.launches.items() if k.startswith("sjlt")))


def _one_touch_check(ep, trace: ot.OpTrace) -> list[Violation]:
    m = ep.meta
    fam, cd = m["family"], m.get("compute_dtype") or "fp32"
    B, n, d, m_max = m["B"], m["n"], m["d"], m["m_max"]
    n_pad = 1 << max(0, (n - 1).bit_length())
    chunk = stream_chunk(n)
    out: list[Violation] = []

    # (a) the dense sketch (B, m_max, n) exists only in the materialized
    # baseline; vacuous when n fits one stream chunk
    if fam != "gaussian_dense" and n > chunk:
        for s in ot.find_new_tensors(trace, lambda shp, dt: shp == (B, m_max, n))[:3]:
            out.append(_v("one_touch", ep,
                          f"dense sketch materialized: (B={B}, m_max={m_max}, n={n}) "
                          f"new tensor in the {fam} family", s))

    # (b) no fp32 copy of A: a new fp32 (B, n, d) tensor is a second touch
    # of the data. Allowed: sjlt's plain sign-scaled stream copy; srht when
    # n is already a power of two; int8's scale pass; n inside one chunk
    banned_a_copy = (fam in ("gaussian", "gaussian_dense", "srht")
                     and cd in ("fp32", "bf16") and n > chunk
                     and not (fam == "srht" and n_pad == n))
    if banned_a_copy:
        for s in ot.find_new_tensors(
                trace, lambda shp, dt: shp == (B, n, d) and dt == torch.float32)[:3]:
            out.append(_v("one_touch", ep,
                          f"fp32 (B, n, d) copy of A made in the {fam}/{cd} pass", s))

    # (c) the Gaussian pass's largest new tensor within 2 × its live set,
    # which is ≥ 4× below the dense sketch whenever the shapes tell them apart
    if fam == "gaussian":
        budget = gaussian_budget(B, n, d, m_max)
        peak, shape, site = ot.max_new_tensor_bytes(trace)
        if peak > budget:
            out.append(_v("one_touch", ep,
                          f"streamed gaussian: new tensor of {peak} B @ {shape} exceeds "
                          f"the live-set budget {budget} B (dense S would be "
                          f"{4 * B * m_max * n} B)", site))

    # (d) the SJLT pass is one segment sum, its cap level included; the path
    # runs inherit it, the whole λ grid riding that one pass
    if fam == "sjlt" and ep.kind in ("provider", "path"):
        sums = _sjlt_segment_sums(trace)
        if sums != 1:
            first = next(iter(ot.collect_sites(trace, ("aten.index_add_", "aten.index_add"))),
                         None)
            out.append(_v("one_touch", ep,
                          f"SJLT ran {sums} segment sums over A (expected exactly 1, "
                          f"cap level included)", first))

    # (e) λ-grid self-calibration: the P-point run consumes A exactly as
    # often as its one-point run; no absolute count is asserted
    ref = m.get("a_ref_build")
    if ref is not None:
        got, want = ot.count_a_consumers(trace), ot.count_a_consumers(ref(trace.device))
        if got != want:
            first = next((s for s in trace.sites if s.reads_a), None)
            out.append(_v("one_touch", ep,
                          f"{m.get('grid_points')}-point λ grid consumes A {got} times vs "
                          f"{want} in the one-point run: per-λ work re-touches A instead "
                          f"of riding the shared λ-free ladder", first))
    return out


# ---------------------------------------------------------------------------
# Rule 2: collective inventory — a sharded pass combines in exactly its
# documented all-reduces; no collective inside a loop trip; none at all in
# an unsharded run.
# ---------------------------------------------------------------------------

def _collectives_check(ep, trace: ot.OpTrace) -> list[Violation]:
    out: list[Violation] = []
    sites = [s for s in trace.sites if s.is_collective]
    for s in sites:
        if s.in_trip:
            out.append(_v("collective_inventory", ep,
                          f"collective `{s.op}` inside a loop trip of the adaptive engine", s))
    if ep.kind == "sharded":
        budget = ep.meta.get("psum_budget", 1)
        reduces = [s for s in sites if s.base.startswith("c10d.allreduce")]
        if len(reduces) != budget:
            out.append(_v("collective_inventory", ep,
                          f"sharded pass ran {len(reduces)} all-reduces (budget: exactly "
                          f"{budget})", reduces[budget] if len(reduces) > budget else None))
        want = ep.meta.get("psum_shapes")
        got = [s.in_shapes[0] if s.in_shapes else () for s in reduces]
        if want is not None and len(got) == len(want) and got != [tuple(w) for w in want]:
            out.append(_v("collective_inventory", ep,
                          f"all-reduce payloads {got} != documented {list(want)}",
                          reduces[0]))
    else:
        for s in sites[:3]:
            out.append(_v("collective_inventory", ep,
                          f"unexpected collective `{s.op}` in an unsharded run", s))
    return out


# ---------------------------------------------------------------------------
# Rule 3: precision boundary — reduced-precision values are widened before
# any contraction; factorizations and the loop carry are fp32; fp32 mode
# makes no reduced-precision tensor.
# ---------------------------------------------------------------------------

_WIDE = (torch.float32, torch.float64)


def _precision_check(ep, trace: ot.OpTrace) -> list[Violation]:
    out: list[Violation] = []
    cd = ep.meta.get("compute_dtype") or "fp32"

    # (a) factorizations and triangular solves never see reduced precision
    for s in trace.sites:
        if s.base in ot.FACTORIZATION_OPS:
            bad = sorted({str(t) for t in s.in_dtypes if t.is_floating_point and t not in _WIDE})
            if bad:
                out.append(_v("precision_boundary", ep,
                              f"{s.op} operates on {bad} (factorizations must be fp32)", s))

    # (b) the loop carry (iterates, residuals, δ̃ anchors: what the
    # certificates come from) holds no reduced float, after prepare and
    # after every segment
    for label, fields, where in trace.carries:
        bad = {k: str(t) for k, t in fields.items() if t.is_floating_point and t not in _WIDE}
        if bad:
            out.append(Violation("precision_boundary", ep.name,
                                 f"PaddedState ({label}) carries {bad}", where))

    # (c) reduced values are widened before any contraction: torch's bf16
    # mm returns bf16, so a contraction with a reduced operand is the fault
    for s in trace.sites:
        if s.base not in ot.CONTRACTION_OPS:
            continue
        if set(s.in_dtypes) & set(ot.REDUCED_FLOAT):
            out.append(_v("precision_boundary", ep,
                          f"{s.op} contracts {sorted(str(t) for t in set(s.in_dtypes))} "
                          f"operands into {[str(t) for t in s.out_dtypes]}, not widened "
                          f"to fp32 first", s))
        elif torch.int8 in s.in_dtypes and not set(s.out_dtypes) <= {*_WIDE, torch.int32}:
            out.append(_v("precision_boundary", ep,
                          f"int8 {s.op} accumulates into {[str(t) for t in s.out_dtypes]}",
                          s))

    # (d) fp32 mode is the pre-axis computation: no reduced float anywhere
    if cd == "fp32":
        for s in ot.find_new_tensors(trace, lambda shp, dt: dt in ot.REDUCED_FLOAT)[:3]:
            out.append(_v("precision_boundary", ep,
                          f"reduced-precision tensor in fp32 mode ({s.op})", s))
    return out


def check_fp32_identity(family: str, device) -> list[Violation]:
    """``compute_dtype="fp32"`` must run the op sequence of the pre-axis
    default (``compute_dtype=None``), names, shapes and dtypes: the fp32
    mode is a no-op, not a third numerical regime."""
    from .entrypoints import provider_trace

    if (ot.op_sequence(provider_trace(family, "fp32", False, device))
            != ot.op_sequence(provider_trace(family, None, False, device))):
        return [Violation(
            "precision_boundary", f"provider:{family}:fp32:identity",
            f"compute_dtype='fp32' runs another op sequence than the pre-axis default "
            f"for the {family} family")]
    return []


RULES: tuple[Rule, ...] = (
    Rule("one_touch",
         "A is consumed by exactly one streaming pass; no sketch-sized or A-copy "
         "tensor outside the family's documented allowance",
         _one_touch_applies, _one_touch_check),
    Rule("collective_inventory",
         "a sharded pass combines in exactly its documented all-reduces; the "
         "adaptive loop's trips are collective-free",
         lambda ep: True, _collectives_check),
    Rule("precision_boundary",
         "reduced-precision streams are widened before any contraction; Grams, "
         "Cholesky, δ̃ and certificates are fp32",
         lambda ep: True, _precision_check),
)
