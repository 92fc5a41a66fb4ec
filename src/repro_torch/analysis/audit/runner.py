"""Run rules × entry points and every negative control; emit the report.

    PYTHONPATH=src python -m repro_torch.analysis.audit [--json F] [--quick]
        [--entry S] [--rule R] [--device cuda|cpu]

The device defaults to the card and raises without one (``device="cpu"``
only when asked for). The exit code is 0 only when every applicable rule
passes on every entry point and every fixture fails under its own rule
with a provenance in ``src/repro_torch``. The JSON has the reference's
matrix layout (rule → entry point → pass/fail and violations), plus the
fixtures, the kernel launches each entry point's run counted, and on the
card the segment state audit's bytes.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

from repro_torch.device import resolve_device

from . import fixtures
from .ast_rules import lint_tree
from .entrypoints import EntryPoint, build_targets, port_targets, trace_in_ranks
from .retrace import check_rebuild_sentinel, check_segment_state, run_behavioral_checks
from .rules import RULES, RuleResult, Violation, check_fp32_identity

PORT_PREFIX = "src/repro_torch/"


@dataclasses.dataclass(frozen=True)
class FixtureResult:
    name: str
    rule: str
    fired: bool                      # failed under its rule, with a port provenance
    violations: tuple[Violation, ...]

    def as_dict(self) -> dict:
        return {"fixture": self.name, "rule": self.rule, "fired": self.fired,
                "violations": [v.as_dict() for v in self.violations]}


@dataclasses.dataclass
class AuditReport:
    results: list[RuleResult]
    fixtures: list[FixtureResult]
    launches: dict[str, dict[str, int]]
    state_audit: dict
    elapsed_s: float
    quick: bool
    device: str

    @property
    def passed(self) -> bool:
        return all(r.passed for r in self.results) and all(f.fired for f in self.fixtures)

    @property
    def n_failed(self) -> int:
        return sum(not r.passed for r in self.results)

    def summary(self) -> dict:
        by_rule: dict[str, dict] = {}
        for r in self.results:
            cell = by_rule.setdefault(r.rule, {"checked": 0, "failed": 0})
            cell["checked"] += 1
            cell["failed"] += not r.passed
        return {"passed": self.passed, "checks": len(self.results), "failed": self.n_failed,
                "fixtures": len(self.fixtures),
                "fixtures_fired": sum(f.fired for f in self.fixtures),
                "quick": self.quick, "device": self.device, "by_rule": by_rule}

    def as_dict(self) -> dict:
        matrix: dict[str, dict] = {}
        for r in self.results:
            matrix.setdefault(r.rule, {})[r.entry_point] = {
                "passed": r.passed, "violations": [v.as_dict() for v in r.violations]}
        return {"passed": self.passed, "elapsed_s": round(self.elapsed_s, 1),
                "summary": self.summary(), "matrix": matrix,
                "results": [r.as_dict() for r in self.results],
                "fixtures": [f.as_dict() for f in self.fixtures],
                "launches": self.launches, "state_audit": self.state_audit}

    def human_report(self) -> str:
        lines = []
        by_rule: dict[str, list[RuleResult]] = {}
        for r in self.results:
            by_rule.setdefault(r.rule, []).append(r)
        for rule, rs in sorted(by_rule.items()):
            n_bad = sum(not r.passed for r in rs)
            lines.append(f"[{'FAIL' if n_bad else 'ok':4s}] {rule}: {len(rs) - n_bad}/{len(rs)} "
                         f"entry points clean")
            for r in rs:
                for v in r.violations:
                    where = f"  {v.provenance}" if v.provenance else ""
                    lines.append(f"       ✗ {r.entry_point}: {v.message}{where}")
        for f in self.fixtures:
            first = f.violations[0] if f.violations else None
            got = f"{first.message}  {first.provenance}" if first else "no violation"
            lines.append(f"[{'ok' if f.fired else 'FAIL':4s}] {f.name} fails {f.rule}: {got}")
        for name, legs in self.launches.items():
            lines.append(f"[launches] {name}: {legs}")
        if self.state_audit:
            lines.append(f"[state] {self.state_audit}")
        n_fired = sum(f.fired for f in self.fixtures)
        lines.append(f"audit: {'PASS' if self.passed else 'FAIL'} on {self.device} "
                     f"({len(self.results)} checks, {self.n_failed} failed; "
                     f"{n_fired}/{len(self.fixtures)} fixtures fire; {self.elapsed_s:.1f}s)")
        return "\n".join(lines)


def _fired(name: str, rule: str, vs: list[Violation]) -> FixtureResult:
    mine = tuple(v for v in vs if v.rule == rule)
    return FixtureResult(name, rule, any(v.provenance.startswith(PORT_PREFIX) for v in mine),
                         mine)


def _apply(ep: EntryPoint, trace, want) -> list[RuleResult]:
    out = []
    for rule in RULES:
        if not (want(rule.name) and rule.applies(ep)):
            continue
        try:
            vs = rule.check(ep, trace)
        except Exception as e:  # noqa: BLE001  a crashed rule is a failed rule
            vs = [Violation(rule.name, ep.name, f"rule crashed: {type(e).__name__}: {e}")]
        out.append(RuleResult(rule.name, ep.name, not vs, tuple(vs)))
    return out


def _traces(eps: list[EntryPoint], dev: torch.device) -> dict:
    """Each entry point's trace: sharded ones from one rank, the rest here."""
    traces = trace_in_ranks(eps, dev)
    for ep in eps:
        if ep.build is not None:
            traces[ep.name] = ep.build(dev)
    return traces


def _run_fixtures(dev: torch.device, want, traces: dict) -> list[FixtureResult]:
    """Every negative control, each of which must fail under its rule
    (``traces`` holds the traced fixtures' runs)."""
    out = []
    for ep in fixtures.fixture_targets():
        if not want(ep.meta["expect"]):
            continue
        vs = [v for r in _apply(ep, traces[ep.name], want) for v in r.violations]
        out.append(_fired(ep.name, ep.meta["expect"], vs))
    for name, (const, rule) in fixtures.LINT_FIXTURES.items():
        if want(rule):
            out.append(_fired(name, rule, fixtures.lint_fixture(const, name)))
    if want("retrace_sentinel"):
        out.append(_fired("fixture:per_call_load", "retrace_sentinel",
                          check_rebuild_sentinel(dev, fixtures.leaky_load_cycle,
                                                 name="fixture:per_call_load")))
        if dev.type == "cuda":
            vs, _ = check_segment_state(dev, fixtures.cloned_pinvs_segment,
                                        name="fixture:cloned_pinvs")
            out.append(_fired("fixture:cloned_pinvs", "retrace_sentinel", vs))
    return out


def run_audit(quick: bool = False, entry_filter: str = "", rule_filter: str = "",
              device=None) -> AuditReport:
    """The whole gate on ``device`` (default cuda, raising without a card)."""
    dev = resolve_device(device)
    t0 = time.time()

    def want(rule_name: str) -> bool:
        return not rule_filter or rule_filter in rule_name

    eps = [ep for ep in [*build_targets(quick=quick), *port_targets()]
           if not entry_filter or entry_filter in ep.name]
    eps = [ep for ep in eps if any(want(r.name) and r.applies(ep) for r in RULES)]
    fixture_eps = ([] if entry_filter else
                   [ep for ep in fixtures.fixture_targets() if want(ep.meta["expect"])])
    traces = _traces(eps + fixture_eps, dev)    # one rank process for every sharded run
    results: list[RuleResult] = []
    launches = {}
    for ep in eps:
        results += _apply(ep, traces[ep.name], want)
        legs = {k: v for k, v in traces[ep.name].launches.items() if v}
        if legs:
            launches[ep.name] = legs

    if want("precision_boundary") and not entry_filter:
        from repro_torch.core.level_grams import PADDED_SKETCHES

        for family in ("gaussian",) if quick else PADDED_SKETCHES:
            vs = check_fp32_identity(family, dev)
            results.append(RuleResult("precision_boundary", f"provider:{family}:fp32:identity",
                                      not vs, tuple(vs)))

    if not entry_filter:
        lint_vs = lint_tree()
        for rule_name in ("key_hygiene", "status_lattice"):
            if want(rule_name):
                mine = tuple(v for v in lint_vs if v.rule == rule_name)
                results.append(RuleResult(rule_name, "src/repro_torch", not mine, mine))

    state: dict = {}
    if not entry_filter and want("retrace_sentinel"):
        vs, state = run_behavioral_checks(dev)
        names = sorted({v.entry_point for v in vs}) or ["engine:lifecycle"]
        for name in names:
            mine = tuple(v for v in vs if v.entry_point == name)
            results.append(RuleResult("retrace_sentinel", name, not mine, mine))

    fixture_results = [] if entry_filter else _run_fixtures(dev, want, traces)
    return AuditReport(results=results, fixtures=fixture_results, launches=launches,
                       state_audit=state, elapsed_s=time.time() - t0, quick=quick,
                       device=str(dev))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.audit",
                                 description="audit the port's invariants on the card or "
                                             "the CPU")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the machine-readable report")
    ap.add_argument("--quick", action="store_true",
                    help="the quick subset (fp32 only, one service class)")
    ap.add_argument("--entry", default="", help="only entry points whose name contains this")
    ap.add_argument("--rule", default="", help="only rules whose name contains this")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the entry points run (default cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" or args.device is None:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False

    report = run_audit(quick=args.quick, entry_filter=args.entry, rule_filter=args.rule,
                       device=args.device)
    names = [ep.name for ep in [*build_targets(quick=args.quick), *port_targets()]]
    print(f"entry points ({len(names)}): {' '.join(names)}")
    print(report.human_report())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.as_dict(), f, indent=2)
        print(f"wrote {args.json}")
    return 0 if report.passed else 1


if __name__ == "__main__":
    sys.exit(main())
