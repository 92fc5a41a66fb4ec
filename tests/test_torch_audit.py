"""The port's invariant audit (``repro_torch.analysis.audit``) on the CPU.

The quick registry runs through the command line (``--device cpu --quick
--json``) once per module: it must exit 0, every rule must pass on every
entry point, with each rule passing on an entry point of every kind (the
sharded ones in a gloo rank of ``launch.mesh.run_ranks(device="cpu")``),
and every negative control must fail under its own rule with a provenance
in ``src/repro_torch``. The registry's names equal the reference's, full
(55) and quick (22); the reference's rules are not called (its jaxpr
walker fails on this JAX)."""

import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.audit import fixtures, runner  # noqa: E402
from repro_torch.analysis.audit.ast_rules import lint_module_source, lint_tree  # noqa: E402
from repro_torch.analysis.audit.entrypoints import build_targets, port_targets  # noqa: E402
from repro_torch.analysis.audit.rules import check_fp32_identity  # noqa: E402

KINDS = ("provider", "engine", "segment", "path", "sharded", "newton", "service")
RULES = ("one_touch", "collective_inventory", "precision_boundary")
FIXTURES = [ep.name for ep in fixtures.fixture_targets()] + [
    *fixtures.LINT_FIXTURES, "fixture:per_call_load"]


@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    path = tmp_path_factory.mktemp("audit") / "audit.json"
    rc = runner.main(["--device", "cpu", "--quick", "--json", str(path)])
    return rc, json.loads(path.read_text())


def test_quick_audit_passes_on_cpu(quick):
    rc, report = quick
    bad = [r for r in report["results"] if not r["passed"]]
    assert rc == 0 and report["passed"] and not bad, bad
    assert report["summary"]["device"] == "cpu"
    assert len({r["entry_point"] for r in report["results"]
                if r["rule"] == "collective_inventory"}) == 22 + len(port_targets())


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("kind", KINDS)
def test_each_rule_passes_on_every_kind(quick, rule, kind):
    _, report = quick
    kinds = {ep.name: ep.kind for ep in build_targets(quick=True)}
    mine = [r for r in report["results"]
            if r["rule"] == rule and kinds.get(r["entry_point"]) == kind]
    assert mine and all(r["passed"] for r in mine), (rule, kind, mine)


@pytest.mark.parametrize("name", FIXTURES)
def test_every_fixture_fails_under_its_rule(quick, name):
    _, report = quick
    (got,) = [f for f in report["fixtures"] if f["fixture"] == name]
    assert got["fired"], got
    assert all(v["rule"] == got["rule"] for v in got["violations"])
    assert any(v["provenance"].startswith("src/repro_torch/") for v in got["violations"])


def test_loop_allreduce_fires_only_inside_the_trip(quick):
    """The loop control's budget equals its count and its payloads are the
    documented ones, so only the in-trip clause can fire."""
    _, report = quick
    (got,) = [f for f in report["fixtures"] if f["fixture"] == "fixture:loop_allreduce"]
    assert got["violations"] and all("inside a loop trip" in v["message"]
                                     for v in got["violations"]), got


@pytest.mark.parametrize("name", [ep.name for ep in port_targets()])
@pytest.mark.parametrize("rule", RULES)
def test_mesh_ft_entry_points_pass(quick, name, rule):
    """The sharded segmented driver under a deadline, and with a checkpoint
    and a preemption flag: every rule passes, and the collective inventory
    holds exactly its precompute's all-reduces, with a checkpoint the lead
    rank's (1,) latest step, and one (2,) verdict a segment boundary, as
    declared."""
    _, report = quick
    (got,) = [r for r in report["results"] if r["rule"] == rule and r["entry_point"] == name]
    assert got["passed"], got
    (ep,) = [ep for ep in port_targets() if ep.name == name]
    want = [(2,), (2,)] if ":deadline:" in name else [(1,), (2,), (2,)]
    assert ep.meta["psum_shapes"][2:] == want and ep.meta["psum_budget"] == 2 + len(want)


def test_existing_sharded_budgets_are_unchanged():
    """The reference's sharded entry points keep their budgets and payloads:
    the verdicts add collectives only where a deadline or a flag is set."""
    budgets = {ep.name: (ep.meta["psum_budget"], ep.meta["psum_shapes"])
               for ep in build_targets() if ep.kind == "sharded"}
    L, B, D = 8, 3, 16
    assert budgets == {
        "sharded:gaussian:fp32": (1, [(L, B, D, D)]),
        "sharded:gaussian_dense:fp32": (1, [(L, B, D, D)]),
        "sharded:sjlt:fp32": (1, [(L, B, D, D)]),
        "sharded:srht:fp32": (1, [(L, B, D, D)]),
        "path:sharded:gaussian:fp32": (2, [(L, B, D, D), (B, D, D)]),
        "sharded:weighted_gram": (1, [(B, D, D)]),
    }


def test_verdict_in_trip_fires_only_inside_the_trip(quick):
    """The verdict control's budget equals its count and its payloads are
    the verdict's, so only the in-trip clause can fire."""
    _, report = quick
    (got,) = [f for f in report["fixtures"] if f["fixture"] == "fixture:verdict_in_trip"]
    assert got["violations"] and all("inside a loop trip" in v["message"]
                                     for v in got["violations"]), got


@pytest.mark.parametrize("quick_", [False, True], ids=["full", "quick"])
def test_registry_names_equal_the_reference(quick_):
    from repro.analysis.audit.entrypoints import build_targets as ref_targets

    want = [ep.name for ep in ref_targets(quick=quick_)]
    got = [ep.name for ep in build_targets(quick=quick_)]
    assert got == want and len(got) == (22 if quick_ else 55)
    kinds = {ep.name: ep.kind for ep in ref_targets(quick=quick_)}
    assert {ep.name: ep.kind for ep in build_targets(quick=quick_)} == kinds


def test_lint_tree_is_clean():
    assert lint_tree() == []


def test_lint_names_the_lattice_when_it_is_named():
    """The status lint's positive control: a compare against the lattice."""
    assert lint_module_source(fixtures.CLEAN_STATUS_SRC, "clean") == []


@pytest.mark.parametrize("family", ["gaussian", "gaussian_dense", "sjlt", "srht"])
def test_fp32_identity(family):
    assert check_fp32_identity(family, "cpu") == []


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_audit(quick=True)
