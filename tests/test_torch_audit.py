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
from repro_torch.analysis.audit.entrypoints import build_targets  # noqa: E402
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
                if r["rule"] == "collective_inventory"}) == 22


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
