"""The benchmark loads neither JAX nor the JAX package, reads nothing of
``benchmarks/``, and its reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

from conftest import ROOT

BENCH = ROOT / "bench"

RUN_EVERYTHING = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
sys.path.insert(0, {tests!r})
from bench import harness, manifest
from conftest import small_cell
for m in manifest.load()["end_to_end"] + manifest.load()["per_layer"]:
    manifest.reader(m["name"])
import bench.reference.ridge, bench.calibrate, bench.faults
for name in ("ridge_service_b64.wide4k", "ridge_service_b64.wide4k_poisson180"):
    harness.run_cell(small_cell(name), 3, 0.2, True, device="cpu")
print(json.dumps(harness.forbidden_modules()))
"""


def test_a_whole_run_loads_no_jax_nor_the_jax_package():
    code = RUN_EVERYTHING.format(root=str(ROOT), src=str(ROOT / "src"), tests=str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    from bench import harness

    monkeypatch.setitem(sys.modules, "repro_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro.core"]


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_reads_the_jax_packages_benchmarks():
    for path in BENCH.rglob("*.py"):
        if path.name == "test_bench_isolation.py":
            continue
        assert "benchmarks" not in path.read_text(), path
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert _imports(path) <= {"__future__", "torch", "numpy", "math"}, path
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]; import bench.reference.ridge; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]
