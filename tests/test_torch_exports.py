"""Every name the reference's package ``__init__`` exports resolves in the
port's package of the same name, as the port's own object of the
submodule the reference names (``repro.core``, ``repro.serve``,
``repro.dist``; and ``repro.models``, whose functional ``forward``,
``encode`` and ``build_cross_cache`` are methods of the port's
``Transformer``). Read from the reference's source, so no JAX is needed."""

import ast
import importlib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REF = Path(__file__).resolve().parents[1] / "src" / "repro"
TRANSFORMER_METHODS = {"forward", "encode", "build_cross_cache"}


def _exports(pkg: str) -> list[tuple[str, str]]:
    """(submodule, name) of every ``from .sub import name`` of the
    reference's ``pkg/__init__.py``."""
    tree = ast.parse((REF / pkg / "__init__.py").read_text())
    return [(node.module, a.asname or a.name) for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.level == 1 for a in node.names]


CASES = [(pkg, sub, name) for pkg in ("core", "serve", "dist", "models")
         for sub, name in _exports(pkg)]


def test_the_reference_exports_what_the_issue_counts():
    counts = {pkg: len(_exports(pkg)) for pkg in ("core", "serve", "dist")}
    assert counts == {"core": 54, "serve": 8, "dist": 4}


@pytest.mark.parametrize("pkg,sub,name", CASES, ids=[f"{p}.{n}" for p, _, n in CASES])
def test_reference_name_resolves_in_the_port(pkg, sub, name):
    port = importlib.import_module(f"repro_torch.{pkg}")
    if pkg == "models" and name in TRANSFORMER_METHODS:
        assert callable(getattr(port.Transformer, name))
        return
    assert hasattr(port, name), f"repro_torch.{pkg} lacks {name}"
    owner = importlib.import_module(f"repro_torch.{pkg}.{sub}")
    assert getattr(port, name) is getattr(owner, name)


@pytest.mark.parametrize("pkg", ["core", "serve", "dist", "models"])
def test_package_imports_alone_in_a_fresh_interpreter(pkg):
    """No import cycle: each package imports first in its own process
    (``serve.solver_service`` imports ``core``)."""
    import subprocess
    import sys

    src = str(REF.parent)
    r = subprocess.run([sys.executable, "-c", f"import repro_torch.{pkg}"],
                       env={"PYTHONPATH": src, "PATH": ""}, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
