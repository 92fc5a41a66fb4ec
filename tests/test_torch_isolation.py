"""The port stands alone: no module of ``repro_torch`` nor ``chip_smoke.py``
imports JAX, the JAX package or ``ml_dtypes`` (the card's machine has none),
and the default device is CUDA, never a
silent fall back to the CPU."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_modules_import_without_jax_loaded():
    """Importing every port module pulls in no JAX (checked in a fresh
    interpreter, since this test process has JAX loaded for the parity
    tests)."""
    import subprocess
    import sys

    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in PORT_FILES if p.name != "chip_smoke.py"]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "assert not {'jax', 'repro', 'ml_dtypes'} & set(sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_default_device_refuses_without_cuda():
    """With no CUDA device, the default-device entry points raise instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from repro_torch import bridge, resolve_device
    from repro_torch.core.adaptive_padded import padded_adaptive_solve_batched
    from repro_torch.serve.solver_service import SolverService

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolverService()
    q = bridge.quadratic_from_numpy(
        [[[1.0]]], [[1.0]], [1.0], [[1.0]], device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        padded_adaptive_solve_batched(q, 0, m_max=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.quadratic_from_numpy([[[1.0]]], [[1.0]], [1.0], [[1.0]])


def test_tensors_off_the_entry_points_device_raise():
    """Tensors on another device than the entry point's raise; nothing is
    copied behind the caller's back."""
    from repro_torch.device import require_on

    with pytest.raises(ValueError, match="expected cuda"):
        require_on(torch.device("cuda"), A=torch.zeros(2))
    require_on(torch.device("cpu"), A=torch.zeros(2), b=None)


def test_paper_literal_and_sharded_entry_points_default_to_cuda():
    """The paper-literal solver, its sketches and spectrum take the card
    unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from repro_torch.core import exp_decay_singular_values, make_sketch

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sketch("sjlt", 4, 16, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_decay_singular_values(8)
    from repro_torch.core import AdaptiveConfig, adaptive_solve
    from repro_torch.core.quadratic import from_least_squares

    q = from_least_squares(torch.eye(4), torch.ones(4), 0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        adaptive_solve(q, AdaptiveConfig())
    assert make_sketch("sjlt", 4, 16, 0, device="cpu").data["rows"].device.type == "cpu"
    # the rank launcher and the mesh builders: cuda unless asked for the CPU
    # (all three raise before they start a process or touch a group)
    from repro_torch.launch.mesh import make_elastic_mesh, make_host_mesh, run_ranks

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks("repro_torch.launch.sharded:run_tasks", 1, {"tasks": []})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_elastic_mesh(1)


def test_spawned_ranks_import_no_jax():
    """A rank of ``launch.mesh.run_ranks`` imports its job's module and the
    port only, even when the launching process has JAX loaded."""
    from repro_torch.kernels.ops import BODY_LAUNCHES
    from repro_torch.launch.mesh import run_ranks

    out = run_ranks("repro_torch.launch.sharded:run_tasks", 1,
                    {"tasks": [("imports", "imports", {})]}, device="cpu", timeout=300)
    assert out == [{"rank": 0, "imports": [],
                    "launches": {"imports": dict.fromkeys(BODY_LAUNCHES, 0)}}]


def test_sharded_lm_ranks_import_no_jax():
    """The rank programs of sharded LM training and decode
    (``launch.sharded_lm``, and ``launch.train``'s ``--mesh`` ranks) load no
    JAX and nothing of the reference after a train step and a decode."""
    from repro_torch.launch.mesh import run_ranks

    batch = {"tokens": [[1, 2, 3, 4]] * 2, "labels": [[2, 3, 4, 5]] * 2, "mask": [[1.0] * 4] * 2}
    out = run_ranks("repro_torch.launch.sharded_lm:run_tasks", 1, {"tasks": [
        ("train", "train", dict(arch="qwen2-0.5b", seed=0, max_seq=8, model=1, fsdp=False,
                                nmb=1, opt={}, batch=batch, steps=1,
                                tensors=False)),
        ("decode", "decode", dict(arch="qwen2-0.5b", seed=0, max_seq=8, model=1,
                                  prompt=[[1, 2, 3]], new=2, greedy=False)),
        ("imports", "imports", {})]}, device="cpu", timeout=300)
    assert out[0]["imports"] == []
