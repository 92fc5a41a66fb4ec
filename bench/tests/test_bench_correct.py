"""How ``correct`` is decided, at a size the CPU holds: the program passes;
the control (the reference in TF32, put in the program's place) fails; and
a run whose timed path is broken underneath fails, once for each fault the
cells can have. These drive ``harness.run_cell``, which is the whole of a
run but the look for a card."""

import pytest
import torch

from bench import faults, harness
from conftest import small_cell

CELLS = ["ridge_service_b64.wide4k", "ridge_service_b64.wide4k_poisson180"]


@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes(name):
    result, err = harness.run_cell(small_cell(name), 2 ** 31 + 17, 0.5, False, device="cpu")
    assert result["correct"], err
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    checks = result["checks"]
    assert err[-len(checks):] == [f"check {k}: {v['value']} (limit {v['limit']})"
                                  for k, v in checks.items()]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name, seed):
    result, _ = harness.run_cell(small_cell(name), seed, 0.2, False, device="cpu", control=True)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for k, c in result["checks"].items()
               if k.startswith(("err.", "bwd.")))


FAULTS = [("ridge_service_b64.wide4k", "step_unchanged"),
          ("ridge_service_b64.wide4k", "answer_altered"),
          ("ridge_service_b64.wide4k", "half_dropped"),
          ("ridge_service_b64.wide4k", "small_nu_altered"),
          ("ridge_service_b64.wide4k_poisson180", "small_nu_altered"),
          ("ridge_service_b64.wide4k_poisson180", "step_unchanged"),
          ("ridge_service_b64.wide4k_poisson180", "answer_altered")]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n.split('.')[-1]}-{f}" for n, f in FAULTS])
def test_a_broken_timed_path_fails(monkeypatch, name, fault):
    cell = small_cell(name)
    faults.FAULTS[fault](monkeypatch, cell.entry)
    result, err = harness.run_cell(cell, 5, 0.3, False, device="cpu")
    assert not result["correct"], err


def test_the_small_nu_fault_fails_its_stratum_alone(monkeypatch):
    """×1.01 on the answers of ν < 2.15e-3 only, the most ill-conditioned:
    the backward error of the lowest stratum fails, every other number
    reads as the sound program's."""
    cell = small_cell("ridge_service_b64.wide4k")
    faults.small_nu_altered(monkeypatch, cell.entry)
    result, err = harness.run_cell(cell, 5, 0.3, False, device="cpu")
    checks = dict(result["checks"])
    low = checks.pop("bwd.nu0.001")
    assert low["value"] > 5 * low["limit"], err
    assert all(c["value"] <= c["limit"] for c in checks.values()), err


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(cuda_device, name):
    """The command on the card, at the cell's own size, for a short window."""
    import json
    import subprocess
    import sys

    from conftest import ROOT

    out = subprocess.run([sys.executable, "bench/run.py", "--workload", name, "--seed",
                          str(2 ** 31 + 101), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert torch.cuda.device_count() >= result["device"]["count"]
