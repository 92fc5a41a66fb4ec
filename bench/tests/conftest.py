"""The benchmark's own tests (not the repository's tier-1 suite):

    python -m pytest -q bench/tests              # on the CPU
    python -m pytest -q -m cuda bench/tests      # on the card

They import the benchmark as the package ``bench`` and the program from
``src``, as ``bench/run.py`` does."""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda")


def small_cell(name: str):
    """The cell ``name`` of BENCHMARK.json at a size the CPU runs in about
    a second, with its limits as they stand. The service's traffic keeps the
    cell's ill-conditioning (σ_min² well under ν²) at d ≤ 32, so that the
    adaptive ladder climbs as it does at the cell's size."""
    from bench import manifest

    cell = manifest.cell(name)
    cfg, mix = dict(cell.config), dict(cell.traffic)
    cfg["trace_seconds"] = 0.3
    cfg["service"] = {**cfg["service"], "batch_size": 4, "shape_classes": [[256, 32, 64]]}
    mix.update(requests_per_flush=4, pool=8, n=[129, 256], d=[17, 32], decay=0.8)
    if "rate" in mix:
        mix["rate"] = 20.0        # well under what the CPU answers at this size
    return dataclasses.replace(cell, config=cfg, traffic=mix)
