"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the harness finds the
configuration at the ``file`` its entry gives, the mix at
``bench/traffic/<traffic>.json``, the mix's generator at
``bench/generators/<generator>.py``, the driver of the timed window at
``bench/entries/<entry>.py`` (the configuration's ``entry``), the
comparison that decides ``correct`` at ``bench/checks/<module>.py`` (the
configuration's ``check.module``) and each metric's reader at
``bench/metrics/<metric>.py``. So a later change adds a cell, a
configuration, a mix, a kind of traffic or answer, or a metric by adding
files and entries, and edits none that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration file's content
    traffic_name: str
    traffic: dict         # the traffic mix's content
    end_to_end: tuple     # the manifest's metric entries this cell reports
    per_layer: tuple
    root: Path = ROOT     # the checkout whose files it names

    @property
    def entry(self) -> str:
        return self.config["entry"]


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; known: {[e['name'] for e in entries]}")


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric with ``workloads`` applies to the cells it lists; an
    end-to-end one without, to every cell; a per-layer one without, to every
    cell that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest under ``root``, with its files read."""
    root = Path(root)
    m = load(root)
    w = _by_name(m["workloads"], name, "workload")
    c = _by_name(m["configs"], w["config"], "configuration")
    with open(root / c["file"]) as f:
        config = json.load(f)
    with open(root / "bench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = tuple(x for x in m["end_to_end"] if _applies(x, name, set()))
    names = {x["name"] for x in e2e}
    per = tuple(x for x in m["per_layer"] if _applies(x, name, names))
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, end_to_end=e2e, per_layer=per,
                root=root)


def entry(name: str, root: Path = ROOT):
    """The module that drives the timed window of a configuration's entry
    point: ``bench/entries/<name>.py``."""
    return _module(Path(root) / "bench" / "entries" / f"{name}.py", f"bench_entry_{name}")


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``bench/metrics/<metric>.py``."""
    path = Path(root) / "bench" / "metrics" / f"{metric}.py"
    return _module(path, "bench_metric_" + metric.replace(".", "_").replace("-", "_")).read


def _module(path: Path, modname: str):
    """The module of the file ``path``, loaded once under ``modname``."""
    mod = sys.modules.get(modname)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod          # a dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


def generator(name: str, root: Path = ROOT):
    """The ``generate(spec, seed, device)`` function of
    ``bench/generators/<name>.py``, the generator a traffic mix names."""
    return _module(Path(root) / "bench" / "generators" / f"{name}.py", f"bench_gen_{name}").generate


def checker(name: str, root: Path = ROOT):
    """The comparison ``bench/checks/<name>.py`` (``bench.check``)."""
    return _module(Path(root) / "bench" / "checks" / f"{name}.py", f"bench_check_{name}")
