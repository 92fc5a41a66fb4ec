"""BENCHMARK.json against the benchmark's contract, and a later change that
adds a cell, a configuration, a mix with a generator of its own, a
comparison and a metric by adding files only."""

import hashlib
import json
import re
import shutil

import pytest

from bench import harness, manifest
from conftest import ROOT, small_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


def line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\t\n\r]", text)


def test_manifest_meets_the_contract():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    m = json.loads(raw)
    assert set(m) == {"command", "paths", "run_seconds", *KEYS}
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and ".." not in p.split("/") and (ROOT / p).is_dir()
    cmd = m["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) and not w.startswith("/") for w in cmd)
    for w in cmd:
        if (ROOT / w).exists():
            assert any(w == p or w.startswith(p + "/") for p in m["paths"]), w
    R = m["run_seconds"]
    assert isinstance(R, int) and 1 <= R <= 51
    assert (2 + 14 * 24) * (R + 60) + 24 * 2 * 90 + 1200 <= 43200
    for kind, (must, may) in KEYS.items():
        entries = m[kind]
        assert 1 <= len(entries) <= {"configs": 24, "workloads": 24, "end_to_end": 16,
                                     "per_layer": 128}[kind]
        names = [e["name"] for e in entries]
        assert len(set(names)) == len(names)
        for e in entries:
            assert must <= set(e) <= must | may, (kind, e["name"])
            assert NAME.match(e["name"]), e["name"]
    cells = {w["name"]: w for w in m["workloads"]}
    configs = {c["name"]: c for c in m["configs"]}
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
    for c in m["configs"]:
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / "bench" / "entries" / f"{cfg['entry']}.py").exists()
        assert (ROOT / "bench" / "checks" / f"{cfg['check']['module']}.py").exists()
        assert set(cfg["check"]["limits"]) >= {"missing_answers", "uncertified_share"}
        assert any(w["config"] == c["name"] for w in cells.values())
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in cells.values())
    assert four <= max(1, len(cells) // 4)
    for w in cells.values():
        assert w["chips"] in (1, 4) and line(w["why"]) and w["config"] in configs
        mix = ROOT / "bench" / "traffic" / f"{w['traffic']}.json"
        assert NAME.match(w["traffic"]) and mix.exists()
        gen = json.loads(mix.read_text())["generator"]
        assert (ROOT / "bench" / "generators" / f"{gen}.py").exists()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for x in e2e.values():
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert set(x.get("workloads", [])) <= set(cells)
        assert (ROOT / "bench" / "metrics" / f"{x['name']}.py").exists()
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"
    layers = {}
    for x in m["per_layer"]:
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(x["layer"]) and x["moves"] in e2e
        layers.setdefault(x["layer"].split(" (")[0], set()).add(x["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    for name in cells:
        cell = manifest.cell(name)
        got = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
        assert all(x["moves"] in got for x in cell.per_layer)


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_config_mix_check_and_metric_are_added_by_files_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    base = small_cell("ridge_service_b64.wide4k")

    # a generator and a comparison of their own, each a new file
    (tmp_path / "bench/generators/tiny_gen.py").write_text(
        "from pathlib import Path\nfrom bench import manifest\n"
        "def generate(spec, seed, device):\n"
        "    root = Path(__file__).resolve().parents[2]\n"
        "    return manifest.generator('ridge_pool', root)(spec, seed, device)\n")
    (tmp_path / "bench/checks/tiny_check.py").write_text(
        "from pathlib import Path\nfrom bench import manifest\n"
        "ridge = manifest.checker('ridge', Path(__file__).resolve().parents[2])\n"
        "compare, control = ridge.compare, ridge.control\n")
    config = {**base.config, "check": {**base.config["check"], "module": "tiny_check"}}
    (tmp_path / "bench/configs/tiny_service.json").write_text(json.dumps(config))
    (tmp_path / "bench/traffic/tiny_mix.json").write_text(
        json.dumps({**base.traffic, "generator": "tiny_gen"}))
    (tmp_path / "bench/metrics/service.requests_per_step.py").write_text(
        "def read(ctx):\n    return len(ctx.records['latencies_s']) / len(ctx.records['submit_s'])\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny_service", "source": "a test", "reduced": [], "why": "a test",
                         "file": "bench/configs/tiny_service.json"})
    m["workloads"].append({"name": "tiny_service.tiny_mix", "config": "tiny_service",
                           "traffic": "tiny_mix", "chips": 1, "why": "a test"})
    for x in m["end_to_end"]:
        if x["name"] == "solved_rps":
            x["workloads"].append("tiny_service.tiny_mix")
    m["per_layer"].append({"name": "service.requests_per_step", "unit": "req", "better": "higher",
                           "source": "program_counter", "layer": "service (serve/solver_service.py)",
                           "moves": "solved_rps", "workloads": ["tiny_service.tiny_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    after = _digests(tmp_path)
    changed = [p for p in before if before[p] != after[p]]
    assert changed == [tmp_path / "BENCHMARK.json"]     # every other file as it was

    cell = manifest.cell("tiny_service.tiny_mix", root=tmp_path)
    result, _ = harness.run_cell(cell, 7, 0.3, True, device="cpu")
    assert result["correct"]
    assert result["metrics"]["service.requests_per_step"]["value"] == pytest.approx(4.0)
    e2e, _ = harness.run_cell(cell, 7, 0.3, False, device="cpu")
    assert set(e2e["metrics"]) == {"solved_rps", "setup_s"}
