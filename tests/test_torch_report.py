"""The dry-run report (``analysis.report``) against the reference's on the
CPU: on records in the reference's layout the port's §Dry-run table is the
reference's, character for character; on the port's own records (a model
cell and the solver's, reduced, over fake meshes) both sections render,
the table with ``trace`` times and the solver rows with real memory."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import report as jreport  # noqa: E402
from repro_torch.analysis import report as treport  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.launch import dryrun, dryrun_solver  # noqa: E402

torch.set_num_threads(1)


def _coll(nbytes, count):
    return {"total_bytes": nbytes, "by_op": {"all-reduce": {"bytes": nbytes, "count": count}}}


REFERENCE_RECORDS = {
    "single/qwen2-0.5b__train_4k.json": {
        "arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "single", "status": "ok",
        "params": 494032768, "active_params": 494032768, "step_kind": "train",
        "lower_s": 12.3, "compile_s": 45.6,
        "memory": {"argument_size_in_bytes": 23 * 2 ** 20, "output_size_in_bytes": 22 * 2 ** 20,
                   "temp_size_in_bytes": 7 * 2 ** 30, "generated_code_size_in_bytes": 1 << 20},
        "flops": 1.2e15, "hlo_dot_flops": 1.3e15, "bytes_accessed": 4.5e12,
        "collectives": _coll(3 * 2 ** 30, 242), "n_devices": 256},
    "single/qwen2-0.5b__long_500k.json": {
        "arch": "qwen2-0.5b", "shape": "long_500k", "mesh": "single", "status": "skipped",
        "reason": "full-attention KV at 500k is quadratic-prefill/unbounded-cache and more"},
    "multi/gemma2-27b__decode_32k.json": {
        "arch": "gemma2-27b", "shape": "decode_32k", "mesh": "multi", "status": "error",
        "error": "XlaRuntimeError: RESOURCE_EXHAUSTED: out of memory while compiling the "
                 "program, by a long way"},
    "multi/solver__ridge-flat.json": {
        "arch": "solver-ridge-flat", "shape": "probe_2m_8k", "mesh": "multi", "status": "ok",
        "step_kind": "solver", "compile_s": 3.0,
        "memory": {"argument_size_in_bytes": None, "temp_size_in_bytes": 12345},
        "flops": 1e12, "bytes_accessed": 1e11, "collectives": _coll(0, 0), "n_devices": 512},
}


def test_dryrun_table_equals_reference_on_reference_records(tmp_path):
    for name, rec in REFERENCE_RECORDS.items():
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_text(json.dumps(rec))
    want = jreport.dryrun_table(str(tmp_path))
    assert treport.dryrun_table(str(tmp_path)) == want
    assert want.count("\n") == 2 + len(REFERENCE_RECORDS)
    assert "compile 45.6s" in want and "| 7.00 |" in want


@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    """A reduced qwen2-0.5b train and decode cell (B = 8, S = 16, filed
    under the production shapes' names) on a fake 2×2 mesh filed as
    "single", and the six solver variants at a reduced shape on 4×4."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    full = get_config("qwen2-0.5b")
    reduced = {f.name: getattr(full.reduced(), f.name) for f in dataclasses.fields(full)}
    for name, step in (("train_4k", "train"), ("decode_32k", "decode")):
        rec = dryrun.run_cell("qwen2-0.5b", ShapeSpec(name, 16, 8, step), "single",
                              out, mesh_shape=(2, 2), cfg_overrides=reduced,
                              force_nmb=2)
        assert rec["status"] == "ok"
    dims = dict(n=1 << 12, d=64, c=16, m=128, pcg_iters=10)
    for v in dryrun_solver.VARIANTS:
        rec = dryrun_solver.run(v, "single", out, dims=dims, mesh_shape=(4, 4))
        assert rec["status"] == "ok"
    return out


def test_port_records_render_both_sections(port_records, capsys):
    table = treport.dryrun_table(port_records)
    rows = table.splitlines()[2:]
    assert len(rows) == 2 + len(dryrun_solver.VARIANTS)
    assert all("| ok |" in r and "| trace " in r and "compile" not in r for r in rows)
    for f in port_records.glob("single/*.json"):
        mem = json.loads(f.read_text())["memory"]
        assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0, f.name
        assert set(mem["memory_source"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                             "temp_size_in_bytes"}
    section = treport.roofline_section(port_records)
    n_rows = len(troof.load_all(port_records))
    assert n_rows == len(rows)
    assert section.count("\n* **") == n_rows
    assert "MXU" not in section and "qwen2-0.5b/train_4k" in section
    assert any(w in section for w in ("HBM3", "NVLink", "tensor cores"))
    assert treport.main(["--dir", str(port_records)]) == 0
    out = capsys.readouterr().out
    assert "## §Dry-run" in out and "## §Roofline" in out and "solver-ridge-2d" in out


def test_full_size_solver_records_have_real_memory(tmp_path):
    """The solver's pod-scale cells carry the model records' memory
    fields: its inputs and its peak above them, never 0.00 GiB."""
    rec = dryrun_solver.run("baseline", "single", tmp_path)
    mem = rec["memory"]
    n_l, d, c, m = (1 << 21) // 16, 8192, 1024, 16384
    assert mem["argument_size_in_bytes"] == 4 * n_l * d + 4 * d * c + 12 * n_l
    assert mem["temp_size_in_bytes"] >= 4 * m * d          # SA, at least
    assert "| 0.00 | 0.00 |" not in treport.dryrun_table(tmp_path)


@pytest.mark.parametrize("bottleneck", ["memory", "collective", "compute"])
@pytest.mark.parametrize("solver", [False, True])
def test_bottleneck_sentences_speak_of_the_h100(bottleneck, solver):
    s = treport._sentence(bottleneck, solver)
    assert "MXU" not in s and "TPU" not in s and "ICI" not in s
    assert any(w in s for w in ("HBM3", "NVLink", "tensor cores"))
