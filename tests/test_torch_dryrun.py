"""The solver's pod-scale dry-run (``launch.dryrun_solver``) on the CPU.

Every variant's per-rank program is traced under ``FakeTensorMode`` on a
fake mesh (nothing allocated), at a reduced shape over a 4×4 and a 2×4×4
mesh, and its dot FLOPs and collective bytes are held exactly (they are
integers) to an analytic count of its per-rank dots and payloads, written
here from the variants' definitions. The dtype split of the dots from the
op recorder must sum to ``FlopCounterMode``'s count. The full-size
``probe_2m_8k`` cells, all six variants on the 16×16 and 2×16×16 meshes,
must trace with status ``ok`` and read back through ``analyze_record``."""

import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.launch import dryrun_solver as dr  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

DIMS = dict(n=1 << 12, d=64, c=16, m=128, pcg_iters=10)
MESHES = {"single": (4, 4), "multi": (2, 4, 4)}


def _expected(variant, mesh_shape):
    """(dot FLOPs, collective output bytes, collective count) of one rank."""
    n, d, c, m, iters = (DIMS[k] for k in ("n", "d", "c", "m", "pcg_iters"))
    M = mesh_shape[-1]
    K = math.prod(mesh_shape[:-1])
    n_l = n // (K * M) if variant.startswith("flat") else n // K
    d_l = d // M if variant.startswith("2d") else d
    hvps = iters + 1
    dots = 2 * m * d * d + hvps * 2 * (2 * n_l * d_l * c)
    if variant == "gaussian":
        dots += 2 * m * n_l * d
    if variant.startswith("2d"):
        coll = 4 * m * d_l + 4 * m * d + hvps * 4 * (n_l * c + d_l * c + d * c)
        count = 2 + 3 * hvps
    else:
        coll, count = 4 * m * d + hvps * 4 * d * c, 1 + hvps
    return dots, coll, count


@pytest.fixture(scope="module")
def reduced():
    return {(v, mesh): dr.run(v, mesh, None, dims=DIMS, mesh_shape=shape)
            for mesh, shape in MESHES.items() for v in dr.VARIANTS}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("variant", dr.VARIANTS)
def test_dot_flops_and_collectives_match_the_analytic_count(reduced, variant, mesh):
    rec = reduced[(variant, mesh)]
    assert rec["status"] == "ok", rec.get("error")
    dots, coll, count = _expected(variant, MESHES[mesh])
    assert rec["hlo_dot_flops"] == dots
    assert rec["collectives"]["total_bytes"] == coll
    assert sum(c["count"] for c in rec["collectives"]["by_op"].values()) == count
    assert rec["n_devices"] == math.prod(MESHES[mesh])
    # the recorder's dtype split of the dots sums to FlopCounterMode's count
    assert sum(rec["dot_flops_by_dtype"].values()) == dots
    low = "bfloat16" if variant.endswith("bf16") or variant == "gaussian" else None
    assert set(rec["dot_flops_by_dtype"]) == {"float32"} | ({low} if low else set())
    # the analytic non-dot FLOPs (d³/3 is not an integer) join the fp32
    # part: equal to float rounding, rel 1e-12
    assert rec["flops"] == pytest.approx(dots + sum(rec["analytic_flops"].values()), rel=1e-12)
    assert sum(rec["flops_by_dtype"].values()) == pytest.approx(rec["flops"], rel=1e-12)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("variant", dr.VARIANTS)
def test_analyze_record_terms(reduced, variant, mesh):
    rec = reduced[(variant, mesh)]
    r = roofline.analyze_record(rec)
    terms = {"compute": r.compute_s, "memory": r.memory_s, "collective": r.collective_s}
    assert all(math.isfinite(t) and t > 0 for t in terms.values())
    assert r.bottleneck == max(terms, key=terms.get) and r.step_time_s == max(terms.values())
    assert r.collective_s == rec["collectives"]["total_bytes"] / roofline.NVLINK_BYTES
    assert r.memory_s == rec["bytes_accessed"] / roofline.PEAK_BYTES
    assert 0 < r.useful_ratio and math.isfinite(r.mfu)


def test_full_size_probe_on_both_production_meshes(tmp_path):
    assert dr.main(["--mesh", "both", "--out", str(tmp_path)]) == 0
    files = sorted(tmp_path.glob("*/*.json"))
    assert len(files) == 12
    recs = [json.loads(f.read_text()) for f in files]
    assert all(r["status"] == "ok" and r["shape"] == "probe_2m_8k" for r in recs)
    assert {r["n_devices"] for r in recs} == {256, 512}
    rows = roofline.load_all(tmp_path)
    assert len(rows) == 12
    assert "solver-ridge-flat" in roofline.markdown_table(rows)
    flat = next(r for r in recs if r["arch"] == "solver-ridge-flat" and r["mesh"] == "single")
    assert flat["per_rank"] == dict(K=16, M=16, n_l=(1 << 21) // 256, d_l=8192)


def test_production_mesh_is_fake_and_torn_down():
    import torch.distributed as dist

    with make_production_mesh(multi_pod=True) as mesh:
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16) and dist.get_world_size() == 512
    assert not dist.is_initialized()


def test_model_cells_wait_for_the_model_configs():
    with pytest.raises(KeyError, match="model configs"):
        roofline.model_flops_for("qwen2-0.5b", "train_4k")
    assert roofline.analyze_record({"status": "ok", "arch": "qwen2-0.5b", "shape": "x",
                                    "mesh": "single", "n_devices": 1, "flops": 1.0,
                                    "collectives": {"total_bytes": 0}}) is None
