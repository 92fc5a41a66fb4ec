"""The model dry-run (``launch.specs``, ``launch.dryrun``) and the model
branch of ``analysis.roofline.model_flops_for``, against the JAX reference
where it runs, on the CPU.

The reference's own dry-run cannot run (``repro.launch.specs`` fails at
import, ROADMAP queue 3, F6), so the port is held to what of it does run:
``model_flops_for``, the ``microbatches_for`` rule (its source, compiled
here alone), and the placement rules ``param_specs``, ``cache_specs`` and
``input_specs_for`` on the per-layer shapes of each cell (reduced configs,
fake 2×2 and 2×2×2 meshes). The records' numbers are integers and are held
exactly: the argument bytes to the placed DTensors' local blocks, the
collective bytes to an analytic count of the steps' whole-weight gathers
and full-grad reductions, the per-rank dot FLOPs on a (K, 1) mesh times K
to the one-device step's (counted by torch's ``FlopCounterMode``), and the temp bytes of a fake trace to the same
step's on real CPU tensors."""

import ast
import dataclasses
import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.analysis import roofline as jroof  # noqa: E402
from repro.dist import sharding as js  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402
from repro_torch.analysis.audit import op_trace as ot  # noqa: E402
from repro_torch.configs import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.dist import sharding as ts  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import fake_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, Shard  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

torch.set_num_threads(1)

ARCH_IDS = list(tcfgs.ALIASES)
MESHES = {"2x2": ((2, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CELLS = {"train": ShapeSpec("train_small", 16, 8, "train"),
         "prefill": ShapeSpec("prefill_small", 16, 8, "prefill"),
         "decode": ShapeSpec("decode_small", 16, 8, "decode")}
NMB = 2


def _reduced(arch):
    return tcfgs.get_config(arch).reduced()


def reduced_overrides(arch):
    """``ModelConfig.reduced()`` as the overrides ``cell_specs`` and
    ``run_cell`` take: the fields it changes."""
    full, red = tcfgs.get_config(arch), _reduced(arch)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


def _cell(arch, step, mesh, **kw):
    return specs.cell_specs(arch, CELLS[step], mesh, cfg_overrides=reduced_overrides(arch),
                            force_nmb=NMB if step == "train" else None, **kw)


# --- useful FLOPs and microbatches ----------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_for_equals_reference(arch, shape):
    assert troof.model_flops_for(arch, shape) == jroof.model_flops_for(arch, shape)


def test_model_flops_for_qwen2_train_and_unknown_cells():
    assert troof.model_flops_for("qwen2-0.5b", "train_4k") == pytest.approx(3.108e15, rel=1e-3)
    for arch, shape in (("no-such-arch", "train_4k"), ("qwen2-0.5b", "no-such-shape")):
        with pytest.raises(KeyError):
            troof.model_flops_for(arch, shape)


def _reference_microbatches_for():
    """``microbatches_for`` compiled from the reference's source alone (its
    module cannot be imported: F6)."""
    path = Path(jcfgs.__file__).parents[1] / "launch" / "specs.py"
    fn = next(n for n in ast.parse(path.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "microbatches_for")
    fn.returns = None
    fn.args.args[0].annotation = fn.args.args[1].annotation = None
    ns = {}
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ns["microbatches_for"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_microbatches_for_equals_reference_rule(arch):
    ref = _reference_microbatches_for()
    cfg = tcfgs.get_config(arch)
    for spec in SHAPES.values():
        assert specs.microbatches_for(cfg, spec.global_batch) == ref(cfg, spec.global_batch)
    wide = cfg.d_model >= 3584 or cfg.n_experts
    assert specs.microbatches_for(cfg, 256) == (8 if wide else 4)
    assert specs.microbatches_for(cfg, 1) == 1 and specs.microbatches_for(cfg, 96) == (
        3 if wide else 1)


# --- placements against the reference's spec functions --------------------------------

def _structs(tree):
    if isinstance(tree, dict):
        return {k: _structs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structs(v) for v in tree]
    return jax.ShapeDtypeStruct(tree, jnp.float32)


def _duck(mesh):
    import types

    return types.SimpleNamespace(shape=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                                 axis_names=tuple(mesh.mesh_dim_names))


def _entries(specs_tree):
    return jax.tree.map(tuple, specs_tree, is_leaf=lambda x: isinstance(x, js.P))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_placements_equal_reference_specs(arch, mesh_name):
    """Every cell's parameter, cache and input placements are the
    reference's ``param_specs`` (fsdp on for train, off otherwise),
    ``cache_specs`` and ``input_specs_for`` of the same per-layer shapes."""
    jcfg = jcfgs.get_config(arch).reduced()
    with fake_mesh(*MESHES[mesh_name]) as mesh:
        duck = _duck(mesh)
        for step, shp in CELLS.items():
            cell = _cell(arch, step, mesh)
            B, S = shp.global_batch, shp.seq_len
            max_seq = S if step != "train" or jcfg.pos_embedding == "learned" else 4096
            params = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), jcfg,
                                                           max_seq=max_seq))
            per_layer = _structs(bridge.layer_shapes(params))
            want = bridge.placements_from_specs(_entries(js.param_specs(
                jcfg, per_layer, duck, fsdp=step == "train")), mesh)
            assert cell.placements[0] == want, step
            assert set(want) == {k for k, _ in cell.args[0].named_parameters()}
            feeds = {"tokens": (B, 1 if step == "decode" else S)}
            if step == "train":
                feeds |= {"labels": (B, S), "mask": (B, S)}
            if jcfg.n_enc_layers and step != "decode":
                feeds["enc_feats"] = (B, jcfg.enc_seq, jcfg.d_model)
            want_in = bridge.placements_from_specs(
                _entries(js.input_specs_for(_structs(feeds), duck)), mesh)
            if step == "train":
                assert cell.placements[2] == want_in
                continue
            got_in = {"tokens": cell.placements[1]}
            if len(cell.args) == 4 and step == "prefill":
                got_in["enc_feats"] = cell.placements[3]
            assert got_in == want_in, step
            cache = jax.eval_shape(lambda: jm.init_cache(jcfg, B, S, dtype=jnp.bfloat16))
            want_c = bridge.placements_from_specs(_entries(js.cache_specs(
                jcfg, _structs(bridge.cache_layer_shapes(cache)), duck)), mesh)
            assert cell.placements[2] == want_c, step


def test_pod_mesh_splits_the_batch_over_pod_and_data():
    """On ("pod", "data", "model") the data axes are pod and data, as the
    reference's are: the batch is Shard(0) on both, and rank 0 holds B/4."""
    with fake_mesh(*MESHES["2x2x2"]) as mesh:
        cell = _cell("qwen2-0.5b", "train", mesh)
        tok = cell.args[2]["tokens"]
        assert tuple(tok.placements) == (Shard(0), Shard(0), ts.Replicate())
        assert tok.to_local().shape == (2, 16)
        rec = dryrun.trace_cell(cell)
    assert rec["status"] == "ok" and rec["n_devices"] == 8


# --- the records' numbers --------------------------------------------------------------

def _placed_bytes(cell):
    """Per-rank bytes of a cell's arguments from each leaf's global shape,
    dtype and placement tuple alone (an even split a Shard), walked with
    the cell's placement trees."""
    from torch.distributed.tensor import Replicate

    sizes = tuple(cell.mesh.shape)

    def pairs(arg, pl):
        if isinstance(arg, torch.nn.Module):
            return [(p, pl[k]) for k, p in arg.named_parameters()]
        if torch.is_tensor(arg):
            return [(arg, pl)]
        if isinstance(arg, tuple) and hasattr(arg, "_fields"):          # OptState
            return (pairs(arg.mu, pl.mu) + pairs(arg.nu, pl.nu)
                    + [(arg.step, (Replicate(),) * len(sizes))])
        if isinstance(arg, dict):
            return [x for k in arg for x in pairs(arg[k], pl[k])]
        return [x for a, p in zip(arg, pl) for x in pairs(a, p)]

    total = 0
    for arg, pl in zip(cell.args, cell.placements):
        for t, p in ([] if pl is None else pairs(arg, pl)):
            shape = list(t.shape)
            for placement, k in zip(p, sizes):
                if isinstance(placement, Shard):
                    shape[placement.dim] //= k
            total += math.prod(shape) * t.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("step", list(CELLS))
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-small", "mixtral-8x22b"])
def test_argument_bytes_are_the_placed_local_blocks(arch, step, mesh_name):
    with fake_mesh(*MESHES[mesh_name]) as mesh:
        cell = _cell(arch, step, mesh)
        with cell.fake_mode:
            got = dryrun.local_bytes(cell.args)
        assert got == _placed_bytes(cell) > 0


def _gather_bytes(t, dims, mesh):
    """Bytes that ``sharding.gather`` all-reduces for ``t`` over ``dims``:
    the buffer's bytes once over the default group when ``dims`` is every
    dim of the mesh, else once a dim."""
    if not dims:
        return 0, 0
    full = list(t.shape)
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and i not in dims:
            full[p.dim] //= mesh.size(i)
    nb = math.prod(full) * t.dtype.itemsize
    calls = 1 if len(dims) == mesh.ndim else len(dims)
    return nb * calls, calls


def _expected_train_collectives(cell):
    model, mesh = cell.args[0], cell.mesh
    data = [i for i, n in enumerate(mesh.mesh_dim_names) if n != "model" and mesh.size(i) > 1]
    nbytes = calls = 0
    for p in model.parameters():
        b, c = _gather_bytes(p, [i for i, pl in enumerate(p.placements)
                                 if isinstance(pl, Shard)], mesh)
        nbytes, calls = nbytes + b, calls + c
        nbytes += 4 * p.numel() * len(data)                 # the full grad, once a data dim
        calls += len(data)
    nbytes += (4 * NMB + 8) * len(data)                       # Σ mask a microbatch, (loss, ce)
    calls += 2 * len(data)
    return nbytes + 4, calls + 1                              # the grad norm, over the mesh


def _expected_serve_collectives(cell):
    model, cache, mesh = cell.args[0], cell.args[2], cell.mesh
    nbytes = calls = 0
    for p in model.parameters():
        b, c = _gather_bytes(p, [i for i, pl in enumerate(p.placements)
                                 if isinstance(pl, Shard)], mesh)
        nbytes, calls = nbytes + b, calls + c
    for leaf in ts.tree_leaves(cache):
        b, c = _gather_bytes(leaf, [i for i, pl in enumerate(leaf.placements)
                                    if isinstance(pl, Shard) and pl.dim != 0], mesh)
        nbytes, calls = nbytes + b, calls + c
    return nbytes, calls


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("step", list(CELLS))
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-small", "mixtral-8x22b"])
def test_collective_bytes_are_the_whole_weight_gathers(arch, step, mesh_name):
    with fake_mesh(*MESHES[mesh_name]) as mesh:
        cell = _cell(arch, step, mesh)
        want = (_expected_train_collectives if step == "train"
                else _expected_serve_collectives)(cell)
        rec = dryrun.trace_cell(cell)
    coll = rec["collectives"]
    assert set(coll["by_op"]) == {"c10d.allreduce_"}
    assert (coll["total_bytes"], coll["by_op"]["c10d.allreduce_"]["count"]) == want


def _one_device(cfg, step, shp):
    """The dot FLOPs of a cell's one-device step on fake tensors, as torch's
    ``FlopCounterMode`` counts them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import init_cache
    from repro_torch.serve.step import decode_step, prefill_step
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step

    B, S = shp.global_batch, shp.seq_len
    mode = FakeTensorMode()
    if step == "train":
        model = specs.params_dtype_struct(
            cfg, S if cfg.pos_embedding == "learned" else 4096, fake_mode=mode)
    else:
        model = specs.params_dtype_struct(cfg, S, torch.bfloat16, fake_mode=mode)
    with mode:
        tok = torch.zeros((B, 1 if step == "decode" else S), dtype=torch.int64)
        enc = (torch.zeros((B, cfg.enc_seq, cfg.d_model), dtype=torch.bfloat16)
               if cfg.n_enc_layers and step != "decode" else None)
        if step == "train":
            batch = {"tokens": tok, "labels": tok.clone(), "mask": torch.zeros((B, S))}
            if enc is not None:
                batch["enc_feats"] = enc
            fn = make_train_step(cfg, TrainConfig(num_microbatches=NMB))
            run = lambda: fn(model, init_opt_state(model), batch)  # noqa: E731
        else:
            cache = init_cache(cfg, B, S, dtype=torch.bfloat16, device="cpu")
            run = ((lambda: prefill_step(model, cfg, tok, cache, enc_feats=enc, device="cpu"))
                   if step == "prefill" else
                   (lambda: decode_step(model, cfg, tok, cache, S - 1, device="cpu")))
        with FlopCounterMode(display=False) as counter:
            run()
        return counter.get_total_flops()


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("step", list(CELLS))
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-small", "mixtral-8x22b"])
def test_dot_flops_per_rank_times_K_equal_one_device(arch, step, K):
    """On a (K, 1) mesh every rank runs the one-device program on B/K of
    the rows, so K × rank 0's dot FLOPs are the one-device step's."""
    with fake_mesh((K, 1), ("data", "model")) as mesh:
        rec = dryrun.trace_cell(_cell(arch, step, mesh))
    single = _one_device(_reduced(arch), step, CELLS[step])
    assert K * rec["hlo_dot_flops"] == single > 0
    assert sum(rec["flops_by_dtype"].values()) == rec["hlo_dot_flops"]


@pytest.mark.parametrize("step", list(CELLS))
def test_temp_bytes_equal_the_real_steps_live_peak(step):
    """The fake trace's peak live bytes are the same step's on real CPU
    tensors (zeros) with the same placements over the fake group."""
    from repro_torch.models import Transformer, init_cache
    from repro_torch.train.optimizer import init_opt_state

    arch = "qwen2-0.5b"
    cfg, shp = _reduced(arch), CELLS[step]
    B, S = shp.global_batch, shp.seq_len
    with fake_mesh(*MESHES["2x2"]) as mesh:
        cell = _cell(arch, step, mesh)
        rec = dryrun.trace_cell(cell)
        model = Transformer(cfg, max_seq=4096 if step == "train" else S, device="cpu")
        if step != "train":
            for name, p in list(model.named_parameters()):
                owner, _, leaf = name.rpartition(".")
                setattr(model.get_submodule(owner), leaf,
                        torch.nn.Parameter(p.detach().bfloat16(), requires_grad=False))
        ts.place_model(model, mesh, cell.placements[0])
        if step == "train":
            opt = ts.place_state(init_opt_state(model), mesh, cell.placements[0])
            batch = {"tokens": torch.zeros((B, S), dtype=torch.int64),
                     "labels": torch.zeros((B, S), dtype=torch.int64),
                     "mask": torch.ones((B, S))}
            args = (model, opt, ts.place_tree(batch, mesh, cell.placements[2]))
        else:
            cache = ts.place_tree(init_cache(cfg, B, S, dtype=torch.bfloat16, device="cpu"),
                                  mesh, cell.placements[2])
            tok = torch.zeros((B, S if step == "prefill" else 1), dtype=torch.int64)
            args = (model, ts.place_tree(tok, mesh, cell.placements[1]), cache) + (
                (S - 1,) if step == "decode" else ())
        real = ot.record(lambda: cell.fn(*args))
    assert rec["memory"]["temp_size_in_bytes"] == real.peak_live_bytes > 0
    assert rec["memory"]["argument_size_in_bytes"] == _placed_bytes(cell)


# --- whole runs --------------------------------------------------------------------------

def test_qwen2_every_shape_on_the_single_mesh(tmp_path):
    """qwen2-0.5b at full width on the 16×16 fake mesh: each shape ok or
    skipped by ``skip_reason``; nonzero memory figures; ``analyze_record``
    reads every ok record; a second run reuses the cache."""
    assert dryrun.main(["--arch", "qwen2-0.5b", "--mesh", "single",
                        "--out", str(tmp_path)]) == 0
    recs = {r["shape"]: r for r in (json.loads(f.read_text())
                                    for f in (tmp_path / "single").glob("*.json"))}
    assert set(recs) == set(SHAPES)
    cfg = tcfgs.get_config("qwen2-0.5b")
    for shape, r in recs.items():
        reason = tcfgs.skip_reason(cfg, shape)
        if reason:
            assert r["status"] == "skipped" and r["reason"] == reason
            continue
        assert r["status"] == "ok" and r["n_devices"] == 256
        mem = r["memory"]
        assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
        assert set(mem["memory_source"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                             "temp_size_in_bytes"}
        row = troof.analyze_record(r)
        assert row is not None and row.model_flops == troof.model_flops_for("qwen2-0.5b", shape)
        assert r["step_kind"] == SHAPES[shape].step
    train = recs["train_4k"]
    assert train["num_microbatches"] == 4
    # the whole fp32 weights are gathered: every weight's bytes at least once
    assert train["collectives"]["total_bytes"] >= 4 * cfg.param_count()
    mtime = {f: f.stat().st_mtime_ns for f in (tmp_path / "single").glob("*.json")}
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "single",
                        "--out", str(tmp_path)]) == 0
    assert {f: f.stat().st_mtime_ns for f in (tmp_path / "single").glob("*.json")} == mtime


def test_a_failing_cell_is_recorded_and_the_run_exits_1(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no such step")

    monkeypatch.setattr(specs, "cell_specs", boom)
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k", "--mesh", "single",
                        "--out", str(tmp_path), "--no-fsdp", "--ce-chunks", "4"]) == 1
    rec = json.loads((tmp_path / "single" / "qwen2-0.5b__train_4k-nofsdp-ce4.json").read_text())
    assert rec["status"] == "error" and "no such step" in rec["error"]
    assert "Traceback" in rec["traceback"]


def test_override_flags_tag_the_file(tmp_path):
    rec = dryrun.run_cell("qwen2-0.5b", CELLS["decode"], "single", tmp_path,
                          cfg_overrides={**reduced_overrides("qwen2-0.5b"), "n_layers": 2},
                          tag="-nlayers", mesh_shape=(2, 2))
    assert rec["status"] == "ok" and rec["mesh"] == "single" and rec["n_devices"] == 4
    assert (tmp_path / "single" / "qwen2-0.5b__decode_small-nlayers.json").exists()
    assert rec["params"] == dataclasses.replace(_reduced("qwen2-0.5b"), n_layers=2).param_count()
