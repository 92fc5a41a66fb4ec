"""The port's placement rules (``repro_torch.dist.sharding``) against the
reference's spec functions, and the port's error-feedback int8 functions
(``repro_torch.dist.compress``) against the reference's, on the CPU with
no process group.

The spec functions are pure functions of leaf shapes and mesh axis sizes,
so both packages are handed the same shapes (the reference's
``eval_shape`` of ``init_params`` and ``init_cache`` at full width) and a
duck-typed mesh (``.shape``, ``.axis_names``). Each is applied to the
reference's stacked leaves (ROADMAP queue 3, F5: the rules then reach the
layer axis) and to the port's per-layer leaves (the stacked shapes with
the layer axis dropped, ``bridge.layer_shapes``). Placements must render
as the reference's ``P(...)`` entries exactly. The EF codes and scales are
held bitwise; the EF trajectories keep the reference test's bounds.
"""

import functools
import types
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.dist import compress as jc  # noqa: E402
from repro.dist import sharding as js  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.dist import compress as tc  # noqa: E402
from repro_torch.dist import sharding as ts  # noqa: E402
from repro_torch.ft.resilience import AbstractMesh  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from torch.distributed.tensor import Placement, Shard  # noqa: E402

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
CACHE_BATCH, CACHE_SEQ = 16, 64


def _mesh(name):
    sizes, names = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=names)


@functools.lru_cache(maxsize=None)
def _shapes(arch, reduced=False):
    cfg = jcfgs.get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    params = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), cfg, max_seq=1024))
    cache = jax.eval_shape(lambda: jm.init_cache(cfg, CACHE_BATCH, CACHE_SEQ,
                                                 dtype=jnp.float32))
    return cfg, params, cache


def _structs(tree):
    """A tree of shapes (tuples, lists of dicts of tuples) as jax shape
    structs, for the reference's functions."""
    if isinstance(tree, dict):
        return {k: _structs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structs(v) for v in tree]
    return jax.ShapeDtypeStruct(tree, jnp.float32)


def _assert_same(got, want, shapes, mesh, ndim=True):
    """Every placement tuple of ``got`` renders as ``want``'s P entries."""
    g = jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda x: isinstance(x, tuple) and all(isinstance(p, Placement)
                                                            for p in x))
    w = jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda x: isinstance(x, js.P))
    s = jax.tree_util.tree_leaves(shapes)
    assert [p for p, _ in g] == [p for p, _ in w]
    assert len(g) == len(s)
    for (path, pl), (_, spec), leaf in zip(g, w, s):
        entries = ts.to_partition_names(pl, mesh, len(leaf.shape) if ndim else None)
        assert entries == tuple(spec), (jax.tree_util.keystr(path), leaf.shape, entries, spec)
        assert ts.from_partition_names(tuple(spec), mesh) == pl


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_param_placements_match_param_specs(arch, mesh_name):
    """Stacked and per-layer leaves, fsdp off and on."""
    cfg, params, _ = _shapes(arch)
    mesh = _mesh(mesh_name)
    per_layer = _structs(bridge.layer_shapes(params))
    for fsdp in (False, True):
        for tree in (params, per_layer):
            _assert_same(ts.param_placements(cfg, tree, mesh, fsdp=fsdp),
                         js.param_specs(cfg, tree, mesh, fsdp=fsdp), tree, mesh)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_cache_placements_match_cache_specs(arch, mesh_name):
    cfg, _, cache = _shapes(arch)
    mesh = _mesh(mesh_name)
    per_layer = _structs(bridge.cache_layer_shapes(cache))
    for tree in (cache, per_layer):
        _assert_same(ts.cache_placements(cfg, tree, mesh), js.cache_specs(cfg, tree, mesh),
                     tree, mesh)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_input_placements_match_input_specs_for(mesh_name):
    """P(data axes) or P(), rendered without padding (the reference's
    input specs name the batch axis alone)."""
    mesh = _mesh(mesh_name)
    for B in (1, 2, 6, 8, 16, 32, 48):
        batch = {"tokens": jax.ShapeDtypeStruct((B, 16), jnp.int32),
                 "labels": jax.ShapeDtypeStruct((B, 16), jnp.int32),
                 "mask": jax.ShapeDtypeStruct((B, 16), jnp.float32),
                 "enc_feats": jax.ShapeDtypeStruct((B, 30, 8), jnp.float32)}
        _assert_same(ts.input_placements(batch, mesh), js.input_specs_for(batch, mesh),
                     batch, mesh, ndim=False)


@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_layer_shapes_are_the_ports_parameters(arch):
    """``bridge.layer_shapes`` of the reference's stacked tree names and
    shapes the port's own parameters, and ``cache_layer_shapes`` its cache."""
    from repro_torch.models import init_cache

    jcfg, params, cache = _shapes(arch, reduced=True)
    tcfg = tcfgs.get_config(arch).reduced()
    model = Transformer(tcfg, max_seq=1024, device="cpu")
    assert bridge.layer_shapes(params) == {k: tuple(p.shape) for k, p in model.named_parameters()}
    tcache = init_cache(tcfg, CACHE_BATCH, CACHE_SEQ, dtype=torch.float32, device="cpu")
    assert bridge.cache_layer_shapes(cache) == ts.tree_map(lambda t: tuple(t.shape), tcache)


def test_f5_the_reference_rules_reach_the_stacked_axes():
    """F5, as the reference computes it: on stacked leaves a norm scale
    shards over model, a cache puts its layer axis over data and its batch
    over model, and fsdp takes the layer axis; on the port's per-layer
    leaves the same rules replicate the scale and put the batch over data."""
    mesh = _mesh("4x2")
    cfg, _, _ = _shapes("qwen2-7b", reduced=True)
    cache = jax.eval_shape(lambda: jm.init_cache(cfg, 8, 32, dtype=jnp.float32))
    k = cache["blocks"]["p0_attn"]["k"]
    assert k.shape == (2, 8, 32, 4, 16)
    assert tuple(js.cache_specs(cfg, cache, mesh)["blocks"]["p0_attn"]["k"]) == \
        (None, "model", None, None, None)
    assert ts.to_partition_names(ts.cache_placements(cfg, k, mesh), mesh, 5) == \
        (None, "model", None, None, None)
    assert ts.to_partition_names(ts.cache_placements(cfg, (8, 32, 4, 16), mesh), mesh, 4) == \
        ("data", "model", None, None)
    d = cfg.d_model
    assert ts.to_partition_names(ts.param_placements(cfg, (2, d), mesh), mesh, 2) == \
        (None, "model")
    assert ts.to_partition_names(ts.param_placements(cfg, (d,), mesh), mesh, 1) == (None,)
    _, params, _ = _shapes("qwen2-0_5b")
    wq = params["blocks"]["p0_attn"]["attn"]["wq"]            # (24, 896, 14, 64)
    spec = tuple(js.param_specs(cfg, {"wq": wq}, mesh, fsdp=True)["wq"])
    assert spec == ("data", None, None, "model")
    assert ts.to_partition_names(ts.param_placements(cfg, wq, mesh, fsdp=True), mesh, 4) == spec
    assert ts.to_partition_names(ts.param_placements(cfg, wq.shape[1:], mesh, fsdp=True),
                                 mesh, 3) == ("data", None, "model")


def test_port_meshes_are_accepted():
    """A ``DeviceMesh``-free ``AbstractMesh`` (the elastic planner's) and a
    mesh whose ``.shape`` lists sizes in axis order place alike."""
    cfg, params, _ = _shapes("qwen2-0_5b")
    a = ts.param_placements(cfg, params, AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                            fsdp=True)
    b = ts.param_placements(cfg, params, types.SimpleNamespace(
        shape=(2, 16, 16), axis_names=("pod", "data", "model")), fsdp=True)
    assert a == b
    assert a["embed"] == (Shard(0), Shard(0), Shard(1))


def test_specs_round_trip_through_the_bridge():
    """``placements_from_specs`` of the reference's specs (as tuples) is
    the port's placements, and ``specs_from_placements`` gives the tuples
    back."""
    mesh = _mesh("2x16x16")
    cfg, params, cache = _shapes("recurrentgemma-9b")
    for tree, ref, port in ((params, js.param_specs(cfg, params, mesh, fsdp=True),
                             ts.param_placements(cfg, params, mesh, fsdp=True)),
                            (cache, js.cache_specs(cfg, cache, mesh),
                             ts.cache_placements(cfg, cache, mesh))):
        entries = jax.tree.map(tuple, ref, is_leaf=lambda x: isinstance(x, js.P))
        assert bridge.placements_from_specs(entries, mesh) == port
        ndims = jax.tree.map(lambda s: len(s.shape), tree)
        assert bridge.specs_from_placements(port, mesh, ndims) == entries


# ---------------------------------------------------------------------------
# Error-feedback int8 compression
# ---------------------------------------------------------------------------

EF_SHAPES = [(1000,), (64, 33), (5, 6, 7), (1,)]


@pytest.mark.parametrize("shape", EF_SHAPES + ["zeros", "tiny", "huge"])
def test_ef_codes_and_scales_are_bitwise_the_references(shape):
    rng = np.random.default_rng(zlib.crc32(str(shape).encode()))
    if shape == "zeros":
        v = np.zeros((7, 3), np.float32)
    elif shape == "tiny":
        v = (rng.standard_normal((40, 9)) * 1e-30).astype(np.float32)
    elif shape == "huge":
        v = (rng.standard_normal((40, 9)) * 1e30).astype(np.float32)
    else:
        v = (rng.standard_normal(shape) * 5).astype(np.float32)
    jcodes, jscale = jc._quantize(jnp.asarray(v))
    tcodes, tscale = tc._quantize(torch.tensor(v))
    assert tcodes.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    assert tscale.numpy().tobytes() == np.asarray(jscale, np.float32).tobytes()
    r = (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
    jh, jr = jc.compress_decompress(jnp.asarray(v), jnp.asarray(r))
    th, tr = tc.compress_decompress(torch.tensor(v), torch.tensor(r))
    assert th.numpy().tobytes() == np.asarray(jh).tobytes()
    assert tr.numpy().tobytes() == np.asarray(jr).tobytes()


def test_gradient_compression_error_feedback():
    """``tests/test_dist.py::test_gradient_compression_error_feedback`` on
    the port: EF-int8 gradient descent tracks the uncompressed one on a
    quadratic (the reference's bound, 1%)."""
    rng = np.random.default_rng(0)
    H = rng.standard_normal((16, 16)).astype(np.float32)
    H = torch.tensor(H @ H.T / 16 + np.eye(16, dtype=np.float32))
    b = torch.tensor(rng.standard_normal(16).astype(np.float32))

    def grad(x):
        return H @ x - b

    x_ref, x_c = torch.zeros(16), torch.zeros(16)
    ef, lr = tc.init_ef(x_c), 0.05
    for _ in range(150):
        x_ref = x_ref - lr * grad(x_ref)
        g_hat, ef = tc.compress_tree(grad(x_c), ef)
        x_c = x_c - lr * g_hat
    rel = float(torch.linalg.norm(x_c - x_ref) / torch.linalg.norm(x_ref))
    assert rel < 0.01, f"EF-compressed trajectory diverged: {rel}"


def test_int8_quantization_bounds():
    """``tests/test_dist.py::test_int8_quantization_bounds`` on the port."""
    x = torch.tensor(np.random.default_rng(2).standard_normal(1000).astype(np.float32) * 5)
    g_hat, ef2 = tc.compress_tree(x, tc.init_ef(x))
    assert float((g_hat - x).abs().max()) <= float(x.abs().max()) / 127.0 * 1.01
    np.testing.assert_allclose(ef2.residual.numpy(), (x - g_hat).numpy(), rtol=1e-5, atol=1e-6)


def test_compress_tree_over_dicts_and_namedtuples():
    """Trees of dicts, lists and NamedTuples keep their structure, every
    leaf is the reference's bitwise, and the wire ratio is the reference's."""
    rng = np.random.default_rng(5)
    leaves = {k: (rng.standard_normal(s) * 3).astype(np.float32)
              for k, s in (("a", (6, 5)), ("b", (7,)), ("c", (3, 2, 4)))}
    tree = tc.EFState(residual={"x": torch.tensor(leaves["a"]),
                                "y": [torch.tensor(leaves["b"]), torch.tensor(leaves["c"])]})
    jtree = jc.EFState(residual={"x": jnp.asarray(leaves["a"]),
                                 "y": [jnp.asarray(leaves["b"]), jnp.asarray(leaves["c"])]})
    ef, jef = tc.init_ef(tree), jc.init_ef(jtree)
    for _ in range(3):
        tree_hat, ef = tc.compress_tree(tree, ef)
        jtree_hat, jef = jc.compress_tree(jtree, jef)
    assert isinstance(tree_hat, tc.EFState) and isinstance(tree_hat.residual["y"], list)
    for got, want in zip(ts.tree_leaves(tree_hat) + ts.tree_leaves(ef.residual),
                         jax.tree.leaves(jtree_hat) + jax.tree.leaves(jef.residual)):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert tc.compression_ratio(tree) == jc.compression_ratio(jtree)
