"""The port's LM models (``repro_torch.models``, ``configs``) against the JAX
reference on the CPU, at the reduced configs.

The reference's parameters (``repro.models.init_params(PRNGKey(0),
cfg.reduced())``) cross over through ``bridge.model_from_numpy``; inputs
are drawn with numpy from a seed. Both run in fp32. Forward logits and
every prefilled cache leaf must agree within 1e-4·max|ref| + 1e-5 (matmuls
summed in another order than XLA's, the RG-LRU scan run sequentially;
about 1e-6 of the scale is typical). Step-by-step decode is held to the
reference's uncached forward at its own bound, rtol = atol = 2e-3
(``tests/test_models.py``).

bf16, the default compute dtype of both packages, is held to the
reference's bf16 forward at 2e-2·max|ref| (a dense, a windowed and a
recurrent config; 0.9-1.4e-2 is typical, about the gap between the
reference's own bf16 and fp32 logits). A logit bound cannot tell one
misplaced cast from rounding at random weights, so every config's bf16
forward is also checked op by op: its matmuls take the operand dtypes
the reference's dots take, its softmaxes and norm statistics read fp32,
and a bf16 cache holds the reference's leaf dtypes.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.analysis.audit.op_trace import CONTRACTION_OPS, record  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402

torch.set_num_threads(1)
ARCH_IDS = list(jcfgs.ALIASES)
REM = "recurrentgemma-9b@7"          # n_layers 7: two pattern blocks and one remainder layer
CASES = ARCH_IDS + [REM]
DECODE_ARCHS = ["gemma2-27b", "recurrentgemma-9b", "rwkv6-3b", "whisper-small", "qwen2-7b"]
F32, BF16 = torch.float32, torch.bfloat16
BF16_ARCHS = ["qwen2-7b", "gemma2-27b", "recurrentgemma-9b"]   # dense, windowed, recurrent
BF16_REL_TOL = 2e-2


def _cfgs(case, **changes):
    arch, _, n_layers = case.partition("@")
    ref, port = jcfgs.get_config(arch).reduced(), tcfgs.get_config(arch).reduced()
    if n_layers:
        changes["n_layers"] = int(n_layers)
    return dataclasses.replace(ref, **changes), dataclasses.replace(port, **changes)


@functools.lru_cache(maxsize=None)
def _ref_params(case, max_seq=64, **changes):
    cfg, _ = _cfgs(case, **changes)
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), cfg, max_seq=max_seq))


def _setup(case, B=2, S=16, seed=1, **changes):
    jcfg, tcfg = _cfgs(case, **changes)
    params = _ref_params(case, **changes)
    model = bridge.model_from_numpy(params, tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab, (B, S))
    enc = (rng.standard_normal((B, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
           if jcfg.n_enc_layers else None)
    return jcfg, tcfg, params, model, tokens, enc


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= 1e-4 * scale + 1e-5, f"{what}: max |Δ| {err:.3e} at scale {scale:.3e}"


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_reference(case):
    jcfg, tcfg, params, model, tokens, enc = _setup(case)
    if case == REM:
        assert jcfg.n_rem == 1 and len(model.rem) == 1
    ref, _ = jm.forward(params, jcfg, _j(tokens), enc_feats=_j(enc), compute_dtype=jnp.float32)
    got, cache = model(_t(tokens), enc_feats=_t(enc), compute_dtype=F32)
    assert cache is None and got.dtype == F32
    _close(got.numpy(), ref, f"{case} logits")


@pytest.mark.parametrize("arch,S", [("gemma2-27b", 40), ("recurrentgemma-9b", 12),
                                    ("rwkv6-3b", 12), ("whisper-small", 12), ("qwen2-7b", 12)])
def test_prefill_cache_matches_reference(arch, S):
    """Every cache leaf after ``prefill_step`` equals the reference's
    (unstacked) leaf: the ring's slots (gemma2's prompt 40 > window 32),
    the RG-LRU and RWKV states, whisper's cross K/V, the full KV cache;
    and the reference's cache, carried into the port's layout, decodes."""
    B, max_seq = 2, S + 8
    jcfg, tcfg, params, model, tokens, enc = _setup(arch, B=B, S=S)
    jcache = jm.init_cache(jcfg, B, max_seq, dtype=jnp.float32)
    jlog, jcache = jstep.prefill_step(params, jcfg, _j(tokens), jcache, enc_feats=_j(enc),
                                      compute_dtype=jnp.float32)
    cache = init_cache(tcfg, B, max_seq, dtype=F32, device="cpu")
    log, cache = tstep.prefill_step(model, tcfg, _t(tokens), cache, enc_feats=_t(enc),
                                    compute_dtype=F32, device="cpu")
    _close(log.numpy(), jlog, f"{arch} prefill logits")
    got, want = bridge.cache_to_numpy(cache), jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        _close(g, w, f"{arch} cache {jax.tree_util.keystr(path)}")
    if arch == "gemma2-27b":
        assert want["blocks"]["p0_local"]["k"].shape[2] == jcfg.window
    # the reference's filled cache, carried across, decodes the next token
    # as the reference does from it
    nxt = np.random.default_rng(5).integers(0, jcfg.vocab, (B, 1))
    jlog, _ = jstep.decode_step(params, jcfg, _j(nxt), jcache, jnp.asarray(S, jnp.int32),
                                compute_dtype=jnp.float32)
    log, _ = tstep.decode_step(model, tcfg, _t(nxt), bridge.cache_from_numpy(want, device="cpu"),
                               S, compute_dtype=F32, device="cpu")
    _close(log.numpy(), jlog, f"{arch} decode from the reference's cache")


def _decode(model, cfg, tokens, enc, max_seq, dtype=F32):
    """Step-by-step decode logits (B, S, V) from an empty cache, cache and
    compute in ``dtype``."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_seq, dtype=dtype, device="cpu")
    if enc is not None:
        cache = tstep._merge(cache, model.build_cross_cache(model.encode(_t(enc), dtype)))
    outs = []
    for t in range(S):
        lg, cache = tstep.decode_step(model, cfg, _t(tokens[:, t:t + 1]), cache, t,
                                      compute_dtype=dtype, device="cpu")
        outs.append(lg)
    return torch.stack(outs, dim=1).numpy()


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_reference_forward(arch):
    S = 12
    jcfg, tcfg, params, model, tokens, enc = _setup(arch, S=S)
    ref, _ = jm.forward(params, jcfg, _j(tokens), enc_feats=_j(enc), compute_dtype=jnp.float32)
    np.testing.assert_allclose(_decode(model, tcfg, tokens, enc, S), np.asarray(ref),
                               rtol=2e-3, atol=2e-3)


def _close_bf16(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= BF16_REL_TOL * scale, f"{what}: max |Δ| {err:.3e} at scale {scale:.3e}"


def _port_cache_leaves(cache):
    """The port's cache in the reference's layout: path → (dtype name, the
    values in fp32, a position's layers stacked)."""
    out = {}
    for name, layers in cache["blocks"].items():
        for leaf, t in layers[0].items():
            out[("blocks", name, leaf)] = (str(t.dtype).split(".")[-1],
                                           np.stack([c[leaf].float().numpy() for c in layers]))
    for name, c in cache["rem"].items():
        for leaf, t in c.items():
            out[("rem", name, leaf)] = (str(t.dtype).split(".")[-1], t.float().numpy())
    return out


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_matches_reference(arch):
    """bf16 forward, bf16 decode and the bf16 prefilled cache against the
    reference's bf16, leaf dtypes equal."""
    S = 12
    jcfg, tcfg, params, model, tokens, enc = _setup(arch, S=S)
    ref, _ = jm.forward(params, jcfg, _j(tokens), enc_feats=_j(enc), compute_dtype=jnp.bfloat16)
    got, _ = model(_t(tokens), enc_feats=_t(enc), compute_dtype=BF16)
    assert got.dtype == F32
    _close_bf16(got.numpy(), ref, f"{arch} bf16 forward")
    _close_bf16(_decode(model, tcfg, tokens, enc, S, dtype=BF16), ref, f"{arch} bf16 decode")
    B, max_seq = tokens.shape[0], S + 4
    _, jcache = jstep.prefill_step(params, jcfg, _j(tokens), jm.init_cache(jcfg, B, max_seq),
                                   enc_feats=_j(enc), compute_dtype=jnp.bfloat16)
    cache = init_cache(tcfg, B, max_seq, device="cpu")
    _, cache = tstep.prefill_step(model, tcfg, _t(tokens), cache, enc_feats=_t(enc),
                                  compute_dtype=BF16, device="cpu")
    want = {tuple(k.key for k in path): (str(leaf.dtype), np.asarray(leaf, np.float32))
            for path, leaf in jax.tree_util.tree_leaves_with_path(jcache)}
    have = _port_cache_leaves(cache)
    assert {k: v[0] for k, v in have.items()} == {k: v[0] for k, v in want.items()}
    for key, (_, w) in want.items():
        _close_bf16(have[key][1], w, f"{arch} bf16 cache {key}")


def _ref_dot_dtypes(jaxpr, found):
    """The operand dtypes of every ``dot_general`` in a jaxpr, into its
    scans and calls."""
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            found.add(frozenset(str(v.aval.dtype) for v in e.invars))
        for p in e.params.values():
            for sub in p if isinstance(p, (tuple, list)) else (p,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    _ref_dot_dtypes(sub, found)
    return found


@pytest.mark.parametrize("case", CASES)
def test_bf16_op_dtypes_match_reference(case):
    """Under bf16 the port's matmuls take the operand dtypes the
    reference's dots take (bf16, and fp32 only where the reference too
    contracts in fp32: MoE routing, RWKV's WKV), and every softmax and
    every norm's mean reads fp32."""
    jcfg, tcfg, params, model, tokens, enc = _setup(case, S=12)
    trace = record(lambda: model(_t(tokens), enc_feats=_t(enc), compute_dtype=BF16))
    dots, fp32_only = set(), {}
    for s in trace.sites:
        names = frozenset(str(d).split(".")[-1] for d in s.in_dtypes)
        if s.base in CONTRACTION_OPS:
            dots.add(names)
        elif s.base in ("aten._softmax", "aten.mean"):
            fp32_only.setdefault(s.base, set()).add(names)
    closed = jax.make_jaxpr(lambda p, t, e: jm.forward(p, jcfg, t, enc_feats=e,
                                                       compute_dtype=jnp.bfloat16))(
        params, _j(tokens), _j(enc))
    assert dots == _ref_dot_dtypes(closed.jaxpr, set()), case
    assert frozenset({"bfloat16"}) in dots
    assert all(v == {frozenset({"float32"})} for v in fp32_only.values()), fp32_only
    assert "aten.mean" in fp32_only


def test_moe_full_capacity_decode_matches_reference():
    """Capacity that never binds makes routing exact, so decode equals the
    reference's forward at the reference's 1e-4 (mixtral)."""
    cfg, _ = _cfgs("mixtral-8x22b")
    cf = float(cfg.n_experts) / cfg.top_k + 0.01
    jcfg, tcfg, params, model, tokens, _ = _setup("mixtral-8x22b", S=12, capacity_factor=cf)
    ref, _ = jm.forward(params, jcfg, _j(tokens), compute_dtype=jnp.float32)
    got = _decode(model, tcfg, tokens, None, 12)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)
    _close(model(_t(tokens), compute_dtype=F32)[0].numpy(), ref, "mixtral forward")


def test_moe_capacity_drops_match_reference():
    """qwen2-moe at capacity factor 0.5 (4 slots per expert for 32
    assignments in a group of 16): dropped tokens pass through the residual
    only, in both packages alike."""
    jcfg, tcfg, params, model, tokens, _ = _setup("qwen2-moe-a2.7b", capacity_factor=0.5)
    ref, _ = jm.forward(params, jcfg, _j(tokens), compute_dtype=jnp.float32)
    got = model(_t(tokens), compute_dtype=F32)[0].numpy()
    _close(got, ref, "qwen2-moe logits under binding capacity")
    full = dataclasses.replace(tcfg, capacity_factor=float(tcfg.n_experts) / tcfg.top_k + 0.01)
    unbound = bridge.model_from_numpy(params, full, device="cpu")(_t(tokens), compute_dtype=F32)
    assert float(np.abs(unbound[0].numpy() - got).max()) > 1e-2   # the capacity did bind


def _port_tree_shapes(model):
    """The port's parameters as the reference's tree of shapes: a pattern
    position's (and the encoder's) layers stacked on a leading axis."""
    shapes = {}
    for key, p in model.named_parameters():
        parts = key.split(".")
        if parts[0] in ("blocks", "enc_blocks"):
            i = 2 if parts[0] == "blocks" else 1
            path = tuple(parts[:i] + parts[i + 1:])
            n, shape = shapes.get(path, (0, None))
            shapes[path] = (n + 1, tuple(p.shape))
        else:
            shapes[tuple(parts)] = (None, tuple(p.shape))
        assert p.dtype == F32, key
    return {k: shape if n is None else (n,) + shape for k, (n, shape) in shapes.items()}


@pytest.mark.parametrize("case", CASES)
def test_init_params_matches_reference_tree(case):
    """The port's own ``init_params``: the reference's tree leaf for leaf
    (shapes, fp32), each leaf from the reference's distribution: its
    constant leaves equal; of the others with 256 entries or more, the
    spread within 20% and the mean within 5 standard errors."""
    jcfg, tcfg = _cfgs(case)
    model = init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu",
                        max_seq=64)
    ref = {tuple(k.key for k in path): leaf for path, leaf in
           jax.tree_util.tree_leaves_with_path(_ref_params(case))}
    assert _port_tree_shapes(model) == {k: v.shape for k, v in ref.items()}
    for key, p in model.named_parameters():
        want = bridge._ref_leaf(_ref_params(case), key)
        got = p.detach().numpy()
        if want.std() == 0:
            np.testing.assert_array_equal(got, want, err_msg=key)
        elif want.size >= 256:
            assert 0.8 < got.std() / want.std() < 1.25, key
            assert abs(got.mean() - want.mean()) < 5 * want.std() * (2 / want.size) ** 0.5, key


def test_configs_match_reference():
    """The ten configs, their reduced forms, parameter counts, layer kinds
    and the shape cells are the reference's to the digit."""
    assert tcfgs.ARCHS == jcfgs.ARCHS and tcfgs.ALIASES == jcfgs.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in tcfgs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfgs.SHAPES.items()}
    for arch in list(jcfgs.ALIASES) + list(jcfgs.ARCHS):
        j, t = jcfgs.get_config(arch), tcfgs.get_config(arch)
        for jc, tc in ((j, t), (j.reduced(), t.reduced())):
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
            assert tc.param_count() == jc.param_count()
            assert tc.active_param_count() == jc.active_param_count()
            assert tc.layer_kinds() == jc.layer_kinds()
        assert tcfgs.cells(arch) == jcfgs.cells(arch)
    qwen = tcfgs.get_config("qwen2-0.5b")
    assert (qwen.n_layers, qwen.d_model, qwen.n_heads, qwen.n_kv_heads, qwen.head_dim,
            qwen.d_ff, qwen.vocab) == (24, 896, 14, 2, 64, 4864, 151_936)
    assert round(qwen.param_count() / 1e9, 3) == 0.494


def test_param_counts_match_published():
    expect = {
        "internvl2-2b": (1.7e9, 2.2e9),
        "gemma2-27b": (26e9, 29e9),
        "qwen2-7b": (7.0e9, 8.0e9),
        "mixtral-8x22b": (135e9, 145e9),
        "qwen2-moe-a2.7b": (13.5e9, 15.0e9),
        "rwkv6-3b": (2.7e9, 3.3e9),
        "recurrentgemma-9b": (8.0e9, 10.0e9),
    }
    for arch, (lo, hi) in expect.items():
        n = tcfgs.get_config(arch).param_count()
        assert lo < n < hi, f"{arch}: {n / 1e9:.2f}B outside [{lo / 1e9},{hi / 1e9}]"
    moe = tcfgs.get_config("qwen2-moe-a2.7b")
    assert moe.active_param_count() < 0.35 * moe.param_count()


def test_forward_runs_layers_position_major():
    """The stack runs every layer of pattern position 0 before any of
    position 1 (the reference's order), not ``layer_kinds()``'s
    interleaving: recurrentgemma at n_layers 7 runs rnn ×2, rnn ×2,
    local ×2, then the remainder rnn."""
    _, tcfg = _cfgs(REM)
    model = init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    order = [layer.kind for *_, layer in model.layers()]
    assert order == ["rnn", "rnn", "rnn", "rnn", "local", "local", "rnn"]
    assert list(tcfg.layer_kinds()) == ["rnn", "rnn", "local", "rnn", "rnn", "local", "rnn"]
