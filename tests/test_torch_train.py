"""The port's LM training (``repro_torch.train``) against the JAX reference
on the CPU, at the reduced configs, in fp32 unless stated.

The reference's parameters (``repro.models.init_params(PRNGKey(0), ...)``)
cross over through ``bridge.model_from_numpy``; the port's ``.grad``,
parameters and AdamW moments come back through ``bridge``'s tree mapping.
Inputs are drawn with numpy from a seed. Bounds:

* ``lm_loss``, ``blocked_lm_loss``: |Δ| < 1e-5, every grad leaf rtol 2e-4, atol 2e-5: the reference's
  own bound between its blocked and plain losses
  (``tests/test_blocked_ce.py``); the two packages sum their matmuls in
  other orders (about 1e-6 of the scale);
* remat on and off: bitwise equal;
* the bridge's tree mapping: bitwise round trips.

AdamW, the schedule and the train step are in
``tests/test_torch_train_step.py``.
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
from repro.train import step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCH_IDS = list(jcfgs.ALIASES)
REM = "recurrentgemma-9b@7"          # two pattern blocks and one remainder layer
CASES = ARCH_IDS + [REM]
F32, BF16 = torch.float32, torch.bfloat16
LOSS_TOL, RTOL, ATOL = 1e-5, 2e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(case, **changes):
    arch, _, n_layers = case.partition("@")
    ref, port = jcfgs.get_config(arch).reduced(), tcfgs.get_config(arch).reduced()
    if n_layers:
        changes["n_layers"] = int(n_layers)
    return dataclasses.replace(ref, **changes), dataclasses.replace(port, **changes)


@functools.lru_cache(maxsize=None)
def _ref_params(case, max_seq=32):
    cfg, _ = _cfgs(case)
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), cfg, max_seq=max_seq))


def _batch(cfg, B=2, S=16, seed=1, partial_mask=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    mask = np.ones((B, S), np.float32)
    if partial_mask:
        mask[0, :3] = 0.0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    if cfg.n_enc_layers:
        batch["enc_feats"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _model(case):
    _, tcfg = _cfgs(case)
    model = bridge.model_from_numpy(_ref_params(case), tcfg, device="cpu")
    return tcfg, model.requires_grad_(True)


def _port_value_and_grad(model, loss_fn, *, remat=True, **kw):
    model.zero_grad(set_to_none=True)
    loss, aux = loss_fn(model, model.cfg, remat=remat, **kw)
    loss.backward()
    return float(loss.detach()), bridge.grads_to_numpy(model)


def _close_trees(got, want, what, rtol=RTOL, atol=ATOL):
    g, w = jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _loss_args(batch, ref):
    conv = _j if ref else _t
    b = conv(batch)
    return dict(tokens=b["tokens"], labels=b["labels"], mask=b["mask"],
                enc_feats=b.get("enc_feats"))


@pytest.mark.parametrize("case", CASES)
def test_lm_loss_and_grads_match_reference(case):
    """lm_loss and every grad leaf, fp32, a partial mask, remat on (both
    packages' default), against ``jax.value_and_grad`` of the reference."""
    jcfg, _ = _cfgs(case)
    params = _ref_params(case)
    batch = _batch(jcfg)
    ja = _loss_args(batch, ref=True)
    want_l, want_g = jax.jit(jax.value_and_grad(lambda p: jstep.lm_loss(
        p, jcfg, ja["tokens"], ja["labels"], ja["mask"], enc_feats=ja["enc_feats"],
        compute_dtype=jnp.float32)[0]))(params)
    _, model = _model(case)
    got_l, got_g = _port_value_and_grad(model, tstep.lm_loss, compute_dtype=F32,
                                        **_loss_args(batch, ref=False))
    assert abs(got_l - float(want_l)) < LOSS_TOL, (got_l, float(want_l))
    _close_trees(got_g, jax.tree.map(np.asarray, want_g), f"{case} grad")


@pytest.mark.parametrize("arch,chunks", [("qwen2-0.5b", 8), ("gemma2-27b", 4)])
def test_blocked_lm_loss_matches_reference(arch, chunks):
    """The blocked loss (tied head; gemma2: final softcap, embed scale)
    against the reference's blocked loss and the port's lm_loss."""
    jcfg, _ = _cfgs(arch)
    params = _ref_params(arch)
    batch = _batch(jcfg)
    ja = _loss_args(batch, ref=True)
    want_l, want_g = jax.value_and_grad(lambda p: jstep.blocked_lm_loss(
        p, jcfg, ja["tokens"], ja["labels"], ja["mask"], ce_chunks=chunks,
        compute_dtype=jnp.float32)[0])(params)
    _, model = _model(arch)
    ta = _loss_args(batch, ref=False)
    got_l, got_g = _port_value_and_grad(model, functools.partial(
        tstep.blocked_lm_loss, ce_chunks=chunks), compute_dtype=F32, **ta)
    plain_l, plain_g = _port_value_and_grad(model, tstep.lm_loss, compute_dtype=F32, **ta)
    assert abs(got_l - float(want_l)) < LOSS_TOL and abs(got_l - plain_l) < LOSS_TOL
    _close_trees(got_g, jax.tree.map(np.asarray, want_g), f"{arch} blocked grad")
    _close_trees(got_g, plain_g, f"{arch} blocked against lm_loss grad")


def test_blocked_lm_loss_needs_chunks_dividing_the_vocab():
    _, model = _model("qwen2-0.5b")
    ta = _loss_args(_batch(model.cfg), ref=False)
    with pytest.raises(ValueError, match="not divisible"):
        tstep.blocked_lm_loss(model, model.cfg, ce_chunks=7, compute_dtype=F32, **ta)


@pytest.mark.parametrize("case", ["qwen2-0.5b", "whisper-small", "mixtral-8x22b", REM])
@pytest.mark.parametrize("blocked", [False, True])
def test_remat_gives_the_same_loss_and_grads(case, blocked):
    """The recompute in backward changes nothing: loss and every grad with
    remat on equal those with it off (bitwise on the CPU, where both run
    the same kernels in the same order)."""
    _, model = _model(case)
    ta = _loss_args(_batch(model.cfg), ref=False)
    fn = functools.partial(tstep.blocked_lm_loss, ce_chunks=4) if blocked else tstep.lm_loss
    on = _port_value_and_grad(model, fn, remat=True, compute_dtype=F32, **ta)
    off = _port_value_and_grad(model, fn, remat=False, compute_dtype=F32, **ta)
    assert on[0] == off[0]
    _close_trees(on[1], off[1], "remat", rtol=0, atol=0)


def test_remat_refuses_a_cache():
    _, model = _model("qwen2-0.5b")
    from repro_torch.models import init_cache
    cache = init_cache(model.cfg, 2, 8, dtype=F32, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        model(torch.zeros((2, 4), dtype=torch.long), cache=cache, cache_pos=0, remat=True)


# ---------------------------------------------------------------------------
# The bridge's tree mapping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_model_to_numpy_inverts_model_from_numpy(case):
    """A reference tree through the port's model and back is bitwise the
    same tree, and the optimizer state's mapping round-trips too."""
    want = _ref_params(case)
    _, model = _model(case)
    got = bridge.model_to_numpy(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    state = topt.init_opt_state(model)
    for i, t in enumerate(state.mu.values()):
        t.fill_(i)
    back = bridge.opt_state_from_numpy(bridge.opt_state_to_numpy(state), model, device="cpu")
    assert all(torch.equal(back.mu[k], state.mu[k]) for k in state.mu)
    assert back.step.dtype == torch.int32
