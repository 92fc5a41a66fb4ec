"""The port's AdamW, learning-rate schedule and train step
(``repro_torch.train``) against the JAX reference on the CPU, at the
reduced configs, in fp32 unless stated.

The reference's parameters cross over through ``bridge.model_from_numpy``
and the port's parameters and moments come back through ``bridge``'s tree
mapping; batches are drawn with numpy from a seed. Bounds:

* AdamW and the schedule, on the same grads: rtol 1e-5, atol 1e-8 (the
  global norm summed in another order moves the clip scale by an ulp);
* three train steps: loss and metrics rtol 1e-4; every parameter within
  three steps of 2·lr, and at most 1e-4 of them more than 1e-2·lr apart.
  Adam moves each parameter by about lr·m/√v, so a grad entry near 0 whose
  rounding differs can move it by up to 2·lr a step (about 1e-1·lr is
  seen, in a few entries in 1e5); the moments within rtol 1e-3, ``mu``
  with atol 1e-6 (1e-4 of its largest entry, about 1e-2) and ``nu`` with
  atol 1e-4 of its largest entry (a scale of g², about 2e-4 here);
* one bf16 step: loss, ce and grad norm within 2e-2 (bf16 rounding, as
  ``tests/test_torch_models.py`` bounds the forward), the updates by sign.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return jcfgs.get_config(arch).reduced(), tcfgs.get_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def _ref_params(arch, max_seq=32):
    cfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), cfg, max_seq=max_seq))


def _batch(cfg, B=4, S=16, seed=1, partial_mask=True):
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


def _model(arch):
    _, tcfg = _cfgs(arch)
    return tcfg, bridge.model_from_numpy(_ref_params(arch), tcfg, device="cpu")


def _close_trees(got, want, what, rtol, atol):
    g, w = jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------

SHAPES = {"a": (6, 5), "b": (7,), "c": (3, 2, 4)}


def _adam_inputs(seed, n_steps, grad_scale):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(n_steps)]
    return params, grads


@pytest.mark.parametrize("grad_clip,grad_scale,weight_decay", [
    (1.0, 1.0, 0.1),        # clipping active (‖g‖ ≈ 8)
    (1.0, 0.01, 0.1),       # clipping inactive
    (0.0, 1.0, 0.0),        # no clipping, no decay
])
def test_adamw_update_matches_reference(grad_clip, grad_scale, weight_decay):
    cfg = dict(lr=1e-2, grad_clip=grad_clip, weight_decay=weight_decay, warmup_steps=2,
               total_steps=6)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    params, grads = _adam_inputs(0, 5, grad_scale)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jopt.init_opt_state(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tst = topt.init_opt_state(tp)
    assert tst.step.dtype == torch.int32 and tst.mu["a"].dtype == F32
    for g in grads:
        jp, jst, jm_ = jopt.adamw_update(jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()}, jst)
        tp, tst, tm = topt.adamw_update(tcfg, tp, {k: torch.tensor(v) for k, v in g.items()}, tst)
        for k in SHAPES:
            for got, want in ((tp[k], jp[k]), (tst.mu[k], jst.mu[k]), (tst.nu[k], jst.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-8)
        assert int(tst.step) == int(jst.step)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm_[key]), rtol=1e-6)


def test_lr_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=1000, min_lr_ratio=0.1)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    for s in (0, 1, 37, 100, 101, 550, 999, 1000, 1500):
        got = float(topt.lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32)))
        want = float(jopt.lr_schedule(jcfg, jnp.asarray(s, jnp.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=f"step {s}")
    assert float(topt.lr_schedule(tcfg, torch.tensor(1500))) == pytest.approx(3e-5)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _train_cfgs(nmb, dtype, ce_chunks=0, lr=1e-3):
    opt = dict(lr=lr, warmup_steps=1, total_steps=10)
    j = jstep.TrainConfig(opt=jopt.AdamWConfig(**opt), num_microbatches=nmb,
                          compute_dtype={F32: jnp.float32, BF16: jnp.bfloat16}[dtype],
                          ce_chunks=ce_chunks)
    t = tstep.TrainConfig(opt=topt.AdamWConfig(**opt), num_microbatches=nmb,
                          compute_dtype=dtype, ce_chunks=ce_chunks)
    return j, t


def _run_both(case, nmb, dtype, n_steps, B=4, ce_chunks=0):
    jcfg, _ = _cfgs(case)
    j_tc, t_tc = _train_cfgs(nmb, dtype, ce_chunks)
    batch = _batch(jcfg, B=B)
    params = jax.tree.map(jnp.asarray, _ref_params(case))
    jst = jopt.init_opt_state(params)
    j_step = jax.jit(jstep.make_train_step(jcfg, j_tc))
    tcfg, model = _model(case)
    tst = topt.init_opt_state(model)
    t_step = tstep.make_train_step(tcfg, t_tc)
    tb = _t(batch)
    out = []
    for _ in range(n_steps):
        params, jst, jm_ = j_step(params, jst, _j(batch))
        model, tst, tm = t_step(model, tst, tb)
        out.append(({k: float(v) for k, v in tm.items()}, {k: float(v) for k, v in jm_.items()}))
    return out, bridge.model_to_numpy(model), jax.tree.map(np.asarray, params), tst, jst


@pytest.mark.parametrize("case,nmb,ce_chunks", [
    ("qwen2-0.5b", 1, 0), ("qwen2-0.5b", 2, 0), ("qwen2-0.5b", 2, 8),
    ("mixtral-8x22b", 2, 0), ("whisper-small", 2, 0), ("rwkv6-3b", 1, 0),
])
def test_train_step_matches_reference(case, nmb, ce_chunks):
    """Three fp32 steps from the reference's weights on the reference's
    batch: every metric, every parameter and both moments."""
    lr = 1e-3
    metrics, got, want, tst, jst = _run_both(case, nmb, F32, 3, ce_chunks=ce_chunks)
    for i, (tm, jm_) in enumerate(metrics):
        assert set(tm) == set(jm_) == {"loss", "ce", "grad_norm", "lr"}
        for k in tm:
            np.testing.assert_allclose(tm[k], jm_[k], rtol=1e-4, err_msg=f"step {i} {k}")
    moved, total = 0, 0
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        d = np.abs(a - b)
        assert d.max() <= 2 * 3 * lr, jax.tree_util.keystr(path)      # 3 steps of ≤ 2·lr
        moved += int((d > 1e-2 * lr).sum())
        total += d.size
    assert moved <= 1e-4 * total, (moved, total)
    assert int(tst.step) == int(jst.step) == 3
    t_opt, j_nu = bridge.opt_state_to_numpy(tst), jax.tree.map(np.asarray, jst.nu)
    _close_trees(t_opt.mu, jax.tree.map(np.asarray, jst.mu), f"{case} mu", rtol=1e-3, atol=1e-6)
    nu_scale = max(float(np.abs(v).max()) for v in jax.tree.leaves(j_nu))
    _close_trees(t_opt.nu, j_nu, f"{case} nu", rtol=1e-3, atol=1e-4 * nu_scale)


def test_train_step_bf16_matches_reference():
    """One bf16 step (two microbatches): loss, ce and grad norm within 2e-2
    of the reference's; parameters and moments stay fp32. The first Adam
    step moves each parameter by about ±lr, so the updates are compared by
    sign: bf16 rounding flips only entries whose grad is near 0 (about 0.4%
    here), a misplaced cast or a wrong grad about half."""
    lr = 1e-3
    metrics, got, want, tst, _ = _run_both("qwen2-7b", 2, BF16, 1)
    (tm, jm_), = metrics
    for k in ("loss", "ce", "grad_norm"):
        assert abs(tm[k] - jm_[k]) <= 2e-2 * abs(jm_[k]), (k, tm[k], jm_[k])
    start = jax.tree.leaves(_ref_params("qwen2-7b"))
    same = total = 0
    for a, b, p0 in zip(jax.tree.leaves(got), jax.tree.leaves(want), start):
        assert a.dtype == np.float32 and np.abs(a - b).max() <= 2 * lr
        same += int((np.sign(a - p0) == np.sign(b - p0)).sum())
        total += a.size
    assert same >= 0.98 * total, same / total
    assert all(t.dtype == F32 for t in tst.mu.values())


def test_train_step_rejects_an_uneven_split():
    _, t_tc = _train_cfgs(3, F32)
    tcfg, model = _model("qwen2-0.5b")
    step = tstep.make_train_step(tcfg, t_tc)
    with pytest.raises(ValueError, match="microbatches"):
        step(model, topt.init_opt_state(model), _t(_batch(model.cfg, B=4)))


def test_blocked_ce_train_step_converges():
    """``tests/test_blocked_ce.py::test_blocked_ce_train_step_converges`` on
    the port: 25 steps of the blocked loss, 2 microbatches, fp32, on one
    batch; the loss falls below 0.6 of the first."""
    tcfg, model = _model("qwen2-0.5b")
    t_tc = tstep.TrainConfig(opt=topt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=40),
                             num_microbatches=2, compute_dtype=F32, ce_chunks=8)
    step = tstep.make_train_step(tcfg, t_tc)
    opt = topt.init_opt_state(model)
    batch = _t(_batch(tcfg, B=4, partial_mask=False))
    losses = []
    for _ in range(25):
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.6, losses
