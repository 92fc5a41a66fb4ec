"""Sharded LM training and decode (``make_train_step(mesh=)``,
``serve.step`` under a mesh, ``launch.train --mesh``) on CPU gloo ranks,
against the port's single-device step and the JAX reference.

Each module-scope fixture starts one gloo group through
``launch.mesh.run_ranks`` (``launch.sharded_lm.run_tasks`` on every rank)
and runs every task of its size in it. The rank tasks start from the
reference's parameters (``bridge.model_from_numpy``) on a batch drawn with
numpy from a seed, with a ragged mask: its rows hold 13, 16, 16 and 5
tokens, so a data rank's share of a microbatch's Σ mask is not the
microbatch's. Bounds:

* (1, 1): bitwise the single-device step (the rank runs both); (1, 2) with
  no clipping: loss, ce, every full gradient, parameter and moment bitwise
  (no reduction touches them), the grad norm within 1e-6 relative (a sum
  of per-block squares in another order);
* (2, 2), fsdp off and on, 1 and 2 microbatches, a binding clip (0.05
  against norms of 4-5), three steps: loss, ce and grad norm within 1e-5
  relative of the port's single-device step, every parameter within 1e-4
  absolute, each moment within 1e-4 of its largest entry; against the
  reference's single-device step the bounds of
  ``tests/test_torch_train_step.py`` (metrics 1e-4 relative; parameters
  within three steps of 2·lr, at most 1e-4 of them more than 1e-2·lr
  apart), since the port's own single-device step differs from it by that;
* every config reduced (recurrentgemma with a remainder layer) on (2, 1)
  with fsdp and a split batch, one step: loss and grad norm within 1e-5,
  parameters within 1e-4 of the single-device step in the same rank;
* decode on (2, 2) at qwen2-7b reduced (the reference test's config):
  every step's logits within 2e-4 of the reference's single-device
  ``prefill_step`` / ``decode_step`` fed the same tokens (the reference's
  bound); the cache keeps its placements and the input cache is unchanged;
* ``launch.train --mesh 4``: a resume, a resume after SIGTERM to rank 2,
  and checkpoints crossing between the single-device launcher, the
  reference's manager and the mesh, every leaf bitwise.
"""

import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.ft import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.serve import step as jserve  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.optimizer import OptState as JOptState  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.ft import CheckpointManager  # noqa: E402
from repro_torch.ft.checkpoint import _flatten  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import EXIT_PREEMPTED, run_ranks  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.train import AdamWConfig, TrainConfig, init_opt_state, make_train_step  # noqa: E402

JOB = "repro_torch.launch.sharded_lm:run_tasks"
ARCH, STEPS, LR, CLIP = "qwen2-0.5b", 3, 1e-3, 0.05
OPT = dict(lr=LR, warmup_steps=1, total_steps=10, grad_clip=CLIP)
CASES = [(fsdp, nmb) for fsdp in (False, True) for nmb in (1, 2)]
CONFIGS = [(a, None) for a in tcfgs.ARCHS] + [("recurrentgemma-9b", 7)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, n_layers=None, max_seq=32):
    cfg = jcfgs.get_config(arch).reduced()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), cfg,
                                                        max_seq=max_seq))


def _batch(cfg, B=4, S=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    mask = np.ones((B, S), np.float32)
    mask[0, :3] = 0.0
    mask[3, 5:] = 0.0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    if cfg.n_enc_layers:
        batch["enc_feats"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _train_task(model, fsdp, nmb, *, arch=ARCH, n_layers=None, steps=STEPS, opt=OPT,
                single=False):
    cfg, params = _ref_params(arch, n_layers)
    return dict(arch=arch, n_layers=n_layers, params=params, model=model, fsdp=fsdp,
                nmb=nmb, opt=opt, batch=_batch(cfg), steps=steps, single=single)


@pytest.fixture(scope="module")
def one():
    """(1, 1): the sharded step beside the single-device one in one rank."""
    tasks = [("bitwise", "train", _train_task(1, True, 2, single=True))]
    return run_ranks(JOB, 1, {"tasks": tasks}, device="cpu", timeout=600)


@pytest.fixture(scope="module")
def two():
    """(1, 2) with no clipping, and every config on (2, 1)."""
    tasks = [("bitwise", "train", _train_task(2, False, 2, single=True,
                                              opt={**OPT, "grad_clip": 0.0}))]
    tasks += [(f"cfg-{a}-{n}", "train", _train_task(1, True, 2, arch=a, n_layers=n, steps=1,
                                                    single=True)) for a, n in CONFIGS]
    return run_ranks(JOB, 2, {"tasks": tasks}, device="cpu", timeout=600)


DECODE = dict(arch="qwen2-7b", model=2, new=4, max_seq=16)


@pytest.fixture(scope="module")
def four():
    """(2, 2): the train cases and sharded decode."""
    tasks = [(f"train-{f}-{n}", "train", _train_task(2, f, n)) for f, n in CASES]
    cfg, params = _ref_params("qwen2-7b")
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, (8, 5))
    tasks.append(("decode", "decode", dict(DECODE, params=params, prompt=prompt)))
    return run_ranks(JOB, 4, {"tasks": tasks}, device="cpu", timeout=600)


def _t(batch):
    return {k: torch.as_tensor(v).long() if k in ("tokens", "labels") else torch.as_tensor(v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _single(nmb):
    """The port's single-device steps from the reference's parameters."""
    _, params = _ref_params(ARCH)
    cfg = tcfgs.get_config(ARCH).reduced()
    model = bridge.model_from_numpy(params, cfg, device="cpu")
    st = init_opt_state(model)
    step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(**OPT), num_microbatches=nmb,
                                            compute_dtype=torch.float32))
    batch, metrics = _t(_batch(cfg)), []
    for _ in range(STEPS):
        model, st, m = step(model, st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: p.detach().clone() for k, p in model.named_parameters()}, st


@functools.lru_cache(maxsize=None)
def _reference(nmb):
    """The reference's single-device ``make_train_step``, jitted."""
    jcfg, params = _ref_params(ARCH)
    tc = jstep.TrainConfig(opt=jopt.AdamWConfig(**OPT), num_microbatches=nmb,
                           compute_dtype=jnp.float32)
    step = jax.jit(jstep.make_train_step(jcfg, tc))
    p = jax.tree.map(jnp.asarray, params)
    st, batch, metrics = jopt.init_opt_state(p), jax.tree.map(jnp.asarray, _batch(jcfg)), []
    for _ in range(STEPS):
        p, st, m = step(p, st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, p)


def _assert_equal(got: dict, want: dict, what):
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), f"{what} {k}"


def test_one_by_one_mesh_is_bitwise_the_single_device_step(one):
    res = one[0]["bitwise"]
    assert res["metrics"] == res["single"]["metrics"]
    for what in ("params", "mu", "nu"):
        _assert_equal(res[what], res["single"][what], what)


def test_one_by_two_loss_and_full_grads_are_bitwise(two):
    """Model-parallel only: the weights gathered exactly, so the loss and
    every full gradient are the single-device ones; with no clipping the
    update is too. Every rank holds the same metrics."""
    res = two[0]["bitwise"]
    for got, want in zip(res["metrics"], res["single"]["metrics"]):
        assert got["loss"] == want["loss"] and got["ce"] == want["ce"]
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-6)
    _assert_equal(res["grads"], res["single"]["grads"], "grad")
    for what in ("params", "mu", "nu"):
        _assert_equal(res[what], res["single"][what], what)
    assert two[1]["bitwise"]["metrics"] == res["metrics"]
    shards = [p for p in res["placements"].values() if any(q.is_shard() for q in p)]
    assert len(shards) > len(res["placements"]) // 2          # the model axis splits most


def _close_to_single(res, metrics, params, st, *, loss_rtol=1e-5, param_atol=1e-4):
    for got, want in zip(res["metrics"], metrics):
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert got[k] == pytest.approx(want[k], rel=loss_rtol), k
    for k, want in params.items():
        np.testing.assert_allclose(res["params"][k].numpy(), want.numpy(), rtol=0,
                                   atol=param_atol, err_msg=k)
    for what, mom in (("mu", st.mu), ("nu", st.nu)):
        for k, want in mom.items():
            np.testing.assert_allclose(res[what][k].numpy(), want.numpy(), rtol=0,
                                       atol=1e-4 * float(want.abs().max()), err_msg=f"{what} {k}")


@pytest.mark.parametrize("fsdp,nmb", CASES)
def test_two_by_two_matches_the_single_device_step(four, fsdp, nmb):
    metrics, params, st = _single(nmb)
    _close_to_single(four[0][f"train-{fsdp}-{nmb}"], metrics, params, st)
    assert metrics[0]["grad_norm"] > 20 * CLIP                # the clip binds
    for r in four[1:]:                                        # one verdict on every rank
        assert r[f"train-{fsdp}-{nmb}"]["metrics"] == four[0][f"train-{fsdp}-{nmb}"]["metrics"]


@pytest.mark.parametrize("fsdp,nmb", CASES)
def test_two_by_two_matches_the_reference_step(four, fsdp, nmb):
    res = four[0][f"train-{fsdp}-{nmb}"]
    metrics, jparams = _reference(nmb)
    for got, want in zip(res["metrics"], metrics):
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert got[k] == pytest.approx(want[k], rel=1e-4), k
    got = bridge.to_numpy(bridge.to_ref_tree(res["params"]))
    moved, total = 0, 0
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jparams)):
        d = np.abs(a - b)
        assert d.max() <= 2 * STEPS * LR, jax.tree_util.keystr(path)
        moved += int((d > 1e-2 * LR).sum())
        total += d.size
    assert moved <= 1e-4 * total, (moved, total)


@pytest.mark.parametrize("arch,n_layers", CONFIGS)
def test_every_config_on_two_data_ranks(two, arch, n_layers):
    """One fp32 step, fsdp on, the batch split over 2 data ranks with 2
    microbatches, against the single-device step in the same rank."""
    res = two[0][f"cfg-{arch}-{n_layers}"]
    single = res["single"]
    for k in ("loss", "grad_norm"):
        assert res["metrics"][0][k] == pytest.approx(single["metrics"][0][k], rel=1e-5), k
    for k, want in single["params"].items():
        np.testing.assert_allclose(res["params"][k].numpy(), want.numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)
    assert two[1][f"cfg-{arch}-{n_layers}"]["metrics"] == res["metrics"]


def test_sharded_decode_matches_the_reference(four):
    """Prefill and three decode steps on (2, 2), every rank's logits
    within 2e-4 of the reference's on the same tokens, the cache placed as
    it went in and the input cache unchanged; ``greedy_generate`` under the
    mesh gives the loop's ids."""
    jcfg, params = _ref_params("qwen2-7b")
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab, (8, 5))
    res = four[0]["decode"]
    ids = res["ids"].numpy()
    p = jax.tree.map(jnp.asarray, params)
    cache = jm.init_cache(jcfg, 8, DECODE["max_seq"], dtype=jnp.float32)
    want, cache = jserve.prefill_step(p, jcfg, jnp.asarray(prompt, jnp.int32), cache,
                                      compute_dtype=jnp.float32)
    wants = [np.asarray(want)]
    for i in range(DECODE["new"] - 1):
        want, cache = jserve.decode_step(p, jcfg, jnp.asarray(ids[:, i:i + 1], jnp.int32), cache,
                                         jnp.asarray(prompt.shape[1] + i, jnp.int32),
                                         compute_dtype=jnp.float32)
        wants.append(np.asarray(want))
    for r in four:
        got = r["decode"]
        assert got["placements_kept"] and got["input_unchanged"]
        for g, w in zip(got["logits"], wants):
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4)
        assert torch.equal(got["greedy_ids"], res["ids"])


# ---------------------------------------------------------------------------
# launch.train --mesh 4
# ---------------------------------------------------------------------------

FLAGS = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "32", "--save-every", "5",
         "--log-every", "1", "--device", "cpu"]
MESH_JOB = "repro_torch.launch.train:mesh_rank"


def _mesh_run(d, steps, signal_rank=None):
    return run_ranks(MESH_JOB, 4, {"argv": FLAGS + ["--steps", str(steps), "--ckpt-dir", str(d),
                                                     "--mesh", "4"]},
                     device="cpu", timeout=300, signal_rank=signal_rank)


def _single_run(d, steps):
    train.main(FLAGS + ["--steps", str(steps), "--ckpt-dir", str(d)])


def _leaves(d, step=None):
    model = Transformer(tcfgs.get_config(ARCH).reduced(), max_seq=32, device="cpu")
    tree, extra = CheckpointManager(d).restore(bridge.train_tree(model, init_opt_state(model)),
                                               step=step)
    return {k: v.numpy() for k, v in _flatten(tree).items()}, extra


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def _reference_checkpoint(d, step=5):
    """The reference's parameters and an AdamW state with nonzero moments,
    saved by the reference's manager."""
    jcfg = jcfgs.get_config(ARCH).reduced()
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), jcfg, max_seq=32))
    rng = np.random.default_rng(2)
    mu = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(a.shape)).astype(np.float32), params)
    nu = jax.tree.map(lambda a: (1e-6 * rng.random(a.shape)).astype(np.float32), params)
    JCheckpointManager(d).save(step, (params, JOptState(mu=mu, nu=nu,
                                                        step=np.asarray(step, np.int32))),
                               extra={"step": step, "data": {"step": step}})


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Every launch of the module, side by side where they do not depend
    on each other: the uninterrupted 15 steps, 10 then 15, a SIGTERM to
    rank 2 after step 5's log line then 15, and the crossings."""
    d = {k: tmp_path_factory.mktemp(k) for k in ("straight", "resumed", "sigterm", "single",
                                                 "mesh", "reference")}
    _reference_checkpoint(d["reference"])
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        first = {"straight": ex.submit(_mesh_run, d["straight"], 15),
                 "resumed": ex.submit(_mesh_run, d["resumed"], 10),
                 "sigterm": ex.submit(_mesh_run, d["sigterm"], 15, (2, "step     5 ", 0.0)),
                 "mesh": ex.submit(_mesh_run, d["mesh"], 3)}
        _single_run(d["single"], 3)
        out = {k: f.result() for k, f in first.items()}
    out["before"] = {k: _leaves(d[k]) for k in ("single", "mesh", "reference")}
    out["stopped"] = CheckpointManager(d["sigterm"]).latest_step()
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        second = {"resumed2": ex.submit(_mesh_run, d["resumed"], 15),
                  "sigterm2": ex.submit(_mesh_run, d["sigterm"], 15),
                  "single2": ex.submit(_mesh_run, d["single"], 3),
                  "reference2": ex.submit(_mesh_run, d["reference"], 5)}
        _single_run(d["mesh"], 3)
        out.update({k: f.result() for k, f in second.items()})
    out["after"] = {k: _leaves(d[k]) for k in ("straight", "resumed", "sigterm", "single", "mesh",
                                               "reference")}
    return out


def test_mesh_launcher_resumes_bitwise(launches):
    """10 steps, then a relaunch to 15 on the same directory: every leaf of
    step 15 is the uninterrupted sharded run's."""
    got, extra = launches["after"]["resumed"]
    want, _ = launches["after"]["straight"]
    assert extra == {"step": 15, "data": {"step": 15}}
    _assert_bitwise(got, want)
    assert "resumed from step 10" in launches["resumed2"][0]["log"]
    assert all(r["log"][-1] == "training complete" for r in launches["straight"])


def test_sigterm_to_one_rank_stops_every_rank_at_one_step(launches):
    """SIGTERM to rank 2: every rank exits 75 after committing the same
    step, the lead rank's checkpoint holds it, and a relaunch ends bitwise
    where the uninterrupted run ends."""
    res = launches["sigterm"]
    assert [r["exit_code"] for r in res] == [EXIT_PREEMPTED] * 4
    steps = {r["step"] for r in res}
    assert steps == {launches["stopped"]} and 5 <= launches["stopped"] < 15
    assert all("preemption requested — checkpointing and exiting" in r["log"] for r in res)
    assert f"resumed from step {launches['stopped']}" in launches["sigterm2"][0]["log"]
    _assert_bitwise(launches["after"]["sigterm"][0], launches["after"]["straight"][0])


@pytest.mark.parametrize("writer", ["single", "reference", "mesh"])
def test_checkpoints_cross_between_one_device_and_the_mesh(launches, writer):
    """A step written by the single-device launcher or the reference's
    manager, restored and placed on the mesh and written again, is the same
    leaf for leaf; and a mesh checkpoint restored on one device likewise."""
    before, extra = launches["before"][writer]
    after, extra_after = launches["after"][writer]
    assert extra == extra_after
    _assert_bitwise(after, before)
    if writer != "mesh":
        assert f"resumed from step {extra['step']}" in launches[f"{writer}2"][0]["log"]
