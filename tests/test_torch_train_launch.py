"""The port's training launcher (``repro_torch.launch.train``), its
checkpoints and ``serve --ckpt-dir`` on the CPU, against the JAX reference
where the two meet: the checkpoint's leaf paths, a directory written by
either package restored by the other, and greedy ids served from either
package's checkpoint.

The port's seeded parameters and ``SyntheticLM`` draws are its own (not
JAX's), so a run of the port's launcher is compared with runs of the
port's launcher: a resume (after a second launch, or after a SIGTERM sent
to a subprocess) must end bitwise where the uninterrupted run ends. Every
launcher here runs on one thread (``OMP_NUM_THREADS=1`` in a subprocess),
so that the runs sum in one order.
"""

import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.ft import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.ft.checkpoint import _flatten as j_flatten  # noqa: E402
from repro.serve import step as jserve  # noqa: E402
from repro.train import init_opt_state as j_init_opt_state  # noqa: E402
from repro.train.optimizer import OptState as JOptState  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.ft import CheckpointManager  # noqa: E402
from repro_torch.ft.checkpoint import _flatten  # noqa: E402
from repro_torch.launch import serve, serve_batch, train, train_lm  # noqa: E402
from repro_torch.models import Transformer, init_params  # noqa: E402
from repro_torch.train import init_opt_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH, SEQ = "qwen2-0.5b", 32
FLAGS = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", str(SEQ), "--save-every", "10",
         "--log-every", "100", "--device", "cpu"]
MARGIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return jcfgs.get_config(ARCH).reduced(), tcfgs.get_config(ARCH).reduced()


def _launch(ckpt_dir, steps, *extra):
    train.main(FLAGS + ["--steps", str(steps), "--ckpt-dir", str(ckpt_dir), *extra])


def _leaves(ckpt_dir, step=None):
    """Every leaf of a committed step, read through the port's manager into
    the launcher's tree: {path: numpy}."""
    _, cfg = _cfgs()
    model = Transformer(cfg, max_seq=SEQ, device="cpu")
    tree, extra = CheckpointManager(ckpt_dir).restore(
        bridge.train_tree(model, init_opt_state(model)), step=step)
    return {k: v.numpy() for k, v in _flatten(tree).items()}, extra


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """30 steps in one launch: its step-30 leaves."""
    d = tmp_path_factory.mktemp("straight")
    _launch(d, 30)
    return _leaves(d)


def test_checkpoint_paths_are_the_references():
    """The port's training tree flattens to the leaf paths the reference's
    ``(params, init_opt_state(params))`` does (``0/…``, ``1/.mu/…``,
    ``1/.nu/…``, ``1/.step``), and ``(params, None)`` to the ``0/…`` ones."""
    jcfg, cfg = _cfgs()
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg, max_seq=SEQ)
    model = Transformer(cfg, max_seq=SEQ, device="cpu")
    tree = bridge.train_tree(model, init_opt_state(model))
    want = j_flatten((jparams, j_init_opt_state(jparams)))
    got = _flatten(tree)
    assert list(got) == list(want)
    assert {"0/embed", "1/.mu/embed", "1/.nu/embed", "1/.step"} <= set(got)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
    assert list(_flatten((tree[0], None))) == list(j_flatten((jparams, None)))


def test_train_launcher_resume(tmp_path, capsys):
    """``tests/test_ft.py::test_train_launcher_resume`` on the port: train 20
    steps, stop, resume to 30."""
    ckpt_dir = tmp_path / "ck"
    _launch(ckpt_dir, 20)
    _launch(ckpt_dir, 30)
    assert CheckpointManager(ckpt_dir).latest_step() == 30
    out = capsys.readouterr().out
    assert "resumed from step 20" in out and out.count("training complete") == 2


def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, uninterrupted):
    """20 steps, then a second launch to 30: every leaf of step 30 (the
    parameters, both moments and the step) is the uninterrupted run's."""
    _launch(tmp_path, 20)
    _launch(tmp_path, 30)
    got, extra = _leaves(tmp_path)
    assert extra == {"step": 30, "data": {"step": 30}}
    _assert_bitwise(got, uninterrupted[0])
    assert int(got["1/.step"]) == 30


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def test_sigterm_commits_the_current_step_and_resumes_bitwise(tmp_path, uninterrupted):
    """SIGTERM to a launcher subprocess once it logs step 10: it commits the
    step it is at when the signal lands (10, or a later one if step 10's
    check ran before the signal arrived), returns, and a second launch from
    there ends bitwise as the uninterrupted run."""
    cmd = [sys.executable, "-u", "-m", "repro_torch.launch.train", *FLAGS,
           "--steps", "30", "--ckpt-dir", str(tmp_path), "--log-every", "1"]
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=_env(), cwd=str(ROOT))
    watchdog = threading.Timer(120, p.kill)      # a hung child ends the read
    watchdog.start()
    sent = False
    try:
        for line in p.stdout:
            if line.startswith("step    10 "):
                p.send_signal(signal.SIGTERM)
                sent = True
                break
        out, err = p.communicate(timeout=120)
    finally:
        watchdog.cancel()
        p.kill()
    assert sent and p.returncode == 0, err[-3000:]
    assert "preemption requested" in out and "training complete" not in out
    committed = CheckpointManager(tmp_path).latest_step()
    assert 10 <= committed < 30, out
    _, extra = _leaves(tmp_path)
    assert extra == {"step": committed, "data": {"step": committed}}
    _launch(tmp_path, 30)
    _assert_bitwise(_leaves(tmp_path)[0], uninterrupted[0])


def _reference_state(seed=2):
    """The reference's parameters and an AdamW state at step 5, with nonzero
    moments, as numpy."""
    jcfg, _ = _cfgs()
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), jcfg, max_seq=SEQ))
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda p: (1e-3 * rng.standard_normal(p.shape)).astype(np.float32), params)
    nu = jax.tree.map(lambda p: (1e-6 * rng.random(p.shape)).astype(np.float32), params)
    return params, JOptState(mu=mu, nu=nu, step=np.asarray(5, np.int32))


def test_reference_checkpoint_restores_into_the_port_and_continues(tmp_path, capsys):
    params, opt = _reference_state()
    JCheckpointManager(tmp_path).save(5, (params, opt), extra={"step": 5, "data": {"step": 5}})
    got, extra = _leaves(tmp_path)
    want = {k: np.asarray(v) for k, v in j_flatten((params, opt)).items()}
    _assert_bitwise(got, want)
    _launch(tmp_path, 8)
    assert "resumed from step 5" in capsys.readouterr().out
    assert CheckpointManager(tmp_path).latest_step() == 8
    after, _ = _leaves(tmp_path)
    assert int(after["1/.step"]) == 8 and not np.array_equal(after["0/embed"], want["0/embed"])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    _launch(tmp_path, 3)
    got, _ = _leaves(tmp_path)
    jcfg, _ = _cfgs()
    like = jm.init_params(jax.random.PRNGKey(1), jcfg, max_seq=SEQ)
    (jparams, jopt), extra = JCheckpointManager(tmp_path).restore((like, j_init_opt_state(like)))
    assert extra["step"] == 3 and int(jopt.step) == 3
    _assert_bitwise({k: np.asarray(v) for k, v in j_flatten((jparams, jopt)).items()}, got)


def _served_prompts(cfg, B, P, max_seq):
    """The prompts ``serve`` draws: after the seeded parameters, from the
    same generator."""
    g = torch.Generator().manual_seed(0)
    init_params(cfg, generator=g, device="cpu", max_seq=max_seq)
    return torch.randint(0, cfg.vocab, (B, P), generator=g)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_serve_ckpt_dir_decodes_the_restored_model(tmp_path, writer, capsys):
    """``serve --ckpt-dir --device cpu`` from either package's training
    checkpoint gives the reference's greedy ids for the parameters the
    reference restores from it, wherever every step's top-2 margin exceeds
    1e-3 (as phase 10 of chip_smoke.py holds them)."""
    if writer == "port":
        _launch(tmp_path, 3)
    else:
        params, opt = _reference_state()
        JCheckpointManager(tmp_path).save(5, (params, opt), extra={"step": 5})
    B, P, new = 2, 8, 4
    ids = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", str(B), "--prompt-len",
                      str(P), "--new-tokens", str(new), "--ckpt-dir", str(tmp_path)])
    assert "restored the parameters of training step" in capsys.readouterr().out
    jcfg, cfg = _cfgs()
    like = jm.init_params(jax.random.PRNGKey(1), jcfg, max_seq=P + new + 1)
    (jparams, _), _ = JCheckpointManager(tmp_path).restore((like, None))
    prompts = _served_prompts(cfg, B, P, P + new + 1)
    want = np.asarray(jserve.greedy_generate(jparams, jcfg, jnp.asarray(prompts.numpy()), new,
                                             max_seq=P + new + 1))
    model = bridge.model_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    seq = torch.cat([prompts, torch.as_tensor(np.array(want[:, :-1]))], dim=1)
    with torch.no_grad():
        logits = model(seq, compute_dtype=torch.float32)[0][:, P - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    tight = ((top2[..., 0] - top2[..., 1]) <= MARGIN).numpy()
    compared = 0
    for b in range(B):          # each row up to its first near tie
        clear = int(np.argmax(tight[b])) if tight[b].any() else new
        np.testing.assert_array_equal(ids[b, :clear].numpy(), want[b, :clear])
        compared += clear
    assert compared >= B * new // 2, tight


def test_train_lm_and_serve_batch_legs_on_cpu(tmp_path, capsys):
    train_lm.main(["--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
                   "--device", "cpu"])
    out = serve_batch.main(["--arch", "rwkv6-3b", "--batch", "2", "--prompt-len", "8",
                            "--new-tokens", "3", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "qwen2-100m" in text and "done; final loss" in text
    assert out.shape == (2, 3)


def test_training_entry_points_need_a_card(tmp_path):
    """Without a card every training entry point raises unless given the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for call in (lambda: train.main(["--reduced", "--steps", "1"]),
                 lambda: train_lm.main(["--steps", "1", "--ckpt-dir", str(tmp_path)]),
                 lambda: serve_batch.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
