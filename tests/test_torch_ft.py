"""The port's checkpoint manager and preemption mechanics, on the CPU: the
counterparts of ``tests/test_ft.py``'s checkpoint, watchdog and preemption
cases, a bf16 leaf restored bitwise, and the on-disk layout shared with the
JAX package (a directory written by either restores bitwise in the
other)."""

import json
import os
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.ft import CheckpointManager as JCheckpointManager  # noqa: E402
from repro_torch.ft import (  # noqa: E402
    CheckpointManager,
    PreemptionHandler,
    StragglerWatchdog,
    run_with_restarts,
)


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16)}}


def _leaves(tree):
    return [tree["a"], tree["nested"]["b"]]


def test_checkpoint_roundtrip(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    ckpt.save(1, t, extra={"step": 1})
    restored, extra = ckpt.restore(t)
    assert extra["step"] == 1
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_bf16_leaf_bitwise(tmp_path):
    """A bf16 leaf is stored as its uint16 bits and comes back bit for bit,
    the dtype name in the manifest, as the reference writes it."""
    ckpt = CheckpointManager(tmp_path)
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((5, 7), generator=g) * 1e3).to(torch.bfloat16)
    x[0, 0], x[0, 1] = float("inf"), float("nan")
    ckpt.save(3, {"x": x})
    arr = np.load(tmp_path / "step_000000003" / "arrays" / "x.npy")
    assert arr.dtype == np.uint16
    manifest = json.loads((tmp_path / "step_000000003" / "manifest.json").read_text())
    assert manifest["leaves"]["x"]["dtype"] == "bfloat16"
    got, _ = ckpt.restore({"x": torch.zeros((5, 7), dtype=torch.bfloat16)})
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))


def test_checkpoint_keep_last_k_and_latest(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    for s in [1, 2, 3, 4]:
        ckpt.save(s, t)
    assert ckpt.all_steps() == [3, 4]
    assert ckpt.latest_step() == 4


def test_checkpoint_ignores_uncommitted(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(5, _tree())
    bad = tmp_path / "step_000000009"          # a torn write: no COMMITTED
    (bad / "arrays").mkdir(parents=True)
    (bad / "manifest.json").write_text("{}")
    assert ckpt.latest_step() == 5


def test_checkpoint_interrupted_save_restores_previous(tmp_path):
    """A save torn before its COMMITTED marker leaves the previous step the
    restore target, its data intact; a staging directory left by a kill is
    never a step; the next save recovers past both."""
    ckpt = CheckpointManager(tmp_path)
    t = _tree()
    ckpt.save(1, t, extra={"segment": 1})
    t2 = {"a": t["a"] * 7, "nested": {"b": t["nested"]["b"] * 7}}
    ckpt.save(2, t2, extra={"segment": 2})
    (tmp_path / "step_000000002" / "COMMITTED").unlink()
    assert ckpt.latest_step() == 1
    restored, extra = ckpt.restore(t)
    assert extra["segment"] == 1
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert torch.equal(a, b)
    (tmp_path / "step_000000003.tmp" / "arrays").mkdir(parents=True)
    assert ckpt.latest_step() == 1
    ckpt.save(3, t2, extra={"segment": 3})
    assert ckpt.latest_step() == 3
    assert ckpt.restore(t2)[1]["segment"] == 3


def test_checkpoint_gc_skips_uncommitted(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2):
        ckpt.save(s, _tree())
    bad = tmp_path / "step_000000005"
    (bad / "arrays").mkdir(parents=True)
    (bad / "manifest.json").write_text("{}")
    ckpt.save(6, _tree())
    assert ckpt.all_steps() == [2, 6]


def test_checkpoint_async_copies_before_the_thread(tmp_path):
    """save(blocking=False) takes its host copy in the caller's thread: a
    write to the tensor right after the call does not reach the file."""
    ckpt = CheckpointManager(tmp_path)
    t = _tree()
    ckpt.save(7, t, blocking=False)
    t["a"].fill_(-1.0)
    ckpt.wait()
    assert ckpt.latest_step() == 7
    got, _ = ckpt.restore(_tree())
    assert torch.equal(got["a"], torch.arange(12.0).reshape(3, 4))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(1, _tree())
    wrong = {"a": torch.zeros((5, 4)), "nested": {"b": torch.ones((2, 2))}}
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(wrong)


def test_checkpoint_restore_follows_like_dtype_and_device(tmp_path):
    """Restore takes each leaf to the like leaf's dtype (the reference's
    int32 counters restore into the port's int64 ones) and device."""
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(1, {"trips": torch.tensor(9, dtype=torch.int32),
                  "done": torch.tensor([True, False])})
    got, _ = ckpt.restore({"trips": torch.zeros((), dtype=torch.int64),
                           "done": torch.zeros(2, dtype=torch.bool)})
    assert got["trips"].dtype == torch.int64 and int(got["trips"]) == 9
    assert got["trips"].shape == () and got["done"].tolist() == [True, False]


def test_checkpoint_restore_keeps_like_layout(tmp_path):
    """A column-major like leaf (the engine's per-level inverses are laid
    out so) comes back with its strides, not C order."""
    ckpt = CheckpointManager(tmp_path)
    x = torch.randn((3, 4, 4)).transpose(1, 2)
    ckpt.save(1, {"pinv": x})
    got, _ = ckpt.restore({"pinv": torch.zeros((3, 4, 4)).transpose(1, 2)})
    assert got["pinv"].stride() == x.stride() and torch.equal(got["pinv"], x)


# -- the layout shared with the JAX package --------------------------------------

def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _numpy_tree():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((4, 6)).astype(np.float32),
            "level": rng.integers(0, 5, (4,)).astype(np.int32),
            "done": np.array([True, False, True, True]),
            "trips": np.array(17, dtype=np.int32),
            "nested": {"w": rng.standard_normal((3,)).astype(np.float32)}}


def test_reference_checkpoint_restores_bitwise_in_port(tmp_path):
    ref = _numpy_tree()
    tree = _map(ref, jnp.asarray)
    tree["h"] = jnp.asarray([1.5, -3.0, 1e-3], jnp.bfloat16)
    JCheckpointManager(tmp_path).save(4, tree, extra={"segment": 4, "fingerprint": "f"})
    ckpt = CheckpointManager(tmp_path)
    assert ckpt.latest_step() == 4
    like = _map(ref, torch.as_tensor)
    like["h"] = torch.zeros(3, dtype=torch.bfloat16)
    got, extra = ckpt.restore(like)
    assert extra == {"segment": 4, "fingerprint": "f"}
    for k in ("x", "level", "done", "trips"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
        assert got[k].shape == like[k].shape
    np.testing.assert_array_equal(got["nested"]["w"].numpy(), ref["nested"]["w"])
    np.testing.assert_array_equal(got["h"].view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(tree["h"]).view(np.uint16))


def test_port_checkpoint_restores_bitwise_in_reference(tmp_path):
    ref = _numpy_tree()
    tree = _map(ref, torch.as_tensor)
    tree["h"] = torch.tensor([1.5, -3.0, 1e-3], dtype=torch.bfloat16)
    CheckpointManager(tmp_path).save(2, tree, extra={"segment": 2})
    like = _map(ref, jnp.asarray)
    like["h"] = jnp.zeros((3,), jnp.bfloat16)
    got, extra = JCheckpointManager(tmp_path).restore(like)
    assert extra == {"segment": 2}
    for k in ("x", "level", "done", "trips"):
        np.testing.assert_array_equal(np.asarray(got[k]), ref[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(got["nested"]["w"]), ref["nested"]["w"])
    np.testing.assert_array_equal(np.asarray(got["h"]).view(np.uint16),
                                  tree["h"].view(torch.int16).numpy().view(np.uint16))


# -- resilience -----------------------------------------------------------------

def test_straggler_watchdog_flags():
    flagged = []
    wd = StragglerWatchdog(factor=2.0, patience=2, on_flag=lambda h, t: flagged.append(h))
    for _ in range(20):
        wd.record(0.1, host="h0")
    assert not flagged
    wd.record(0.5, host="h1")
    wd.record(0.5, host="h1")
    assert flagged == ["h1"]
    wd2 = StragglerWatchdog(factor=2.0, patience=2)   # recovery resets the count
    for _ in range(10):
        wd2.record(0.1)
    wd2.record(0.5)
    wd2.record(0.1)
    wd2.record(0.5)
    assert not wd2.flagged


def test_preemption_handler():
    with PreemptionHandler(signals=(signal.SIGUSR1,)) as p:
        assert not p.should_stop
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert p.should_stop


def test_run_with_restarts_saves_and_stops_on_preemption(tmp_path):
    """Periodic background saves, a blocking save of the preempted step,
    and a restart from it that finishes the run."""
    ckpt = CheckpointManager(tmp_path, keep=10)

    class StopAt:
        def __init__(self, step):
            self.step, self.seen = step, 0

        @property
        def should_stop(self):
            self.seen += 1
            return self.seen >= self.step

    step_fn = lambda s: {"v": s["v"] + 1}              # noqa: E731
    wd = StragglerWatchdog()
    state, last = run_with_restarts(step_fn, 10, ckpt, {"v": torch.zeros(2)},
                                    save_every=2, watchdog=wd, preempt=StopAt(5))
    assert last == 5 and ckpt.all_steps() == [2, 4, 5]
    assert len(wd._times) == 5
    restored, _ = ckpt.restore({"v": torch.zeros(2)})
    assert torch.equal(restored["v"], torch.full((2,), 5.0))
    state, last = run_with_restarts(step_fn, 10, ckpt, restored, save_every=2,
                                    start_step=5)
    assert last == 10 and torch.equal(state["v"], torch.full((2,), 10.0))
    assert ckpt.latest_step() == 10
