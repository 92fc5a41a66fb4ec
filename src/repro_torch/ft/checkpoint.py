"""Atomic checkpoint manager with the reference's on-disk layout.

Port of ``repro.ft.checkpoint.CheckpointManager``. One directory per step::

    <dir>/step_000000042/
        manifest.json          # leaf paths, shapes, dtypes, the caller's extra
        arrays/<leafpath>.npy  # one file per leaf (host numpy)
        COMMITTED              # written last: its presence marks a valid step
    <dir>/step_000000042.tmp/  # staging; renamed into place by os.replace

A tree is dicts, tuples, NamedTuples, lists and None over tensors (a
``PaddedState._asdict()``, or a training state ``(params, OptState)``).
The layout, the leaf paths (keys joined by ``/``, which becomes ``__`` in
the file name; a NamedTuple's field is ``.field`` and a tuple's item its
index, as JAX names them) and the dtype names are the reference's, so a
directory written by either package restores in the other. A ``like``
tree of ``(params, None)`` restores the ``0/…`` leaves of a training
checkpoint alone. bfloat16 leaves, which
numpy cannot store, are written as their uint16 bits with ``"bfloat16"``
in the manifest, as the reference does, and restored with
``torch.from_numpy(...).view(torch.bfloat16)``.

* atomicity: a torn write (no COMMITTED, or a ``.tmp`` directory left by a
  kill) is never listed, so the previous committed step stays the restore
  target;
* keep-last-k GC over committed steps only;
* ``save(..., blocking=False)`` copies every leaf to host numpy first, in
  the caller's thread (a CUDA tensor's ``.cpu()`` synchronizes), and only
  then hands the write to a background thread;
* ``restore(like)`` checks every leaf's shape and puts it on ``like``'s
  device with ``like``'s dtype and memory layout (strides), so a resumed
  solve computes on operands laid out as the uninterrupted one's.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _children(tree):
    """(path key, child) pairs of a container, as JAX's
    ``tree_flatten_with_path`` names them: a dict's keys in sorted order, a
    NamedTuple's fields as ``.field``, a tuple's or list's items by index;
    None is a container with no children."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """{leaf path: tensor} of a tree of dicts, tuples, NamedTuples, lists
    and None over tensors: keys joined by ``/`` as the reference's
    ``_flatten`` gives them (``(params, OptState)`` has ``0/embed``,
    ``1/.mu/embed``, ``1/.step``)."""
    children = _children(tree)
    if children is None:
        return {prefix: tree}
    flat = {}
    for k, v in children:
        flat.update(_flatten(v, _join(prefix, k)))
    return flat


def _unflatten(like, flat: dict, prefix: str = ""):
    if like is None:
        return None
    children = _children(like)
    if children is None:
        return flat[prefix]
    values = [_unflatten(v, flat, _join(prefix, k)) for k, v in children]
    if isinstance(like, dict):
        return dict(zip([k for k, _ in children], values))
    return type(like)(*values) if hasattr(like, "_fields") else type(like)(values)


def _to_host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A private host copy of one leaf and its dtype name: later writes to
    the caller's tensor never reach it. bf16 travels as its uint16 bits."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree, *, extra: dict | None = None,
             blocking: bool = True):
        """Copy every leaf to host memory now; write now, or in a background
        thread when ``blocking=False`` (``wait`` joins it)."""
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        if blocking:
            self._write(step, host, extra or {})
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict, extra: dict):
        final = self.dir / f"step_{step:09d}"
        tmp = self.dir / f"step_{step:09d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        (tmp / "arrays").mkdir(parents=True)
        manifest = {"step": step, "extra": extra, "time": time.time(), "leaves": {},
                    "treedef": "{" + ", ".join(host) + "}"}
        for key, (arr, dtype_name) in host.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(tmp / "arrays" / fname, arr)
            manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                       "dtype": dtype_name}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        (tmp / "COMMITTED").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if p.suffix == ".tmp" or not (p / "COMMITTED").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None) -> tuple[Any, dict]:
        """Restore into the structure of ``tree_like`` (default: the latest
        committed step). Every leaf's shape must match; it comes back on the
        like leaf's device with its dtype and strides. Returns (tree,
        extra)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        root = self.dir / f"step_{step:09d}"
        manifest = json.loads((root / "manifest.json").read_text())
        out = {}
        for key, like in _flatten(tree_like).items():
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = np.load(root / "arrays" / meta["file"])
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                                 f"expected {tuple(like.shape)}")
            if meta["dtype"] == "bfloat16":      # stored as its uint16 bits
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.asarray(arr, order="C"))
            # like's layout too: on the card a batched matvec picks its
            # kernel, and so its rounding, by the operand's strides, and the
            # .npy file keeps only the values
            out[key] = torch.empty_like(like).copy_(t)
        return _unflatten(tree_like, out), manifest["extra"]
