"""Deterministic, restartable token pipelines (port of
``repro.data.pipeline``).

Two sources, each yielding {"tokens", "labels", "mask"} as numpy arrays
with next-token alignment, and ``state()``/``restore()`` for an exact
resume after preemption:

* ``SyntheticLM``: an endless pseudo-corpus from a counter-based hash, so
  batch i is a pure function of (seed, i) and the pipeline's state is one
  integer. The reference draws with ``jax.random.randint`` and the port
  imports no JAX, so the port draws from its own hash (murmur3, the
  ``fold_seeds``/``counter_hash`` of the Gaussian sketch). It keeps the
  reference's contract, not its values: tokens in [0, vocab), every fourth
  token a copy of the one before it (``[:, 3::4] = [:, 2::4]``, structure a
  tiny model can learn), labels the tokens shifted by one, the mask all
  ones. As with ``models.init_params``, a run of the port's launcher is not
  the reference's run value for value.
* ``MemmapCorpus``: a flat uint16/uint32 token file cut into seq_len + 1
  windows, shuffled by a seeded permutation per epoch. It is numpy only,
  as the reference's is, and gives the reference's batches bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.gaussian_gram import counter_hash, fold_seeds


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    step: int = 0

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, st: dict):
        self.step = int(st["step"])

    def __iter__(self):
        return self

    def __next__(self):
        # counter-based: batch i is a pure function of (seed, i); the
        # uint32 word w maps to ⌊w·vocab / 2³²⌋, uniform in [0, vocab)
        key = fold_seeds(torch.tensor([self.seed], dtype=torch.int64), self.step)
        ctr = torch.arange(self.batch * (self.seq_len + 1), dtype=torch.int64)
        words = counter_hash(key, ctr)[0].reshape(self.batch, self.seq_len + 1)
        toks = ((words * self.vocab) >> 32).numpy().astype(np.int32)
        toks[:, 3::4] = toks[:, 2::4]
        self.step += 1
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((self.batch, self.seq_len), np.float32),
        }


@dataclasses.dataclass
class MemmapCorpus:
    path: str
    batch: int
    seq_len: int
    dtype: str = "uint16"
    seed: int = 0
    shard_index: int = 0     # this host's shard
    num_shards: int = 1
    step: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n_windows = (len(self._data) - 1) // self.seq_len
        if self._n_windows < self.batch:
            raise ValueError("corpus too small for one batch")

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, st: dict):
        self.step = int(st["step"])

    def _window(self, idx: int) -> np.ndarray:
        s = idx * self.seq_len
        return np.asarray(self._data[s: s + self.seq_len + 1], np.int32)

    def __iter__(self):
        return self

    def __next__(self):
        per_step = self.batch * self.num_shards
        epoch = (self.step * per_step) // self._n_windows
        rng = np.random.default_rng(self.seed + epoch)
        perm = rng.permutation(self._n_windows)
        base = (self.step * per_step) % self._n_windows
        idxs = [
            perm[(base + self.shard_index * self.batch + j) % self._n_windows]
            for j in range(self.batch)
        ]
        t = np.stack([self._window(i) for i in idxs])
        self.step += 1
        return {
            "tokens": t[:, :-1],
            "labels": t[:, 1:],
            "mask": np.ones((self.batch, self.seq_len), np.float32),
        }
