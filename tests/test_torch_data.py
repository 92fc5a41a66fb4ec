"""The port's token pipelines (``repro_torch.data.pipeline``) against the
JAX reference's on the CPU.

``MemmapCorpus`` is numpy in both packages: its batches must be the
reference's bit for bit, across steps, an epoch wrap, shards and a restore.
``SyntheticLM`` draws from the port's own hash (the reference's draws come
from ``jax.random``), so it is held to the reference's contract, and the
same contract checker runs on the reference's pipeline too.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data.pipeline import MemmapCorpus as JMemmapCorpus  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch.data.pipeline import MemmapCorpus, SyntheticLM  # noqa: E402


def _check_contract(cls, vocab=100, batch=3, seq_len=11, seed=3, steps=4):
    """Tokens in [0, vocab), int32; every fourth token a copy of the one
    before it; labels the tokens shifted by one; an all-ones fp32 mask;
    the state one integer, batch i a pure function of (seed, i)."""
    d = cls(vocab=vocab, batch=batch, seq_len=seq_len, seed=seed)
    seen = []
    for i in range(steps):
        assert d.state() == {"step": i}
        b = next(d)
        toks, labels, mask = b["tokens"], b["labels"], b["mask"]
        assert toks.shape == labels.shape == mask.shape == (batch, seq_len)
        assert toks.dtype == np.int32 and mask.dtype == np.float32 and (mask == 1).all()
        assert toks.min() >= 0 and toks.max() < vocab
        np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])
        full = np.concatenate([toks, labels[:, -1:]], axis=1)          # (B, S + 1)
        np.testing.assert_array_equal(full[:, 3::4], full[:, 2::4])
        seen.append(full)
    assert not np.array_equal(seen[0], seen[1])
    again = cls(vocab=vocab, batch=batch, seq_len=seq_len, seed=seed)
    again.restore({"step": 2})
    np.testing.assert_array_equal(next(again)["tokens"], seen[2][:, :-1])
    other = cls(vocab=vocab, batch=batch, seq_len=seq_len, seed=seed + 1)
    assert not np.array_equal(next(other)["tokens"], seen[0][:, :-1])


@pytest.mark.parametrize("cls", [SyntheticLM, JSyntheticLM], ids=["port", "reference"])
def test_synthetic_lm_contract(cls):
    _check_contract(cls)


def test_synthetic_data_deterministic_resume():
    """``tests/test_ft.py::test_synthetic_data_deterministic_resume`` on the
    port."""
    d1 = SyntheticLM(vocab=100, batch=2, seq_len=8, seed=3)
    [next(d1) for _ in range(5)]
    st = d1.state()
    nxt = next(d1)
    d2 = SyntheticLM(vocab=100, batch=2, seq_len=8, seed=3)
    d2.restore(st)
    np.testing.assert_array_equal(next(d2)["tokens"], nxt["tokens"])


def test_synthetic_lm_covers_the_vocab():
    """At qwen2's vocab the draws spread over [0, vocab): each tenth of the
    range holds a tenth of 16384 draws within 5 σ."""
    d = SyntheticLM(vocab=151_936, batch=16, seq_len=1023, seed=0)
    toks = next(d)["tokens"]
    counts = np.bincount(toks.ravel() * 10 // 151_936, minlength=10)
    n = toks.size
    assert np.abs(counts - n / 10).max() <= 5 * np.sqrt(n * 0.1 * 0.9), counts


@pytest.fixture()
def corpus(tmp_path):
    f = tmp_path / "toks.bin"
    (np.arange(10_000, dtype=np.uint16) % 521).tofile(f)
    return str(f)


@pytest.mark.parametrize("shard_index,num_shards", [(0, 1), (1, 3)])
def test_memmap_corpus_matches_reference_bitwise(corpus, shard_index, num_shards):
    """39 windows of 256 tokens, 4 a batch: 25 steps cross two epoch wraps
    (eight with 3 shards); a restore in the middle gives the same batches
    again."""
    kw = dict(batch=4, seq_len=256, seed=7, shard_index=shard_index, num_shards=num_shards)
    port, ref = MemmapCorpus(corpus, **kw), JMemmapCorpus(corpus, **kw)
    for i in range(25):
        if i == 14:
            st = port.state()
            assert st == ref.state() == {"step": 14}
        b, r = next(port), next(ref)
        for k in ("tokens", "labels", "mask"):
            assert b[k].dtype == r[k].dtype
            np.testing.assert_array_equal(b[k], r[k])
    port.restore(st)
    ref.restore(st)
    for _ in range(3):
        np.testing.assert_array_equal(next(port)["tokens"], next(ref)["tokens"])


def test_memmap_corpus_too_small(corpus):
    with pytest.raises(ValueError, match="too small"):
        MemmapCorpus(corpus, batch=64, seq_len=256)
