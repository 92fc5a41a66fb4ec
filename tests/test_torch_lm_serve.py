"""The port's LM serving steps, its launcher and the ridge probe against the
JAX reference on the CPU, at the reduced configs.

Reference parameters cross over through ``bridge.model_from_numpy``;
inputs are drawn with numpy from a seed; everything runs in fp32. Greedy
token ids must equal the reference's wherever every step's top-2 logit
margin exceeds 1e-3 (below that, two summation orders may pick different
argmaxes). The ring cache after a prompt shorter than its window, where
the reference's cache shrinks (ROADMAP queue 3, F2), is held to the
reference's *uncached* forward at the reference's decode bound, 2e-3.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.core import direct_solve as j_direct_solve  # noqa: E402
from repro.core import from_least_squares as j_from_least_squares  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.core import adaptive_solve  # noqa: E402
from repro_torch.core.quadratic import from_least_squares  # noqa: E402
from repro_torch.launch import ridge_probe, serve  # noqa: E402
from repro_torch.models import Transformer, init_cache, init_params  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
F32 = torch.float32
MARGIN = 1e-3


@functools.lru_cache(maxsize=None)
def _ref(arch, max_seq=64):
    cfg = jcfgs.get_config(arch).reduced()
    return cfg, jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), cfg,
                                                        max_seq=max_seq))


def _model(arch, max_seq=64):
    _, params = _ref(arch, max_seq)
    cfg = tcfgs.get_config(arch).reduced()
    return cfg, bridge.model_from_numpy(params, cfg, device="cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


@pytest.mark.parametrize("arch,S", [("gemma2-27b", 40), ("rwkv6-3b", 12)])
def test_greedy_generate_matches_reference(arch, S):
    B, new = 2, 6
    jcfg, params = _ref(arch)
    cfg, model = _model(arch)
    prompt = _tokens(cfg, B, S)
    want = np.asarray(jstep.greedy_generate(params, jcfg, jnp.asarray(prompt), new,
                                            max_seq=S + new + 1))
    got = tstep.greedy_generate(model, cfg, torch.as_tensor(prompt), new, max_seq=S + new + 1,
                                device="cpu").numpy()
    # each step's top-2 margin, from the uncached forward over prompt + ids
    seq = torch.as_tensor(np.concatenate([prompt, want[:, :-1]], axis=1))
    logits = model(seq, compute_dtype=F32)[0][:, S - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    tight = ((top2[..., 0] - top2[..., 1]) <= MARGIN).numpy()          # (B, new)
    assert got.shape == want.shape == (B, new)
    compared = 0
    for b in range(B):      # each row up to its first step that is a near tie
        clear = int(np.argmax(tight[b])) if tight[b].any() else new
        np.testing.assert_array_equal(got[b, :clear], want[b, :clear])
        compared += clear
    assert compared >= B * new // 2, tight


def test_ring_prefill_shorter_than_window_matches_uncached_forward():
    """gemma2's ring (window 32) after a 20-token prompt keeps its 32 slots,
    position p in slot p mod 32, and decode continues as the reference's
    uncached forward over the same tokens does."""
    S, extra, B = 20, 14, 2
    jcfg, params = _ref("gemma2-27b")
    cfg, model = _model("gemma2-27b")
    toks = _tokens(cfg, B, S + extra)
    ref = np.asarray(jm.forward(params, jcfg, jnp.asarray(toks), compute_dtype=jnp.float32)[0])
    cache = init_cache(cfg, B, 64, dtype=F32, device="cpu")
    lg, cache = tstep.prefill_step(model, cfg, torch.as_tensor(toks[:, :S]), cache,
                                   compute_dtype=F32, device="cpu")
    ring = cache["blocks"]["p0_local"][0]["k"]
    assert ring.shape[1] == cfg.window
    assert float(ring[:, S:].abs().max()) == 0.0            # slots 20-31 not yet written
    outs = [lg]
    for t in range(S, S + extra - 1):                       # crosses the window at 32
        lg, cache = tstep.decode_step(model, cfg, torch.as_tensor(toks[:, t:t + 1]), cache, t,
                                      compute_dtype=F32, device="cpu")
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref[:, S - 1:S + extra - 1],
                               rtol=2e-3, atol=2e-3)


def test_cache_overflow_raises():
    """A write past a full cache's end, past whisper's learned positions, or
    a multi-token write into a ring that is not empty raises (the reference
    clamps these silently; ROADMAP queue 3, F3)."""
    cfg, model = _model("qwen2-0.5b")
    toks = torch.as_tensor(_tokens(cfg, 2, 10))
    cache = init_cache(cfg, 2, 8, dtype=F32, device="cpu")
    with pytest.raises(ValueError, match="cache overflow"):
        tstep.prefill_step(model, cfg, toks, cache, compute_dtype=F32, device="cpu")
    _, cache = tstep.prefill_step(model, cfg, toks[:, :8], cache, compute_dtype=F32,
                                  device="cpu")
    with pytest.raises(ValueError, match="cache overflow"):
        tstep.decode_step(model, cfg, toks[:, 8:9], cache, 8, compute_dtype=F32, device="cpu")

    wcfg = tcfgs.get_config("whisper-small").reduced()
    whisper = Transformer(wcfg, max_seq=8, device="cpu")
    wcache = init_cache(wcfg, 2, 16, dtype=F32, device="cpu")
    with pytest.raises(ValueError, match="learned positions"):
        whisper(toks[:, :1], cache=wcache, cache_pos=8, compute_dtype=F32)

    gcfg, gemma = _model("gemma2-27b")
    gcache = init_cache(gcfg, 2, 64, dtype=F32, device="cpu")
    with pytest.raises(ValueError, match="ring cache"):
        gemma(toks[:, :4], cache=gcache, cache_pos=4, compute_dtype=F32)


def _example():
    spec = importlib.util.spec_from_file_location("ridge_probe_example",
                                                  ROOT / "examples" / "ridge_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _probe_features():
    """The example's features at its sizes (B 64, S 32), in both packages."""
    jcfg, params = _ref("qwen2-0.5b")
    cfg, model = _model("qwen2-0.5b")
    toks = _tokens(cfg, 64, 32, seed=3)
    want = np.asarray(_example().backbone_features(params, jcfg, jnp.asarray(toks)))
    got = ridge_probe.backbone_features(model, torch.as_tensor(toks)).numpy()
    return got, want


def test_probe_features_match_example():
    got, want = _probe_features()
    assert got.shape == want.shape == (64, 32, 64)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= 1e-4 * scale + 1e-5, err


def test_probe_fit_matches_reference_direct_solve():
    """The probe's adaptive PCG/SJLT fit on the example's features (fp32,
    ν = 0.3, tol 1e-9) lands within 1e-3 of the reference's direct solve and
    passes ``test_ridge_probe_pipeline``'s MSE gate."""
    _, feats = _probe_features()
    A = np.array(feats.reshape(-1, feats.shape[-1]))
    rng = np.random.default_rng(2)
    Y = (A @ (rng.standard_normal((A.shape[1], 10)) / 8)
         + 0.05 * rng.standard_normal((A.shape[0], 10))).astype(np.float32)
    W_ref = np.asarray(j_direct_solve(j_from_least_squares(jnp.asarray(A), jnp.asarray(Y),
                                                           ridge_probe.NU)))
    q = from_least_squares(torch.as_tensor(A), torch.as_tensor(Y), ridge_probe.NU)
    res = adaptive_solve(q, ridge_probe.PROBE_CONFIG, seed=4, device="cpu")
    x = res.x.numpy()
    assert np.linalg.norm(x - W_ref) <= 1e-3 * np.linalg.norm(W_ref)
    assert np.mean((A @ x - Y) ** 2) < 0.05 * np.mean(Y ** 2)
    assert res.m_final < A.shape[0]                 # a sketch, not the identity


def test_run_probe_passes_gates_on_held_out_rows():
    _, model = _model("qwen2-0.5b")
    r = ridge_probe.run_probe(model, batch=32, seq=16, device="cpu")
    assert r["features"] == (512, 64)
    assert r["rel_err"] <= 1e-3
    assert r["heldout_mse"] < 0.05 * r["heldout_base"]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "whisper-small"])
def test_serve_launcher_decodes_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--new-tokens", "4"])
    assert out.shape == (2, 4) and out.device.type == "cpu"
    assert "tok/s" in capsys.readouterr().out


def test_probe_launcher_on_cpu(capsys):
    r = ridge_probe.main(["--device", "cpu", "--reduced"])
    assert r["features"] == (2048, 64) and r["heldout_mse"] < 0.05 * r["heldout_base"]
    assert "rel_err_vs_direct" in capsys.readouterr().out


def test_lm_entry_points_need_a_card():
    """Without a card every LM entry point raises unless given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    cfg = tcfgs.get_config("qwen2-0.5b").reduced()
    g = torch.Generator()
    for call in (lambda: init_params(cfg, generator=g),
                 lambda: init_cache(cfg, 1, 4),
                 lambda: Transformer(cfg),
                 lambda: bridge.model_from_numpy(_ref("qwen2-0.5b")[1], cfg),
                 lambda: bridge.cache_from_numpy({"blocks": {}, "rem": {}}),
                 lambda: serve.main(["--arch", "qwen2-0.5b"]),
                 lambda: ridge_probe.main(["--reduced"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = init_params(cfg, generator=g, device="cpu")
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.greedy_generate(model, cfg, prompt, 2, max_seq=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ridge_probe.run_probe(model, batch=4, seq=4)
