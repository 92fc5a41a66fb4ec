"""The weighted one-touch pass and the weighted engine against the JAX
reference on the CPU, the fixed-size SRHT sketch, and a shape scan showing
that the weighted pass makes no weighted copy of A.

Row weights w ≥ 0 (B, n) turn every ladder Gram into (S_m W^{1/2}A)ᵀ(S_m
W^{1/2}A) and the true Gram into AᵀWA. The reference's samples are handed
over: the Gaussian families take its ``_uint32_seeds(keys)``, the SJLT and
the SRHT its ``jax.random`` samples through ``bridge.sample_from_numpy``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.core import adaptive_padded as jap  # noqa: E402
from repro.core import level_grams as jlg  # noqa: E402
from repro.core.quadratic import Quadratic as JQuadratic  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import adaptive_padded as tap  # noqa: E402
from repro_torch.core import level_grams as tlg  # noqa: E402
from repro_torch.core.quadratic import weighted_gram  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

torch.set_num_threads(1)

B, N, D, M_MAX = 3, 600, 16, 32
FAMILIES = ("gaussian", "gaussian_dense", "sjlt", "srht")
DTYPES = ("fp32", "bf16", "int8")
NUS = (0.3, 0.05, 0.01)
RATES = (0.7, 0.85, 0.9)


def _weights(rng, B, n):
    """Logistic-like Newton weights in (0, 1/4], a few rows dropped (w = 0)
    as huber's outliers are."""
    w = rng.uniform(0.02, 0.25, (B, n))
    w[rng.random((B, n)) < 0.05] = 0.0
    return w.astype(np.float32)


def _decay_batch(rng, B, n, d, rates):
    As = []
    for rate in rates:
        U, _ = np.linalg.qr(rng.standard_normal((n, d)))
        V, _ = np.linalg.qr(rng.standard_normal((d, d)))
        As.append((U * rate ** np.arange(1, d + 1)[None, :]) @ V.T)
    return np.stack(As).astype(np.float32)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    A = _decay_batch(rng, B, N, D, RATES)
    A_sh = A[0]
    b = rng.standard_normal((B, D)).astype(np.float32)
    w = _weights(rng, B, N)
    nus = np.asarray(NUS, np.float32)
    lam = np.ones((B, D), np.float32)
    keys = jax.random.split(jax.random.PRNGKey(17), B)
    out = {"keys": keys, "seeds": np.asarray(jlg._uint32_seeds(keys)), "w": w}
    for tag, AA in (("", A), ("_sh", A_sh)):
        out["qj" + tag] = JQuadratic(A=jnp.asarray(AA), b=jnp.asarray(b),
                                     nu=jnp.asarray(nus), lam_diag=jnp.asarray(lam),
                                     batched=True, row_weights=jnp.asarray(w))
        out["qt" + tag] = bridge.quadratic_from_numpy(AA, b, nus, lam, w, device="cpu")
    return out


def _port_sample(family, batch, m_max):
    """The port's sample dict carrying the reference's randomness."""
    if family.startswith("gaussian"):
        return {"seeds": torch.as_tensor(batch["seeds"].astype(np.int64))}
    s = jlg.get_provider(family).sample(batch["keys"], m_max, N, jnp.float32)
    return bridge.sample_from_numpy({k: np.asarray(v) for k, v in s.items()},
                                    device="cpu")


class _Handed:
    """A port provider drawing the reference's sample for the engine's seeds
    (the seeds are the reference's ``_uint32_seeds(keys)``)."""

    def __init__(self, family, batch):
        self.inner, self.family, self.batch = tlg.get_provider(family), family, batch

    def sample(self, seeds, m_max, n):
        assert np.array_equal(seeds.numpy(), self.batch["seeds"].astype(np.int64))
        return _port_sample(self.family, self.batch, m_max)

    def level_grams(self, data, q, ladder, row_weights=None, compute_dtype=None):
        return self.inner.level_grams(data, q, ladder, row_weights=row_weights,
                                      compute_dtype=compute_dtype)


def _assert_levels_close(gt, gj, rel=1e-5):
    """Every ladder level within ``rel`` of the level's largest entry."""
    gt, gj = np.asarray(gt), np.asarray(gj)
    assert gt.shape == gj.shape
    for lvl in range(gj.shape[0]):
        np.testing.assert_allclose(gt[lvl], gj[lvl], rtol=0,
                                   atol=rel * np.abs(gj[lvl]).max(), err_msg=str(lvl))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_weighted_level_grams_match_reference(batch, family, compute_dtype, shared,
                                              monkeypatch):
    """On the reference's randomness, the port's weighted ladder Grams match
    the reference's at every level, within 1e-5 of the level's largest entry
    (the same sketch entries and roundings, sums in another order).

    The Gaussian bf16 and int8 legs round each S entry to bf16, and torch's
    and XLA's log and cos put a few entries on the two sides of a rounding
    boundary (``test_torch_precision.test_gaussian_reduced_leg_matches_reference``
    bounds that gap on SA). So there the port's materialized-S provider is
    handed the reference's S entries and held to the reference, and the
    port's streamed pass to the port's materialized one, each within 1e-5."""
    tag = "_sh" if shared else ""
    ladder = jap.doubling_ladder(M_MAX)
    prov = jlg.get_provider(family)
    sample = prov.sample(batch["keys"], M_MAX, N, jnp.float32)
    gj = np.asarray(prov.level_grams(sample, batch["qj" + tag], ladder,
                                     compute_dtype=compute_dtype))
    data = _port_sample(family, batch, M_MAX)
    gt = tlg.get_provider(family).level_grams(data, batch["qt" + tag], ladder,
                                              compute_dtype=compute_dtype)
    assert gt.dtype == torch.float32
    if family.startswith("gaussian") and compute_dtype != "fp32":
        from repro.kernels.gaussian_gram import gaussian_s_dense as j_s_dense

        dense = tlg.get_provider("gaussian_dense")
        _assert_levels_close(gt, dense.level_grams(data, batch["qt" + tag], ladder,
                                                   compute_dtype=compute_dtype))
        monkeypatch.setattr(tlg, "gaussian_s_dense", lambda seeds, m, n: torch.as_tensor(
            np.array(j_s_dense(jnp.asarray(seeds.numpy().astype(np.uint32)), m, n))))
        gt = dense.level_grams(data, batch["qt" + tag], ladder, compute_dtype=compute_dtype)
    _assert_levels_close(gt, gj)


@pytest.mark.parametrize("family", FAMILIES)
def test_row_weights_argument_overrides_and_unit_weights_are_unweighted(batch, family):
    """``row_weights=`` overrides ``q.row_weights``; w ≡ 1 gives the
    unweighted Grams (w^{1/2} = 1 scales nothing, bitwise)."""
    ladder = tap.doubling_ladder(M_MAX)
    prov, data = tlg.get_provider(family), _port_sample(family, batch, M_MAX)
    q = batch["qt"]
    plain = prov.level_grams(data, q.with_row_weights(None), ladder)
    ones = prov.level_grams(data, q, ladder, row_weights=torch.ones(B, N))
    assert torch.equal(plain, ones)
    weighted = prov.level_grams(data, q.with_row_weights(None), ladder,
                                row_weights=q.row_weights)
    assert torch.equal(weighted, prov.level_grams(data, q, ladder))


def test_weighted_true_gram_matches_reference(batch):
    """The engine's weighted true Gram is AᵀWA, chunked, within 1e-6 of the
    reference's; per problem with a shared A too."""
    from repro.core.quadratic import weighted_gram as j_weighted_gram

    for tag in ("", "_sh"):
        qj, qt = batch["qj" + tag], batch["qt" + tag]
        gj = np.asarray(j_weighted_gram(qj.A, qj.row_weights))
        gt = tap._gram_precompute(qt, None)
        assert gt.shape == (B, D, D)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-6 * np.abs(gj).max())


def _x_tol(qt):
    """max(1e-4, 2^-24·κ_b) per problem: the two packages' fp32 iterates
    differ by their Cholesky rounding, which κ(H) amplifies."""
    A64 = qt.A.double() if qt.A.dim() == 3 else qt.A.double().expand(B, N, D)
    H = torch.bmm(A64.transpose(1, 2), qt.row_weights.double()[:, :, None] * A64)
    H = H + torch.diag_embed((qt.nu.double() ** 2)[:, None] * qt.lam_diag.double())
    ev = torch.linalg.eigvalsh(H)
    return np.maximum(1e-4, 2.0 ** -24 * (ev[:, -1] / ev[:, 0]).numpy())


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("family,compute_dtype", [
    ("gaussian", "fp32"), ("gaussian", "bf16"), ("gaussian", "int8"),
    ("gaussian_dense", "fp32"), ("sjlt", "fp32"), ("sjlt", "int8"), ("srht", "fp32"),
    ("srht", "bf16")])
def test_weighted_engine_matches_reference(batch, family, compute_dtype, shared):
    """A weighted batch through both engines on the same randomness, the
    port's on its own sketch pass and on the reference's Grams handed over.
    Handed the Grams, every status, m_final and doubling count is the
    reference's; on its own pass too, except where a slot sits on the knife
    edge (ROADMAP queue 3), whose m_final an ulp of its Grams moves: the
    handed run shows that this is the only difference. iters within ±2 (the
    iterates round in another order even on the same Grams); x within
    max(1e-4, 2^-24·κ_b) per problem, relative."""
    tag = "_sh" if shared else ""
    qj, qt = batch["qj" + tag], batch["qt" + tag]
    kw = dict(m_max=M_MAX, method="pcg", max_iters=100, tol=1e-10,
              compute_dtype=compute_dtype)
    xj, sj = jap.padded_adaptive_solve_batched(qj, batch["keys"], sketch=family, **kw)
    prov = jlg.get_provider(family)
    gj = np.asarray(prov.level_grams(prov.sample(batch["keys"], M_MAX, N, jnp.float32),
                                     qj, jap.doubling_ladder(M_MAX),
                                     compute_dtype=compute_dtype))
    sketch = family if family.startswith("gaussian") else _Handed(family, batch)
    seeds = torch.as_tensor(batch["seeds"].astype(np.int64))
    xt, st = tap.padded_adaptive_solve_batched(qt, seeds, sketch=sketch, device="cpu", **kw)
    xh, sh = tap.padded_adaptive_solve_batched(qt, seeds, sketch=sketch, device="cpu",
                                               grams=torch.as_tensor(gj.copy()), **kw)
    assert len(set(np.asarray(sj["m_final"]).tolist())) >= 2     # ladders differ
    np.testing.assert_array_equal(st["status"].numpy(), np.asarray(sj["status"]))
    xj = np.asarray(xj)
    for x, s in ((xt, st), (xh, sh)):
        assert np.all(np.abs(s["iters"].numpy() - np.asarray(sj["iters"])) <= 2)
        rel = np.linalg.norm(x.numpy() - xj, axis=1) / np.linalg.norm(xj, axis=1)
        assert np.all(rel <= _x_tol(qt)), (rel, _x_tol(qt))
    for k in ("status", "m_final", "doublings"):
        np.testing.assert_array_equal(sh[k].numpy(), np.asarray(sj[k]), err_msg=k)


def test_weighted_solve_agrees_with_direct_solve(batch):
    """The weighted answer is the weighted problem's: within 1e-4 of an
    fp64 solve of (AᵀWA + ν²Λ) x = b."""
    qt = batch["qt"]
    x, s = tap.padded_adaptive_solve_batched(
        qt, torch.as_tensor(batch["seeds"].astype(np.int64)), m_max=M_MAX,
        method="pcg", max_iters=200, tol=1e-12, device="cpu")
    A64 = qt.A.double()
    H = torch.bmm(A64.transpose(1, 2), qt.row_weights.double()[:, :, None] * A64)
    H = H + torch.diag_embed((qt.nu.double() ** 2)[:, None] * qt.lam_diag.double())
    x64 = torch.linalg.solve(H, qt.b.double())
    rel = torch.linalg.norm(x.double() - x64, dim=1) / torch.linalg.norm(x64, dim=1)
    assert bool((rel <= 1e-4).all()), rel


class _ShapeScan(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def _big(shapes, n_rows):
    """The outputs shaped like a stack of A: (B, n or n_pad, d)."""
    return [s for s in shapes if len(s) == 3 and s[0] == B and s[1] >= n_rows and s[2] == D]


@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_weighted_prepare_makes_no_weighted_copy_of_A(batch, family, compute_dtype):
    """``prepare_padded_solve`` of a weighted batch (n = 2048 > the true
    Gram's 1024-row chunk) makes no (B, n, d) tensor that the same prepare
    without weights does not make: the weights fold into the pass's scale
    slots and into AᵀWA chunk by chunk. The streamed Gaussian and the SJLT
    kernels' plain versions tile the pass (the Gaussian one) or fold the
    signs on one (B, n, d) product (the SJLT's index_add_ source), so the
    Gaussian pass makes none at all."""
    rng = np.random.default_rng(5)
    n = 2048
    A = rng.standard_normal((B, n, D)).astype(np.float32) / n ** 0.5
    w = _weights(rng, B, n)
    q = bridge.quadratic_from_numpy(A, np.ones((B, D), np.float32),
                                    np.full(B, 0.1, np.float32),
                                    np.ones((B, D), np.float32), w, device="cpu")
    seeds = torch.as_tensor([3, 4, 5], dtype=torch.int64)
    counts = []
    for qq in (q, q.with_row_weights(None)):
        scan = _ShapeScan()
        with scan:
            tap.prepare_padded_solve(qq, seeds, m_max=M_MAX, sketch=family,
                                     compute_dtype=compute_dtype, device="cpu")
        counts.append(len(_big(scan.shapes, n)))
    assert counts[0] == counts[1], counts
    if family == "gaussian":
        assert counts[0] == 0


def test_weighted_gram_tiles_only():
    """``weighted_gram`` forms AᵀWA from (B, chunk, d) weighted tiles only,
    equal to the dense product within fp32 rounding."""
    rng = np.random.default_rng(6)
    A = torch.as_tensor(rng.standard_normal((B, 3000, D)).astype(np.float32))
    w = torch.as_tensor(_weights(rng, B, 3000))
    scan = _ShapeScan()
    with scan:
        G = weighted_gram(A, w)
    assert not _big(scan.shapes, 1025)
    G64 = torch.bmm(A.double().transpose(1, 2), w.double()[:, :, None] * A.double())
    torch.testing.assert_close(G.double(), G64, rtol=1e-5, atol=1e-5)


# --- the fixed-size SRHT sketch ------------------------------------------------

def _reference_srht_sample(key, n, m):
    """The signs and rows ``repro.kernels.ops.srht_sketch`` draws from key."""
    n_pad = 1 << max(0, (n - 1).bit_length())
    k_sign, k_rows = jax.random.split(key)
    signs = jax.random.rademacher(k_sign, (n,), dtype=jnp.float32)
    rows = jax.random.choice(k_rows, n_pad, shape=(m,), replace=m > n_pad)
    return {"signs": torch.as_tensor(np.array(signs)),
            "rows": torch.as_tensor(np.array(rows).astype(np.int64))}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("n,m", [(600, 48), (512, 512), (100, 200)])
def test_srht_sketch_matches_reference(n, m, compute_dtype, weighted):
    """With the reference's signs and rows handed over, the port's fixed-size
    SRHT sketch equals the reference's within 1e-5 of its largest entry (the
    same FWHT; m > n_pad samples with replacement)."""
    rng = np.random.default_rng(n + m)
    A = rng.standard_normal((n, 24)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, n).astype(np.float32) if weighted else None
    key = jax.random.PRNGKey(n * 7 + m)
    want = np.asarray(jops.srht_sketch(jnp.asarray(A), key, m,
                                       row_weights=None if w is None else jnp.asarray(w),
                                       compute_dtype=compute_dtype))
    got = tops.srht_sketch(torch.as_tensor(A), None, m,
                           row_weights=None if w is None else torch.as_tensor(w),
                           compute_dtype=compute_dtype,
                           sample=_reference_srht_sample(key, n, m))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,m", [(600, 1024), (1024, 1024), (1000, 7), (3, 4)])
def test_srht_sample_without_replacement(n, m):
    """The port's own draw: m ≤ n_pad rows are distinct, in [0, n_pad); the
    signs are ±1 of length n; a seed draws the same sample twice and
    another seed another one. m > n_pad draws with replacement."""
    n_pad = 1 << max(0, (n - 1).bit_length())
    s = tops.srht_sample(torch.tensor(11), n, m)
    rows = s["rows"]
    assert rows.shape == (m,) and int(rows.min()) >= 0 and int(rows.max()) < n_pad
    if m <= n_pad:
        assert len(set(rows.tolist())) == m
    assert set(s["signs"].tolist()) <= {-1.0, 1.0} and s["signs"].shape == (n,)
    again = tops.srht_sample(torch.tensor(11), n, m)
    assert torch.equal(again["rows"], rows) and torch.equal(again["signs"], s["signs"])
    if m <= n_pad and m > 1:
        assert not torch.equal(tops.srht_sample(torch.tensor(12), n, m)["rows"], rows)


def test_srht_sketch_embeds_on_average():
    """E[SᵀS] = I: averaged over seeds, ‖S x‖² tracks ‖x‖² (the sketch's
    scale √(n_pad/m) with an unnormalized H), weighted or not."""
    rng = np.random.default_rng(2)
    n, m = 300, 64
    A = torch.as_tensor(rng.standard_normal((n, 4)).astype(np.float32))
    w = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32))
    for ww in (None, w):
        target = (A * (1.0 if ww is None else ww[:, None]) * A).sum(0)
        est = torch.stack([(tops.srht_sketch(A, s, m, row_weights=ww) ** 2).sum(0)
                           for s in range(200)]).mean(0)
        torch.testing.assert_close(est, target, rtol=0.05, atol=0.0)
