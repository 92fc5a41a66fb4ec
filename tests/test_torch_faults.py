"""The chaos suite on the port, on the CPU: the counterparts of
``tests/test_faults.py`` and of ``tests/test_preemption.py``'s shard-loss
cases. Every fault case runs the JAX reference and the port on the same
numpy inputs (the reference's seeds handed over as ``_uint32_seeds(keys)``)
and the port must give the reference's status vector. Within the port, the
failure model's four invariants hold:

1. isolation: the faulty slot is not OK, and its neighbours equal a clean
   batch's answers (bitwise where the guards are lanewise, else to 1e-6);
2. bounded retries: never more than ``max_retries`` redraws;
3. truthful flags: ``fell_back`` iff FELL_BACK, ``converged`` iff OK or
   RETRIED;
4. finite answers: every returned x is finite.

Retries redraw the sketch by ``fold_seeds(seed, attempt)`` in the port and
``fold_in(key, attempt)`` in the reference, so a retried slot's x is not
compared across the packages, only its status.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive_padded as jap  # noqa: E402
from repro.core import robust as jrb  # noqa: E402
from repro.core.distributed import ShardLadderCache as JShardLadderCache  # noqa: E402
from repro.core.level_grams import BlockEmulationProvider as JBlock  # noqa: E402
from repro.core.level_grams import _uint32_seeds  # noqa: E402
from repro.core.quadratic import from_least_squares_batch as j_flsb  # noqa: E402
from repro.ft import faults as jft  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import adaptive_padded as tap  # noqa: E402
from repro_torch.core import robust as trb  # noqa: E402
from repro_torch.core.distributed import ShardLadderCache  # noqa: E402
from repro_torch.core.level_grams import (  # noqa: E402
    BlockEmulationProvider,
    fold_seeds,
    shard_quadratics,
)
from repro_torch.core.quadratic import direct_solve  # noqa: E402
from repro_torch.core.quadratic import from_least_squares_batch as t_flsb  # noqa: E402
from repro_torch.core.status import ENGINE_FAILURES, SolveStatus  # noqa: E402
from repro_torch.ft import faults as tft  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)

B, N, D, M_MAX = 4, 128, 16, 32
NEIGHBOR_TOL = 1e-6
OK, RETRIED, FELL_BACK = (int(SolveStatus.OK), int(SolveStatus.RETRIED),
                          int(SolveStatus.FELL_BACK))


@pytest.fixture(scope="module")
def clean():
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((B, N, D)) / np.sqrt(N)).astype(np.float32)
    Y = rng.standard_normal((B, N)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(42), B)
    seeds = torch.as_tensor(np.asarray(_uint32_seeds(keys)).astype(np.int64))
    qt = t_flsb(torch.as_tensor(A), torch.as_tensor(Y), 0.1)
    x_ref, s_ref = trb.robust_padded_solve_batched(qt, seeds, m_max=M_MAX, tol=1e-10,
                                                   device="cpu")
    return {"A": A, "Y": Y, "keys": keys, "seeds": seeds, "qt": qt,
            "x_ref": x_ref, "s_ref": s_ref}


def _both(A, Y, nu, clean, **kw):
    """The reference's and the port's robust solve of the same inputs:
    (reference status vector, port x, port stats). ``j_sketch`` /
    ``t_sketch`` are each package's sketch argument."""
    j_sketch, t_sketch = kw.pop("j_sketch", "gaussian"), kw.pop("t_sketch", "gaussian")
    kw = {"m_max": M_MAX, "tol": 1e-10, **kw}
    _, sj = jrb.robust_padded_solve_batched(j_flsb(jnp.asarray(A), jnp.asarray(Y), nu),
                                            clean["keys"], sketch=j_sketch, **kw)
    x, s = trb.robust_padded_solve_batched(
        t_flsb(torch.as_tensor(A), torch.as_tensor(Y), nu), clean["seeds"],
        sketch=t_sketch, device="cpu", **kw)
    return np.asarray(sj["status"]), x, s


def _assert_invariants(x, s, faulty, clean, *, max_retries=2, bitwise=True):
    status = s["status"].numpy()
    nb = np.setdiff1d(np.arange(B), np.atleast_1d(faulty))
    for i in np.atleast_1d(faulty):
        assert status[i] != OK, status
    gap = float((x[nb] - clean["x_ref"][nb]).abs().max())
    assert gap <= NEIGHBOR_TOL, gap
    if bitwise:
        assert torch.equal(x[nb], clean["x_ref"][nb])
    assert np.all(status[nb] == OK)
    assert bool((s["retries"] <= max_retries).all())
    assert torch.equal(s["fell_back"], s["status"] == FELL_BACK)
    assert torch.equal(s["converged"], (s["status"] == OK) | (s["status"] == RETRIED))
    assert bool(torch.isfinite(x).all())


# -- data faults -------------------------------------------------------------------

def test_injectors_copy_and_poison_one_entry():
    A = torch.zeros((3, 5, 2))
    Y = torch.zeros((3, 5))
    A2, Y2 = tft.inject_nan_row(A, 1, row=3), tft.inject_inf_entry(Y, 2, idx=4, sign=-1.0)
    assert not torch.isnan(A).any() and not torch.isinf(Y).any()
    assert torch.isnan(A2).sum() == 2 and bool(torch.isnan(A2[1, 3]).all())
    assert torch.isinf(Y2).sum() == 1 and float(Y2[2, 4]) == float("-inf")
    # the same entries as the reference's injectors
    np.testing.assert_array_equal(
        np.isnan(A2.numpy()), np.isnan(np.asarray(jft.inject_nan_row(jnp.zeros((3, 5, 2)),
                                                                      1, row=3))))


def test_nan_row_isolated(clean):
    """A NaN feature row poisons exactly its slot: NAN_POISONED after both
    redraws, the (equally NaN) fallback truthfully not adopted."""
    A = tft.inject_nan_row(torch.as_tensor(clean["A"]), problem=1, row=3).numpy()
    sj, x, s = _both(A, clean["Y"], 0.1, clean)
    np.testing.assert_array_equal(s["status"].numpy(), sj)
    _assert_invariants(x, s, [1], clean)
    assert int(s["status"][1]) == int(SolveStatus.NAN_POISONED)
    assert not bool(s["fell_back"][1]) and int(s["retries"][1]) == 2


def test_inf_target_isolated(clean):
    Y = tft.inject_inf_entry(torch.as_tensor(clean["Y"]), problem=2, idx=0).numpy()
    sj, x, s = _both(clean["A"], Y, 0.1, clean)
    np.testing.assert_array_equal(s["status"].numpy(), sj)
    _assert_invariants(x, s, [2], clean)
    assert int(s["status"][2]) == int(SolveStatus.NAN_POISONED)


def test_rank_deficient_reported_not_poisoned(clean):
    """Rank 5 with ν = 1e-8: no ladder level factorizes (LEVEL_INVALID), the
    singular dense oracle declines truthfully, the neighbours solve."""
    A = clean["A"].copy()
    A[2] = np.asarray(jft.rank_deficient_matrix(jax.random.PRNGKey(9), N, D, rank=5))
    sj, x, s = _both(A, clean["Y"], 1e-8, clean)
    np.testing.assert_array_equal(s["status"].numpy(), sj)
    assert int(s["status"][2]) == int(SolveStatus.LEVEL_INVALID)
    assert not bool(s["fell_back"][2]) and bool(torch.isfinite(x).all())
    xd = direct_solve(t_flsb(torch.as_tensor(A), torch.as_tensor(clean["Y"]), 1e-8))
    for i in (0, 1, 3):
        assert int(s["status"][i]) == OK
        assert float((x[i] - xd[i]).abs().max()) < 1e-3


def test_ill_conditioned_isolated(clean):
    """κ(A) ≈ 1e10 (beyond fp32): an honest failure or fallback, never a
    converged garbage answer; the neighbours untouched."""
    A = clean["A"].copy()
    A[2] = np.asarray(jft.ill_conditioned_matrix(jax.random.PRNGKey(11), N, D, 1e10))
    sj, x, s = _both(A, clean["Y"], 1e-4, clean, max_iters=40)
    np.testing.assert_array_equal(s["status"].numpy(), sj)
    assert int(s["status"][2]) in {int(c) for c in ENGINE_FAILURES} | {FELL_BACK}
    assert bool(torch.isfinite(x).all())
    assert np.all(s["status"].numpy()[[0, 1, 3]] == OK)


def test_stall_retry_then_fallback(clean):
    """An unreachable tolerance stalls every slot; after one redraw the
    dense fallback answers with FELL_BACK and a withdrawn (NaN) δ̃; with no
    fallback the verdict stays STALLED, x finite."""
    sj, x, s = _both(clean["A"], clean["Y"], 0.1, clean, tol=0.0, max_iters=10,
                     max_retries=1)
    np.testing.assert_array_equal(s["status"].numpy(), sj)
    assert bool((s["status"] == FELL_BACK).all()) and bool((s["retries"] == 1).all())
    assert bool(torch.isnan(s["dtilde"]).all())
    assert float((x - direct_solve(clean["qt"])).abs().max()) < 1e-5
    x2, s2 = trb.robust_padded_solve_batched(clean["qt"], clean["seeds"], m_max=M_MAX,
                                             tol=0.0, max_iters=10, max_retries=1,
                                             fallback=False, device="cpu")
    assert bool((s2["status"] == int(SolveStatus.STALLED)).all())
    assert bool(s2["stalled"].all()) and bool(torch.isfinite(x2).all())


def test_fault_factories():
    """The port's factories draw from a torch.Generator: exact rank, and
    singular values log-spaced from 1 down to 1/cond (fp32 resolves the
    top of the range)."""
    g = torch.Generator().manual_seed(0)
    R = tft.rank_deficient_matrix(g, 64, 12, rank=5)
    assert R.shape == (64, 12) and int(torch.linalg.matrix_rank(R, rtol=1e-4)) == 5
    with pytest.raises(ValueError):
        tft.rank_deficient_matrix(g, 64, 12, rank=12)
    M = tft.ill_conditioned_matrix(g, 64, 12, cond=1e4)
    sv = torch.linalg.svdvals(M.double())
    np.testing.assert_allclose(sv.numpy(), np.logspace(0, -4, 12), rtol=1e-3)


# -- sketch faults -----------------------------------------------------------------

def test_adversarial_seed_retry_recovers(clean):
    """A black-listed seed poisons exactly its slot's sketch; the redraw
    escapes the list, so the slot comes back RETRIED after one retry and
    the neighbours ride the first draw bitwise."""
    sj, x, s = _both(clean["A"], clean["Y"], 0.1, clean,
                     j_sketch=jft.AdversarialKeyProvider("gaussian", clean["keys"][1]),
                     t_sketch=tft.AdversarialKeyProvider("gaussian", clean["seeds"][1]))
    np.testing.assert_array_equal(s["status"].numpy(), sj)
    _assert_invariants(x, s, [1], clean)
    assert int(s["status"][1]) == RETRIED and int(s["retries"][1]) == 1
    assert float((x[1] - direct_solve(clean["qt"])[1]).abs().max()) < 1e-4


def test_adversarial_seed_engine_verdict(clean):
    """Without the retry driver the poisoned slot ends in the engine as
    NAN_POISONED at its best finite iterate, as in the reference."""
    _, sj = jap.padded_adaptive_solve_batched(
        j_flsb(jnp.asarray(clean["A"]), jnp.asarray(clean["Y"]), 0.1), clean["keys"],
        m_max=M_MAX, tol=1e-10,
        sketch=jft.AdversarialKeyProvider("gaussian", clean["keys"][1]))
    x, s = tap.padded_adaptive_solve_batched(
        clean["qt"], clean["seeds"], m_max=M_MAX, tol=1e-10, device="cpu",
        sketch=tft.AdversarialKeyProvider("gaussian", clean["seeds"][1]))
    np.testing.assert_array_equal(s["status"].numpy(), np.asarray(sj["status"]))
    assert int(s["status"][1]) == int(SolveStatus.NAN_POISONED)
    assert bool(torch.isfinite(x).all())


@pytest.mark.parametrize("family", ["gaussian", "sjlt", "srht"])
@pytest.mark.parametrize("compute_dtype", ["fp32", "bf16", "int8"])
def test_nan_isolated_per_sketch_leg(family, compute_dtype):
    """Each sketch pass on the CPU (the kernels' plain versions): a NaN in
    one problem's A, row weight or FWHT row scale makes that problem's
    output non-finite and leaves every other problem's output bitwise a
    clean pass's (the card's counterpart is in ``test_torch_cuda.py``)."""
    Bk, n, d, m = 3, 64, 8, 16
    g = torch.Generator().manual_seed(5)
    A = torch.randn((Bk, n, d), generator=g)
    seeds = torch.tensor([3, 4, 5])
    w = torch.rand((Bk, n), generator=g) + 0.5
    rows = torch.randint(0, m, (Bk, n), generator=g, dtype=torch.int32)
    signs = torch.where(torch.rand((Bk, n), generator=g) < 0.5, -1.0, 1.0)

    def run(A, w):
        if family == "gaussian":
            return ops.gaussian_sa(A, seeds, m, row_weights=w, compute_dtype=compute_dtype)
        if family == "sjlt":
            return ops.sjlt_apply_batched(A, rows, signs, m, row_weights=w,
                                          compute_dtype=compute_dtype)
        return ops.fwht_cols(A, row_scale=signs * w, compute_dtype=compute_dtype)

    clean_out = run(A, w)
    w_nan = w.clone()
    w_nan[1, 11] = float("nan")
    for bad, A_bad, w_bad in ((2, tft.inject_nan_row(A, 2, row=7), w), (1, A, w_nan)):
        out = run(A_bad, w_bad)
        assert not bool(torch.isfinite(out[bad]).all())
        keep = [i for i in range(Bk) if i != bad]
        assert torch.equal(out[keep], clean_out[keep])


# -- infrastructure faults: shard loss ---------------------------------------------

def _handed_over_shards(keys, n_shards):
    """The reference's per-shard Gaussian samples, ``_uint32_seeds(fold_in(
    keys, k))``, as the port's ``{"shards": [...]}`` sample."""
    return {"shards": [bridge.sample_from_numpy(
        {"seeds": _uint32_seeds(jax.vmap(lambda kb: jax.random.fold_in(kb, k))(keys))},
        device="cpu") for k in range(n_shards)]}


@pytest.mark.parametrize("drop", [(), (1,)])
def test_block_emulation_grams_match_reference(clean, drop):
    """Handed the reference's per-shard seeds, the port's block provider
    gives the reference's level Grams (dropped shards add nothing)."""
    ladder = tap.doubling_ladder(M_MAX)
    qj = j_flsb(jnp.asarray(clean["A"]), jnp.asarray(clean["Y"]), 0.1)
    prov_j = JBlock("gaussian", 4, drop_shards=drop)
    gj = np.asarray(prov_j.level_grams(prov_j.sample(clean["keys"], M_MAX, N, jnp.float32),
                                       qj, ladder))
    prov = BlockEmulationProvider("gaussian", 4, drop_shards=drop)
    assert prov.name == prov_j.name
    gt = prov.level_grams(_handed_over_shards(clean["keys"], 4), clean["qt"], ladder)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4, atol=1e-5 * np.abs(gj).max())
    # a shard's rows reach the kernels contiguous, as the card requires
    assert all(q_k.A.is_contiguous() and q_k.n == N // 4
               for q_k in shard_quadratics(clean["qt"], 4))
    # its own sample folds the seed per shard
    own = prov.sample(clean["seeds"], M_MAX, N)
    assert torch.equal(own["shards"][3]["seeds"], fold_seeds(clean["seeds"], 3))
    with pytest.raises(ValueError):
        BlockEmulationProvider("gaussian", 4, drop_shards=(0, 1, 2, 3))


def test_shard_dropout_benign(clean):
    """Losing 1 of 4 shards of a well-spread A leaves a weaker, valid
    preconditioner: every slot converges, as in the reference."""
    sj, x, s = _both(clean["A"], clean["Y"], 0.1, clean,
                     j_sketch=jft.dropout_provider("gaussian", 4, (1,)),
                     t_sketch=tft.dropout_provider("gaussian", 4, (1,)))
    np.testing.assert_array_equal(s["status"].numpy(), sj)
    assert np.all(np.isin(s["status"].numpy(), [OK, RETRIED]))
    assert float((x - direct_solve(clean["qt"])).abs().max()) < 1e-3


def test_shard_dropout_concentrated_mass_falls_back(clean):
    """When the lost shard held the dominant rows, IHS on the survivors'
    sketch diverges; the guards stall it, redraws of the same survivors do
    not help, and the fallback answers exactly with FELL_BACK."""
    scale = np.ones(N, np.float32)
    scale[32:64] = 100.0                                 # all mass in shard 1 of 4
    A = clean["A"] * scale[None, :, None] * np.float32(0.01)
    sj, x, s = _both(A, clean["Y"], 0.05, clean, method="ihs", max_iters=20,
                     j_sketch=jft.dropout_provider("gaussian", 4, (1,)),
                     t_sketch=tft.dropout_provider("gaussian", 4, (1,)))
    np.testing.assert_array_equal(s["status"].numpy(), sj)
    assert bool((s["status"] == FELL_BACK).all()) and bool((s["retries"] <= 2).all())
    xd = direct_solve(t_flsb(torch.as_tensor(A), torch.as_tensor(clean["Y"]), 0.05))
    assert float((x - xd).abs().max()) < 1e-5


def test_shard_cache_total_matches_provider(clean):
    """The cache's total is bitwise the block provider's Grams (same seeds,
    same shard order); ``drop`` is a fresh 3-shard sum to rounding; a dead
    shard cannot die twice; the mesh build on a one-rank group is bitwise
    the one-shard emulation."""
    ladder = tap.doubling_ladder(M_MAX)
    q, seeds = clean["qt"], clean["seeds"]
    prov = BlockEmulationProvider("gaussian", 4)
    g_ref = prov.level_grams(prov.sample(seeds, M_MAX, N), q, ladder)
    cache = ShardLadderCache.from_emulation("gaussian", seeds, q, ladder, 4)
    assert cache.shard_grams.shape == (4, *g_ref.shape)
    assert torch.equal(cache.total(), g_ref)
    dropped = cache.drop(1)
    prov_drop = BlockEmulationProvider("gaussian", 4, drop_shards=(1,))
    g_drop = prov_drop.level_grams(prov_drop.sample(seeds, M_MAX, N), q, ladder)
    np.testing.assert_allclose(dropped.numpy(), g_drop.numpy(), atol=1e-5)
    assert cache.alive == {0, 2, 3}
    with pytest.raises(ValueError):
        cache.drop(1)
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
            built = ShardLadderCache.from_mesh("gaussian", seeds, q, ladder, mesh)
        finally:
            dist.destroy_process_group()
    one = ShardLadderCache.from_emulation("gaussian", seeds, q, ladder, 1)
    assert torch.equal(built.shard_grams, one.shard_grams)
    assert torch.equal(built.total(), one.total())


def test_shard_loss_mid_solve_recovers_ok(clean):
    """Shard 1 dies at segment 2: the injector hands back the survivors'
    Grams, the driver repreconditions, and every slot finishes OK with a
    finite certificate, as the reference's does on the same problem."""
    ladder = tap.doubling_ladder(M_MAX)
    kw = dict(m_max=M_MAX, method="pcg", tol=1e-10, segment_trips=4, gram_hvp=True)
    qj = j_flsb(jnp.asarray(clean["A"]), jnp.asarray(clean["Y"]), 0.1)
    cache_j = JShardLadderCache.from_emulation("gaussian", clean["keys"], qj, ladder, 4)
    _, sj = jrb.segmented_padded_solve_batched(
        qj, clean["keys"], grams=cache_j.total(),
        on_segment=jft.ShardLossInjector(cache_j, shard=1, at_segment=2), **kw)
    cache = ShardLadderCache.from_emulation("gaussian", clean["seeds"], clean["qt"], ladder, 4)
    inj = tft.ShardLossInjector(cache, shard=1, at_segment=2)
    x, s = trb.segmented_padded_solve_batched(clean["qt"], clean["seeds"], grams=cache.total(),
                                              on_segment=inj, device="cpu", **kw)
    assert inj.fired and inj.fired_at == 2 and cache.alive == {0, 2, 3}
    np.testing.assert_array_equal(s["status"].numpy(), np.asarray(sj["status"]))
    assert bool((s["status"] == OK).all()) and bool(torch.isfinite(s["dtilde"]).all())
    assert float((x - direct_solve(clean["qt"])).abs().max()) < 1e-4
