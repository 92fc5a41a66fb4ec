"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (these kernels
have no CPU or interpret mode). On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py --noconftest

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card does
not need and may not have.)
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fwht as tf  # noqa: E402
from repro_torch.kernels import gaussian_gram as tg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("n,d,m", [(777, 130, 70), (256, 32, 64), (4096, 256, 512)])
def test_gaussian_sa_kernel_matches_plain(dev, shared, scaled, n, d, m):
    """Ragged tiles included. Tolerance 1e-4 of max|SA|: the sketch entries
    are the same hash and Box–Muller; fp32 sums of n products taken in two
    orders differ by about sqrt(n)·2^-24 of the result's scale."""
    B = 3
    g = torch.Generator(device=dev).manual_seed(n + d)
    A = torch.randn((n, d) if shared else (B, n, d), generator=g, device=dev)
    seeds = torch.randint(0, 2 ** 32, (B,), generator=g, device=dev, dtype=torch.int64)
    w = torch.rand((B, n), generator=g, device=dev) + 0.5 if scaled else None
    before = ops.LAUNCHES["gaussian_sa"]
    got = ops.gaussian_sa(A, seeds, m, row_weights=w)
    assert ops.LAUNCHES["gaussian_sa"] == before + 1
    want = tg.gaussian_sa_ref(A, seeds, m, scale=None if w is None else torch.sqrt(w))
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("n", [1, 8, 1024, 2048, 16384])
@pytest.mark.parametrize("d", [1, 33, 256])
@pytest.mark.parametrize("scaled", [False, True])
def test_fwht_kernel_bitwise_plain(dev, n, d, scaled):
    """The kernel's passes run the one-pass butterfly's stages in the same
    order with the same fp32 adds: bitwise equal to the plain version."""
    B = 2
    g = torch.Generator(device=dev).manual_seed(n * 7 + d)
    X = torch.randn((B, n, d), generator=g, device=dev)
    s = (torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
         if scaled else None)
    before = ops.LAUNCHES["fwht"]
    got = ops.fwht_cols(X, row_scale=s)
    assert ops.LAUNCHES["fwht"] == before + len(tf.split_plan(n))
    want = tf.fwht_ref(X if s is None else X * s[:, :, None])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fwht_kernel_shared_input(dev):
    """A shared (n, d) input is read at batch stride 0 for every problem."""
    B, n, d = 3, 4096, 20
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((n, d), generator=g, device=dev)
    s = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
    got = ops.fwht_cols(X, row_scale=s, batch=B)
    assert torch.equal(got, tf.fwht_ref(X[None] * s[:, :, None]))


def test_engine_on_card_matches_cpu(dev):
    """The padded engine on the card (through both kernels) and on the CPU
    (through the plain versions) give the same certificates: status and
    m_final equal, iters within ±2. Each x is within max(1e-4,
    2^-24·κ(H)·√k) of the fp64 solution in the energy norm, k its PCG
    iterations: the attainable accuracy of fp32 PCG, whose recursive
    residual drifts from the true one (this batch reaches κ(H) ≈ 2.5e3)."""
    from repro_torch.core.adaptive_padded import padded_adaptive_solve_batched
    from repro_torch.core.quadratic import from_least_squares_batch

    B, n, d = 4, 2048, 64
    g = torch.Generator().manual_seed(0)
    U, _ = torch.linalg.qr(torch.randn((B, n, d), generator=g))
    V, _ = torch.linalg.qr(torch.randn((B, d, d), generator=g))
    A = (U * (0.9 ** torch.arange(d))[None, None, :]) @ V.transpose(1, 2)
    Y = torch.randn((B, n), generator=g)
    nus = torch.tensor([0.3, 0.1, 0.05, 0.02])
    seeds = torch.tensor([1, 2, 3, 4], dtype=torch.int64)
    A64 = A.double()
    H = A64.transpose(1, 2) @ A64 + torch.diag_embed(
        (nus.double() ** 2)[:, None].expand(B, d))
    x64 = torch.linalg.solve(H, (A64.transpose(1, 2) @ Y.double()[:, :, None]))[..., 0]
    ev = torch.linalg.eigvalsh(H)
    kappa = ev[:, -1] / ev[:, 0]
    for sketch in ("gaussian", "srht"):
        out = {}
        for where in ("cpu", "cuda"):
            q = from_least_squares_batch(A.to(where), Y.to(where), nus.to(where))
            x, st = padded_adaptive_solve_batched(
                q, seeds.to(where), m_max=128, method="pcg", sketch=sketch,
                max_iters=100, device=where)
            k = st["iters"].cpu().clamp(min=1).double()
            tol = torch.clamp(2.0 ** -24 * kappa * k.sqrt(), min=1e-4)
            e = x.cpu().double() - x64
            err = torch.sqrt(torch.einsum("bi,bij,bj->b", e, H, e)
                             / torch.einsum("bi,bij,bj->b", x64, H, x64))
            assert bool((err <= tol).all()), (sketch, where, err, tol)
            out[where] = {k: v.cpu() for k, v in st.items()}
        for k in ("status", "m_final"):
            assert torch.equal(out["cuda"][k], out["cpu"][k]), (sketch, k)
        assert int((out["cuda"]["iters"] - out["cpu"]["iters"]).abs().max()) <= 2
