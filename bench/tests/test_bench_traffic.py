"""The traffic: the same pool from the same seed, the same sizes and ν from
every seed, the stated spectrum, and the order of a pool's walk."""

import itertools

import pytest
import torch

from bench import manifest, streams

ridge_pool = manifest.generator("ridge_pool")

SPEC = dict(pool=8, n=[129, 256], d=[17, 32], decay=0.9, nu=[1e-3, 1e-1])
OFFSET = dict(pool=3, n=[300, 320], d=[40, 48], decay=0.99, decay_offset=1, nu=1e-2)
BIG_SEED = 2 ** 31 + 17


@pytest.mark.parametrize("spec", [SPEC, OFFSET], ids=["pool", "offset"])
def test_same_seed_same_pool(spec):
    a, b = ridge_pool(spec, BIG_SEED, "cpu"), ridge_pool(spec, BIG_SEED, "cpu")
    assert a.nu == b.nu
    for x, y in itertools.chain(zip(a.A, b.A), zip(a.y, b.y)):
        assert torch.equal(x, y)


def test_other_seed_same_sizes_other_data():
    a, b = ridge_pool(SPEC, 1, "cpu"), ridge_pool(SPEC, 2 ** 40 + 3, "cpu")
    for k in (0, 1):        # n and d are each the same set, drawn apart
        assert sorted(x.shape[k] for x in a.A) == sorted(x.shape[k] for x in b.A)
    assert sorted(a.nu) == sorted(b.nu)
    assert [x.shape for x in a.A] != [x.shape for x in b.A]
    assert not any(torch.equal(x, y) for x, y in zip(a.y, b.y) if x.shape == y.shape)


def test_sizes_and_nu_are_stratified():
    p = ridge_pool(SPEC, 5, "cpu")
    assert sorted(x.shape[0] for x in p.A) == [137, 153, 169, 185, 201, 217, 233, 249]
    assert sorted(x.shape[1] for x in p.A) == [18, 20, 22, 24, 26, 28, 30, 32]
    nus = sorted(p.nu)
    assert nus[0] == pytest.approx(10 ** -2.875) and nus[-1] == pytest.approx(10 ** -1.125)


@pytest.mark.parametrize("spec", [SPEC, OFFSET], ids=["pool", "offset"])
def test_stated_spectrum(spec):
    p = ridge_pool(spec, 3, "cpu")
    off = spec.get("decay_offset", 0)
    for A in p.A:
        d = A.shape[1]
        want = spec["decay"] ** torch.arange(off, off + d, dtype=torch.float64)
        assert torch.allclose(torch.linalg.svdvals(A.double()), want, rtol=1e-5, atol=1e-6)


def test_order_walks_each_problem_once_a_pass():
    walk = list(itertools.islice(streams.order(8, BIG_SEED), 24))
    passes = [walk[k:k + 8] for k in (0, 8, 16)]
    assert all(sorted(p) == list(range(8)) for p in passes)
    assert passes[0] != passes[1]
    assert walk == list(itertools.islice(streams.order(8, BIG_SEED), 24))


def test_poisson_arrivals_have_the_rate_and_repeat():
    gaps = list(itertools.islice(streams.poisson(250.0, BIG_SEED), 20000))
    assert sum(gaps) / len(gaps) == pytest.approx(1 / 250.0, rel=0.03)
    assert gaps[:50] == list(itertools.islice(streams.poisson(250.0, BIG_SEED), 50))


def test_the_open_loop_times_requests_from_their_arrival():
    import dataclasses

    from bench import manifest
    from conftest import small_cell

    cell = small_cell("ridge_service_b64.wide4k")
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "rate": 20.0})
    run = manifest.entry("service").setup(cell, 9, "cpu")
    run.step(record=False)
    for _ in range(5):
        run.step()
    run.drain()
    rec = run.records
    assert run.attempted == len(run.answers) == len(rec["latencies_s"]) == sum(rec["fill"])
    assert all(0 < f <= 4 for f in rec["fill"]) and not run.queue
    # an arrival waits for its submit, then for its flush
    assert all(lat >= w for lat, w in zip(rec["latencies_s"], rec["wait_s"]))
