"""The frozen yardstick at the cells' shapes, against hand-worked values."""

import pytest

from bench import roofline


def test_gaussian_terms_at_the_service_cell():
    flops, nbytes = roofline.gauss_sa_terms(64, 4096, 256, 512)
    assert flops == 2 * 64 * 512 * 4096 * 256 == 68_719_476_736
    # A (64·4096·256·4 B), SA written (64·512·256·4 B), the seeds (64·8 B)
    assert nbytes == 268_435_456 + 33_554_432 + 512
    t, what = roofline.bound_s(flops, nbytes)
    assert what == "operations"
    assert t == pytest.approx(68_719_476_736 / 67e12)          # 1.0257 ms


def test_fwht_and_sjlt_terms():
    assert roofline.fwht_terms(1, 16384, 256) == (16384 * 256 * 14.0, 8.0 * 16384 * 256)
    assert roofline.fwht_terms(2, 8, 4) == (2 * 4 * 8 * 3.0, 8.0 * 2 * 8 * 4)
    flops, nbytes = roofline.sjlt_terms(1, 16384, 7000, 4096, shared=True)
    assert flops == 2.0 * 16384 * 7000
    assert nbytes == 4 * 16384 * 7000 + 8 * 16384 + 4 * 4096 * 7000
    t, what = roofline.bound_s(flops, nbytes)
    assert what == "bytes" and t == pytest.approx(nbytes / 3.35e12)
