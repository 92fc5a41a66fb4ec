"""gaussian_sa_roofline: the Gaussian sketch kernel's share of its roofline,
in %: the least time of one launch at the window's shape
(``bench.roofline.gauss_sa_terms`` at the fp32 data-sheet peak) over the
mean device time of its launches in the traced slice. Every launch of a
service whose answers all fell in one Gaussian class has that class's
(batch, n, d, m_max) shape, retries included."""

from bench import roofline
from bench.readers import mean


def read(ctx):
    shape = ctx.records.get("gaussian_sa_shape")
    if ctx.trace is None or shape is None:
        return None
    times = [t for name, ts in ctx.trace.kernels.items() if "gaussian_sa_" in name
             for t in ts]
    if not times:
        return None
    bound, _ = roofline.bound_s(*roofline.gauss_sa_terms(*shape))
    return 100.0 * bound / mean(times)
