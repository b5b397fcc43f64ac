"""K1b (``csrc/roi_pool3d_bwd.cu``, its column and brick passes): the
least time of the window's calls by their bytes
(``counts/bounds.py::k1b_bytes``) over K1b's device time in the trace."""

from portbench import harness
from portbench.counts import bounds

KERNELS = ("roi_pool3d_bwd_columns", "roi_pool3d_bwd_bricks")


def read(ctx):
    calls = ctx["calls"].get("k1b", [])
    if ctx["trace"] is None or not calls:
        return None
    t = harness.kernel_seconds(ctx["trace"], KERNELS)
    if t <= 0:
        return None
    return 100.0 * sum(bounds.seconds(bounds.k1b_bytes(c)) for c in calls) / t
