"""K3 (``csrc/fuse_views.cu``): the least time of the window's calls by
their bytes (``counts/bounds.py::k3_bytes``) over K3's device time in the
trace."""

from portbench import harness
from portbench.counts import bounds

KERNELS = ("fuse_views_kernel",)


def read(ctx):
    calls = ctx["calls"].get("k3", [])
    if ctx["trace"] is None or not calls:
        return None
    t = harness.kernel_seconds(ctx["trace"], KERNELS)
    if t <= 0:
        return None
    return 100.0 * sum(bounds.seconds(bounds.k3_bytes(c)) for c in calls) / t
