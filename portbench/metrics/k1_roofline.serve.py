"""K1 (``csrc/roi_pool3d.cu``): the least time of the window's calls by
their bytes (``counts/bounds.py::k1_bytes``: the voxels their rois cover,
the rois, the pooled output) over K1's device time in the trace."""

from portbench import harness
from portbench.counts import bounds

KERNELS = ("roi_pool3d_kernel",)


def read(ctx):
    calls = ctx["calls"].get("k1", [])
    if ctx["trace"] is None or not calls:
        return None
    t = harness.kernel_seconds(ctx["trace"], KERNELS)
    if t <= 0:
        return None
    return 100.0 * sum(bounds.seconds(bounds.k1_bytes(c)) for c in calls) / t
