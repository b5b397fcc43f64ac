"""K3b (``csrc/fuse_views_bwd.cu``, its list and gradient passes): the
least time of the window's calls by their bytes (``counts/k3b.py``; one
call a step, on the step's batch of chunks) over K3b's device time in the
trace. None where the trace holds no K3b kernel."""

from portbench import harness
from portbench.counts import bounds, k3b

KERNELS = ("k3b_list_pass", "k3b_grad_pass")


def read(ctx):
    kind = ctx["kind"]
    batches = getattr(kind, "window_batches", None)
    if ctx["trace"] is None or not batches:
        return None
    t = harness.kernel_seconds(ctx["trace"], KERNELS)
    if t <= 0:
        return None
    train, channels = kind.train_cfg, int(ctx["cfg"]["model"]["NUM_IMAGE_CHANNELS"])
    chunk = {}  # the pool's chunks recur: each counted once
    total = 0
    for idx in batches:
        for i in (int(i) for i in idx):
            if i not in chunk:
                chunk[i] = k3b.sample_bytes(
                    kind.pool["depths"][i].to(kind.device), kind.host["poses"][i], kind.host["world_to_grid"][i],
                    kind.pool["view_valid"][i], train["INTRINSIC"], tuple(train["TPU_TILE_SIZE"]),
                    train["PROJ_DEPTH_MIN"], train["PROJ_DEPTH_MAX"], train["VOXEL_SIZE"], channels)
            total += chunk[i]
    return 100.0 * bounds.seconds(total) / t
