"""K3b's least bytes (``csrc/fuse_views_bwd.cu``, the view fusion's
gradient): what the gradient of one sample's fusion depends on, read once,
and the gradient written once, whatever implements it
(``chip_smoke.py``'s ``k3b_bound``, its bytes):

  - the cotangent rows (C float32) of the voxels that some valid view
    accepts;
  - the feature rows (C float32) of the (view, pixel) pairs that accept
    some voxel;
  - the depths (float32), each view's grid-to-camera matrix (12 float32)
    and valid flag (a byte);
  - the (V, H, W, C) float32 gradient.

Which voxels and pixels accept is the projection of the benchmark's
reference (``portbench/reference/geometry.py::fuse_views``), run on
features that hold each pixel's index: a voxel's fused value is then the
index (plus one) of the pixel it took, 0 where the view rejects it.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import geometry as G


def accepted(depths, poses, world_to_grid, view_valid, intrinsic, dims, depth_min, depth_max, voxel_size):
    """One sample's (voxels some valid view accepts, (view, pixel) pairs
    that accept some voxel): depths (V, H, W), poses (V, 4, 4),
    world_to_grid (4, 4), view_valid (V,) bool or None."""
    depths = torch.as_tensor(depths)
    v, h, w = depths.shape
    dev = depths.device
    index = (torch.arange(h * w, dtype=torch.float32, device=dev) + 1).reshape(1, h, w, 1)
    hit = torch.zeros(tuple(int(n) for n in dims), dtype=torch.bool, device=dev)
    pixels = 0
    for i in range(v):
        if view_valid is not None and not bool(view_valid[i]):
            continue
        vol = G.fuse_views(index, depths[i:i + 1], np.asarray(poses)[i:i + 1], world_to_grid, intrinsic, dims,
                           depth_min, depth_max, voxel_size)[..., 0]
        hit |= vol > 0
        pixels += int(torch.unique(vol[vol > 0]).numel())
    return int(hit.sum()), pixels


def sample_bytes(depths, poses, world_to_grid, view_valid, intrinsic, dims, depth_min, depth_max, voxel_size,
                 channels: int) -> int:
    """K3b's bytes for one sample of a batched call (the arguments of
    ``accepted``; ``channels`` the features' C)."""
    v, h, w = np.shape(depths)
    voxels, pixels = accepted(depths, poses, world_to_grid, view_valid, intrinsic, dims, depth_min, depth_max,
                              voxel_size)
    return v * h * w * channels * 4 + v * h * w * 4 + v * (12 * 4 + 1) + (voxels + pixels) * channels * 4
