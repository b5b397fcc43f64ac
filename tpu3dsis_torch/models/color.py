"""The color stream's 2D side: ENet features (or ground-truth feature images)
back-projected into the voxel grid (``tpu3dsis/models/color.py``).

``ColorProjector`` holds the projection settings and the detector's ENet
(``None`` under ``USE_IMAGES_GT``, where the frames' images already are the
2D features). ``shift_world_to_grid``, ``frustum_bbox_grid`` and
``select_views_for_tile`` are the host-side numpy helpers of the per-tile
path, copies of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dsis_torch.config import DetectorConfig
from tpu3dsis_torch.geometry.projection import fuse_views, fuse_views_batch


class ColorProjector:
    """Normalisation, ENet and view fusion for one detector.

    ``enet`` is the detector's ``ENet2D`` (a submodule of the detector, so
    its params keep their ``enet.*`` names), or None for ``USE_IMAGES_GT``.
    """

    def __init__(self, cfg: DetectorConfig, enet):
        self.enet = enet
        self.intrinsic = np.asarray(cfg.INTRINSIC, np.float32)
        self.depth_shape = tuple(int(x) for x in cfg.DEPTH_SHAPE)  # (W, H)
        self.depth_min = float(cfg.PROJ_DEPTH_MIN)
        self.depth_max = float(cfg.PROJ_DEPTH_MAX)
        self.voxel_size = float(cfg.VOXEL_SIZE)
        self.color_mean = torch.tensor(cfg.COLOR_MEAN, dtype=torch.float32)
        self.color_std = torch.tensor(cfg.COLOR_STD, dtype=torch.float32)

    def image_features(self, images: torch.Tensor, stats=None) -> torch.Tensor:
        """(V, H, W, C_in) -> (V, Hd, Wd, C_feat), on the images' device.

        ``uint8`` images are normalised there with the fp32 ops of
        ``frames.load_color`` (/255, -mean, /std; ``models/color.py:49-52``),
        the mean and std copied from the host, or ``stats`` = (mean, std)
        already on the images' device (a captured graph cannot take the
        copy); float images are taken as already normalised. Without an
        ENet the images pass through as the features. Under autograd the
        features keep their gradient to the ENet's parameters
        (``FIX_ENET: False``).
        """
        if self.enet is None:
            return images
        if images.dtype == torch.uint8:
            mean, std = stats or (self.color_mean.to(images.device), self.color_std.to(images.device))
            images = (images.to(torch.float32) / 255.0 - mean) / std
        return self.enet.features_for_3d(images)

    def project(self, feats2d, depths, poses, world_to_grid, volume_dims, view_valid=None, zero_floor=None):
        """Fuse the views' features into one (X, Y, Z, C) volume of
        ``feats2d``'s dtype (K3 on the card, its plain version on the CPU).
        Float32 features that require a gradient get one through the fusion
        (K3b on the card), without ``zero_floor``."""
        return fuse_views(feats2d, depths, poses, world_to_grid, self.intrinsic, tuple(volume_dims),
                          self.depth_min, self.depth_max, self.voxel_size, view_valid=view_valid,
                          zero_floor=zero_floor)

    def project_batch(self, feats2d, depths, poses, world_to_grid, volume_dims, view_valid=None):
        """Fuse each sample's views into its own volume: (B, V, H, W, C)
        features -> (B, X, Y, Z, C) of their dtype (``fuse_views_batch``: the
        batch's matrices made once, K3 per sample on the card). Float32
        features that require a gradient get one through the fusion, one K3b
        launch for the batch on the card."""
        return fuse_views_batch(feats2d, depths, poses, world_to_grid, self.intrinsic, tuple(volume_dims),
                                self.depth_min, self.depth_max, self.voxel_size, view_valid=view_valid)


def shift_world_to_grid(world_to_grid, origin) -> np.ndarray:
    """world->grid for a tile at `origin` (grid coords shift by -origin)."""
    m = np.asarray(world_to_grid, np.float32).copy()
    m[0, 3] -= origin[0]
    m[1, 3] -= origin[1]
    m[2, 3] -= origin[2]
    return m


def frustum_bbox_grid(pose, world_to_grid, intrinsic, depth_shape, depth_min, depth_max):
    """Loose frustum AABB of one view in grid coords: the 8 corners at
    depth_min and depth_max through camera-to-world and world-to-grid, one
    voxel of slack (``ProjectionHelper.compute_frustum_bounds``)."""
    w, h = depth_shape
    fx, fy = intrinsic[0][0], intrinsic[1][1]
    cx, cy = intrinsic[0][2], intrinsic[1][2]
    corners = []
    for d in (depth_min, depth_max):
        for ux, uy in ((0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)):
            corners.append([d * ((ux - cx) / fx), d * ((uy - cy) / fy), d, 1.0])
    corners = np.asarray(corners, np.float64).T  # (4, 8)
    grid = np.asarray(world_to_grid, np.float64) @ (np.asarray(pose, np.float64) @ corners)
    pts = grid[:3].T
    return pts.min(axis=0) - 1, pts.max(axis=0) + 1


def select_views_for_tile(frusta, origin, tile_shape, max_views):
    """The first ``max_views`` views whose frustum AABB meets the tile's.

    Returns (idx (max_views,) int32, valid (max_views,) bool, floor): floor
    is True when a scene view was left out (no overlap, or past the cap), so
    the tile's fused volume is floored at 0 as the all-zero volume of each
    omitted view would floor the reference's max over every view.
    """
    lo = np.asarray(origin, np.float64)
    hi = lo + np.asarray(tile_shape, np.float64)
    sel = []
    for i, (bmin, bmax) in enumerate(frusta):
        if (bmax >= lo).all() and (bmin <= hi).all():
            sel.append(i)
            if len(sel) == max_views:
                break
    idx = np.zeros((max_views,), np.int32)
    valid = np.zeros((max_views,), bool)
    idx[: len(sel)] = sel
    valid[: len(sel)] = True
    return idx, valid, len(sel) < len(frusta)
