"""Anchor generation in numpy (``tpu3dsis/geometry/anchors.py``).

The JAX package's module is numpy-only too, but importing it runs
``tpu3dsis/geometry/__init__.py``, which imports JAX; the port carries this
copy so its path imports no JAX. Anchor size files hold ``w, h, l`` lines;
each size is centred at the origin and tiled over the feature grid with
stride ``feat_stride``, grid cell outermost and anchor innermost.
"""

from __future__ import annotations

import numpy as np


def read_anchor_sizes(path: str) -> np.ndarray:
    """Parse an anchor size file -> (A, 6) origin-centred corner boxes."""
    sizes = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            w, h, l = [float(x) for x in line.split(",")]
            sizes.append([-w / 2, -h / 2, -l / 2, w / 2, h / 2, l / 2])
    return np.asarray(sizes, dtype=np.float64)


def _grid_shifts(size, feat_stride):
    sx = np.arange(0, size[0]) * feat_stride
    sy = np.arange(0, size[1]) * feat_stride
    sz = np.arange(0, size[2]) * feat_stride
    gx, gy, gz = np.meshgrid(sx, sy, sz, indexing="ij")
    return np.vstack(
        (gx.ravel(), gy.ravel(), gz.ravel(), gx.ravel(), gy.ravel(), gz.ravel())
    ).transpose()


def tile_anchors(base_anchors: np.ndarray, feat_size, feat_stride: int) -> np.ndarray:
    """Tile (A, 6) base anchors over a (W, H, L) feature grid -> (K*A, 6)
    float32, grid cell (x-major) outermost, anchor innermost."""
    shifts = _grid_shifts(tuple(int(s) for s in feat_size), int(feat_stride))
    a = base_anchors.shape[0]
    k = shifts.shape[0]
    anchors = base_anchors.reshape((1, a, 6)) + shifts.reshape((k, 1, 6))
    return anchors.reshape((k * a, 6)).astype(np.float32, copy=False)


def generate_level_anchors(anchor_file: str, feat_size, feat_stride: int) -> np.ndarray:
    return tile_anchors(read_anchor_sizes(anchor_file), feat_size, feat_stride)


def anchors_inside_mask(anchors: np.ndarray, scene_shape, allowed_border: float = 0):
    """Boolean (N,) mask of anchors fully inside the scene volume."""
    return (
        (anchors[:, 0] >= -allowed_border)
        & (anchors[:, 1] >= -allowed_border)
        & (anchors[:, 2] >= -allowed_border)
        & (anchors[:, 3] < scene_shape[0] + allowed_border)
        & (anchors[:, 4] < scene_shape[1] + allowed_border)
        & (anchors[:, 5] < scene_shape[2] + allowed_border)
    )
