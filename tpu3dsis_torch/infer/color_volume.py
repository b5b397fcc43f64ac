"""The scene-resident color volume (``tpu3dsis/infer/color_volume.py``).

Every valid view of a scene is fused once into one (X, Y, Z, C) volume at
the padded bucket shape of the scene (the reference's full-scene projected
feature volume, ``lib/nets/network.py:187-235``); tiles then crop their
color input from it exactly as they crop the TSDF. On the card the fusion is
one launch of kernel K3.
"""

from __future__ import annotations

import torch

from tpu3dsis_torch.models.color import ColorProjector


def build_color_volume(proj: ColorProjector, feats2d, depths, poses, world_to_grid, bucket_shape, out_dtype,
                       view_valid=None) -> torch.Tensor:
    """(V, H, W, C) features, (V, H, W) depths, (V, 4, 4) poses, (4, 4)
    world-to-grid and (V,) view_valid -> the (X, Y, Z, C) volume of the
    bucket, in ``out_dtype``, on the features' device. The features are cast
    first: max commutes with the monotone rounding to bf16, so the volume is
    the cast of the float32 one."""
    return proj.project(feats2d.to(out_dtype), depths, poses, world_to_grid, bucket_shape, view_valid=view_valid)
