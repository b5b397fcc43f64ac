"""Single-shot scene inference with the backbone sharded over several
devices (``tpu3dsis/parallel/scene.py``).

``spatial_features`` runs the backbone X-sharded with halo exchanges; the
heads (``build_heads_fn``: RPN, proposal selection (K2), RoI pool (K1),
classifier and box decode) then run on the gathered stride-4 maps on the
first device, as the port's ``infer/single_shot.py`` runs them: a scene whose backbone does not fit one
card runs in one pass over several.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dsis_torch.infer.single_shot import detections_from
from tpu3dsis_torch.infer.tiling import pad_volume
from tpu3dsis_torch.models.detector import build_heads_fn
from tpu3dsis_torch.parallel.spatial import device_list, spatial_features


@torch.inference_mode()
def spatial_single_shot(detector, cfg, scene_data: np.ndarray, devices) -> dict:
    """One-pass whole-scene detection, the backbone sharded over ``devices``
    (a list, which may name one device more than once). The scene is padded
    as free space to X a multiple of 4 * len(devices) and Y, Z multiples of
    4. Returns ``SingleShotInference.detect``'s dict: {pred_box (N, 6),
    pred_class (N,), pred_conf (N,)} in scene voxels, by descending
    confidence. ``detector`` lives on the first device."""
    devices = device_list(devices)
    if devices[0] != detector.device:
        raise ValueError(f"the first device ({devices[0]}) must be the detector's ({detector.device})")
    if detector.color is not None:
        raise NotImplementedError("spatial_single_shot is geometry-only, as the JAX package's is")
    mult = 4 * len(devices)
    bucket = (-(-scene_data.shape[0] // mult) * mult, -(-scene_data.shape[1] // 4) * 4,
              -(-scene_data.shape[2] // 4) * 4)
    data = pad_volume(scene_data.astype(np.float32), bucket)
    shape = tuple(data.shape[:3])
    heads = build_heads_fn(detector, cfg, shape, mode="TEST")  # raises for USE_RPN=False first
    out = heads(spatial_features(detector, torch.from_numpy(data), devices))
    return detections_from({k: v[0] for k, v in out.items()}, scene_data.shape[:3], cfg.CLASS_THRESH)
