"""Single-shot whole-scene inference — the reference's TEST mode
(``tpu3dsis/infer/single_shot.py``).

The reference pushes the entire scene through the backbone and the RPN in
one pass, with anchors made for the scene's shape
(``lib/nets/network.py:187-317``). The tiled ``SceneInference`` is the
served path; single-shot is kept for parity experiments against released
checkpoints, behind ``TPU_SCENE_MODE="single_shot"``. It builds one
inference function per padded scene shape (16-voxel buckets); its memory
grows with the scene.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dsis_torch.config import DetectorConfig
from tpu3dsis_torch.infer.tiling import pad_volume
from tpu3dsis_torch.models.detector import Detector, build_inference_fn


def _numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


class SingleShotInference:
    def __init__(self, detector: Detector, cfg: DetectorConfig):
        self.det = detector
        self.cfg = cfg
        self._fns = {}

    def _fn_for(self, shape):
        if shape not in self._fns:
            self._fns[shape] = build_inference_fn(self.det, self.cfg, shape, mode="TEST")
        return self._fns[shape]

    def detect(self, scene_data: np.ndarray, frames=None) -> dict:
        """scene_data: (X, Y, Z, 2) -> dict like ``SceneInference.detect``;
        a color detector fuses the scene's frames itself."""
        # 16-voxel buckets: the free space added stays small, so the
        # features' context is the chunks' (conv zero-padding only)
        bucket = tuple(((d + 15) // 16) * 16 for d in scene_data.shape[:3])
        data = pad_volume(scene_data.astype(np.float32), bucket)
        fn = self._fn_for(tuple(data.shape[:3]))
        out = fn(torch.from_numpy(data)[None], frames=frames if self.det.color_projector is not None else None)
        return detections_from(out, scene_data.shape[:3], self.cfg.CLASS_THRESH)


def detections_from(out: dict, extent, class_thresh: float) -> dict:
    """One padded scene's fixed-shape outputs (valid, degenerate, pred_conf,
    cls_pred, pred_box; tensors) -> the kept detections, clipped to the
    scene's extent, by descending confidence (numpy)."""
    out = {k: _numpy(out[k]) for k in ("valid", "degenerate", "pred_conf", "cls_pred", "pred_box")}
    keep = out["valid"] & ~out["degenerate"] & (out["pred_conf"] > class_thresh) & (out["cls_pred"] > 0)
    sx, sy, sz = extent
    boxes = np.clip(out["pred_box"][keep], 0, np.array([sx, sy, sz, sx, sy, sz], np.float32))
    order = np.argsort(-out["pred_conf"][keep])
    return {
        "pred_box": boxes[order],
        "pred_class": out["cls_pred"][keep][order].astype(np.int32),
        "pred_conf": out["pred_conf"][keep][order],
    }
