"""Chunk-level validation: RPN AP, classification mAP and mask mAP
(``tpu3dsis/infer/validate.py``; the reference's
``SolverWrapper.validation``, ``lib/model/trainval.py:434-632``).

Each validation chunk runs the TEST forward (``build_inference_fn``). RPN
AP is class-agnostic over the rois scoring above ROI_THRESH; classification
mAP takes the refined boxes above CLASS_THRESH without the degenerate ones;
mask mAP unmolds each box's thresholded mask (``MaskBackbone`` on the
chunk, the box's region re-masked after every conv) into the chunk grid.
The detector holds the weights, so ``run`` takes none.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from tpu3dsis_torch.config import DetectorConfig
from tpu3dsis_torch.eval import DetectionMAP
from tpu3dsis_torch.io.dataset import pad_sample
from tpu3dsis_torch.models.detector import Detector, build_inference_fn


class ChunkValidator:
    def __init__(self, detector: Detector, cfg, chunk_shape=(96, 48, 96)):
        self.det = detector
        self.cfg = cfg
        self.shape = tuple(int(s) for s in chunk_shape)
        self._infer = build_inference_fn(detector, DetectorConfig.from_cfg(cfg), self.shape, mode="TEST")

    def predict_chunk(self, sample_padded: dict) -> dict:
        """The TEST forward on one padded chunk -> numpy prediction dict."""
        frames = None
        if "images" in sample_padded:
            frames = {k: sample_padded[k] for k in ("images", "depths", "poses", "world_to_grid", "view_valid")}
        out = self._infer(torch.as_tensor(sample_padded["data"])[None], frames=frames)
        return {k: v.cpu().numpy() for k, v in out.items()}

    @torch.inference_mode()
    def masks_for_boxes(self, data, boxes, labels, batch: int = 8) -> list:
        """Thresholded box-crop masks of `boxes` (with their `labels`) on
        one chunk, `batch` boxes a mask-FCN call. The mask FCN's color
        branch (``MASK_USE_IMAGES``) raises: the JAX package's validator
        hands it no color volume (``tpu3dsis/infer/validate.py:33-50``), so
        it has no result to match."""
        if self.det.mask_backbone.color is not None:
            raise NotImplementedError("chunk validation of the mask FCN's color branch (MASK_USE_IMAGES): the JAX "
                                      "package's ChunkValidator passes it no color volume and fails there")
        masks = []
        scene = torch.as_tensor(data, device=self.det.device)
        top = np.asarray([*self.shape, *self.shape])
        for i in range(0, len(boxes), batch):
            bs, ls = boxes[i:i + batch], labels[i:i + batch]
            regions = np.zeros((len(bs), *self.shape), np.float32)
            for j, b in enumerate(bs):
                r = np.clip(np.round(b).astype(int), 0, top)
                regions[j, r[0]:r[3], r[1]:r[4], r[2]:r[5]] = 1.0
            reg = torch.from_numpy(regions).to(self.det.device)[..., None]
            probs = self.det.mask_backbone(scene[None] * reg.to(scene.dtype), region_mask=reg, training=False)
            lab = torch.as_tensor(np.asarray(ls, np.int64), device=self.det.device)
            probs = probs[torch.arange(len(bs), device=self.det.device), ..., lab].float().cpu().numpy()
            for j, b in enumerate(bs):
                r = np.clip(np.round(b).astype(int), 0, top)
                crop = probs[j, r[0]:r[3], r[1]:r[4], r[2]:r[5]]
                masks.append((crop >= self.cfg.MASK_THRESH).astype(np.float32))
        return masks

    def _dump_artifacts(self, save_dir, sample, out, keep, pred_masks):
        """VAL_SAVE_DIR dumps of the first VAL_NUM chunks (trainval.py:543-556, 589-592)."""
        d = os.path.join(save_dir, os.path.basename(sample.sample_id)[:12])
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "pred_class.npy"), out["cls_pred"])
        np.save(os.path.join(d, "pred_conf.npy"), out["pred_conf"])
        np.save(os.path.join(d, "pred_box.npy"), out["pred_box"])
        np.save(os.path.join(d, "scene.npy"), np.where(sample.data[..., 0] <= 1, 1, 0))
        np.save(os.path.join(d, "gt_class.npy"), sample.gt_box[:, 6])
        np.save(os.path.join(d, "gt_box.npy"), sample.gt_box[:, :6])
        with open(os.path.join(d, "pred_mask"), "wb") as f:
            pickle.dump(pred_masks, f)
        with open(os.path.join(d, "pred_mask_index"), "wb") as f:
            pickle.dump(keep.tolist(), f)
        with open(os.path.join(d, "gt_mask"), "wb") as f:
            pickle.dump(sample.gt_mask, f)

    def run(self, dataset, max_samples=None, save_dir=None, logger=None, step=0) -> dict:
        cfg = self.cfg
        use_mask = self.det.mask_backbone is not None
        map_rpn = DetectionMAP(1, overlap_threshold=cfg.MAP_THRESH)
        map_cls = DetectionMAP(cfg.NUM_CLASSES, overlap_threshold=cfg.MAP_THRESH, ignore_class=[0])
        map_mask = DetectionMAP(cfg.NUM_CLASSES, overlap_threshold=cfg.MAP_THRESH, ignore_class=[0])
        n_eval = 0
        for idx in range(len(dataset)):
            if max_samples is not None and n_eval >= max_samples:
                break
            sample = dataset[idx]
            if sample.gt_box.shape[0] == 0:
                continue  # skip empty (trainval.py:459-460)
            if sample.data.shape[:3] != self.shape:
                continue
            padded = pad_sample(sample, cfg, with_mask_canvas=False)
            out = self.predict_chunk(padded)
            n_eval += 1

            gt_box = sample.gt_box[:, :6]
            gt_cls = sample.gt_box[:, 6]
            valid = out["valid"]

            # RPN AP (trainval.py:479-500)
            scores = out["scores"]
            nkeep = max(int(np.sum((scores > cfg.ROI_THRESH) & valid)), 1)
            map_rpn.evaluate(out["rois"][:nkeep], -np.ones(nkeep), scores[:nkeep], gt_box, np.zeros(gt_box.shape[0]))

            # classification mAP (trainval.py:503-558)
            keep = valid & (out["pred_conf"] > cfg.CLASS_THRESH) & ~out["degenerate"]
            map_cls.evaluate(out["pred_box"][keep], out["cls_pred"][keep], out["pred_conf"][keep], gt_box, gt_cls)

            # mask mAP (trainval.py:563-607)
            pred_masks = []
            if use_mask:
                pred_masks = self.masks_for_boxes(padded["data"], out["pred_box"][keep], out["cls_pred"][keep])
            if save_dir is not None and n_eval <= int(cfg.VAL_NUM):
                self._dump_artifacts(save_dir, sample, out, keep, pred_masks)
            if use_mask:
                map_mask.evaluate_mask(out["pred_box"][keep], out["cls_pred"][keep], out["pred_conf"][keep],
                                       pred_masks, gt_box, gt_cls, sample.gt_mask, self.shape)

        map_rpn.finalize()
        map_cls.finalize()
        results = {"AP_ROI": map_rpn.mAP(), "mAP_CLASSIFICATION": map_cls.mAP()}
        if use_mask:
            map_mask.finalize()
            results["mAP_MASK"] = map_mask.mAP()
        if logger is not None:
            for tag, v in results.items():
                logger.scalar_summary(tag, v, step)
        return results
