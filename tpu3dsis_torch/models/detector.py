"""End-to-end chunk detector: backbone -> RPN -> proposals -> RoI heads -> boxes.

Port of ``tpu3dsis/models/detector.py`` for geometry-only TEST inference.
``Detector`` is one ``nn.Module`` whose ``state_dict`` keys are the JAX
package's flat param names; ``build_inference_fn`` returns the inference
function for one scene shape, which runs a whole batch of chunks at once:
one backbone and RPN pass, one K2 launch for every sample's NMS and one K1
launch for every roi's pool.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu3dsis_torch.config import DetectorConfig
from tpu3dsis_torch.geometry.anchors import anchors_inside_mask, generate_level_anchors
from tpu3dsis_torch.geometry.boxes import bbox_transform_inv, clip_boxes
from tpu3dsis_torch.models.backbones import FC7_CHANNELS, FEAT_STRIDE, MaskBackbone, ScanNetBackbone
from tpu3dsis_torch.models.nn import Linear, init_params
from tpu3dsis_torch.models.rpn import LevelAnchors, RPNHeads, select_proposals
from tpu3dsis_torch.ops.roi_pool3d import roi_pool3d_multilevel

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Detector(ScanNetBackbone, RPNHeads, nn.Module):
    """Geometry-only ScanNet detector, with the mask FCN as ``mask_backbone``
    when ``cfg.USE_MASK`` (else ``mask_backbone`` is None).

    Parameters live in ``cfg.TPU_COMPUTE_DTYPE`` (float32 or bfloat16) on
    ``device``, the CUDA card unless the caller passes ``device="cpu"``;
    without a CUDA device the default raises rather than falling back. The
    5-D conv weights and the volumes run in ``torch.channels_last_3d``, so a
    level map's channels-last view, which the RoI pool reads, costs no copy.
    """

    def __init__(self, cfg: DetectorConfig, anchor_dir: str = "experiments/anchors",
                 device: torch.device | str = "cuda"):
        nn.Module.__init__(self)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Detector runs on a CUDA device, and none is present; pass device='cpu' for the CPU")
        if cfg.NET != "ScanNet_Backbone":
            raise NotImplementedError(f"the port has only ScanNet_Backbone, not {cfg.NET}")
        if not cfg.USE_RPN or cfg.NUM_ANCHORS_LEVEL3:
            raise NotImplementedError("the port needs the RPN on levels 1 and 2 only")
        if cfg.TPU_COMPUTE_DTYPE not in _DTYPES:
            raise ValueError(f"TPU_COMPUTE_DTYPE must be one of {list(_DTYPES)}")
        self.num_classes = cfg.NUM_CLASSES
        self.pooling_size = cfg.CLASS_POOLING_SIZE
        self.use_class = cfg.USE_CLASS
        self.compute_dtype = _DTYPES[cfg.TPU_COMPUTE_DTYPE]
        self.build_backbone(self.pooling_size)
        self.num_anchors = {1: cfg.NUM_ANCHORS_LEVEL1, 2: cfg.NUM_ANCHORS_LEVEL2}
        self.build_rpn(self.num_anchors, cfg.RPN_CHANNELS)
        if self.use_class:
            self.classifier_cls_score_net = Linear(FC7_CHANNELS, self.num_classes)
            self.classifier_bbox_pred_net = Linear(FC7_CHANNELS, self.num_classes * 6)
        self.mask_backbone = MaskBackbone(self.num_classes, device=device) if cfg.USE_MASK else None
        self.anchor_dir = anchor_dir
        self.anchor_files = {1: cfg.ANCHORS_TYPE_LEVEL1, 2: cfg.ANCHORS_TYPE_LEVEL2}
        self._anchor_cache = {}
        self.to(device=device, dtype=self.compute_dtype, memory_format=torch.channels_last_3d)

    @property
    def device(self) -> torch.device:
        return self.geometry1[0].weight.device

    def init_params(self, generator: torch.Generator) -> "Detector":
        """Random weights from `generator` (torch's default init)."""
        init_params(self, generator)
        return self

    # --- anchors (host, cached per scene shape; network.py:248-258) ------
    def level_anchors(self, scene_shape) -> dict:
        key = tuple(int(s) for s in scene_shape)
        if key not in self._anchor_cache:
            feat = tuple(s // FEAT_STRIDE[0] for s in key)
            out = {}
            for lvl, a in self.num_anchors.items():
                if a == 0:
                    continue
                anchors = generate_level_anchors(
                    f"{self.anchor_dir}/{self.anchor_files[lvl]}", feat, FEAT_STRIDE[lvl - 1]
                )
                out[lvl] = LevelAnchors(anchors=anchors, inside=anchors_inside_mask(anchors, key))
            self._anchor_cache[key] = out
        return self._anchor_cache[key]

    # --- forward pieces --------------------------------------------------
    def features(self, scene: torch.Tensor) -> dict:
        """scene (N, X, Y, Z, 2) -> {lvl: (N, W, H, L, 128)} channels-last."""
        x = scene.to(self.device, self.compute_dtype).permute(0, 4, 1, 2, 3)
        lvl1, lvl2 = self.backbone(x)
        return {1: lvl1.permute(0, 2, 3, 4, 1), 2: lvl2.permute(0, 2, 3, 4, 1)}

    def rpn_forward(self, feats: dict) -> dict:
        return self.rpn_heads({lvl: f.permute(0, 4, 1, 2, 3) for lvl, f in feats.items()})

    def classify_rois(self, feats: dict, rois: torch.Tensor, level_inds: torch.Tensor):
        """RoI pool (multi-level) + classifier MLP + class/bbox heads.

        rois (N, R, 6) scene coords, level_inds (N, R). Returns (cls_score,
        cls_prob, cls_pred, bbox_pred), each with leading dims (N, R).
        """
        levels = sorted(feats)
        pool5 = roi_pool3d_multilevel(
            [feats[l] for l in levels], rois, level_inds, self.pooling_size,
            [1.0 / FEAT_STRIDE[l - 1] for l in levels],
        )
        n, r = pool5.shape[:2]
        fc7 = self.classify(pool5.reshape(n * r, *pool5.shape[2:]))
        cls_score = self.classifier_cls_score_net(fc7).reshape(n, r, -1)
        cls_prob = torch.softmax(cls_score, dim=-1, dtype=torch.float32)  # as in rpn_heads
        cls_pred = torch.argmax(cls_score, dim=-1)
        bbox_pred = self.classifier_bbox_pred_net(fc7).reshape(n, r, -1)
        return cls_score, cls_prob, cls_pred, bbox_pred

    def decode_test_boxes(self, rois, cls_pred, cls_prob, bbox_pred, scene_shape):
        """Per-class box refinement for TEST (network.py:283-301): decode the
        predicted class's deltas, clip, confidence = its probability, and a
        degenerate-box mask (round(min) >= round(max) on any axis)."""
        lead = cls_pred.shape
        blocks = bbox_pred.reshape(*lead, self.num_classes, 6)
        idx = cls_pred[..., None, None].expand(*lead, 1, 6)
        sel = torch.gather(blocks, -2, idx)[..., 0, :]
        pred_box = clip_boxes(bbox_transform_inv(rois, sel), scene_shape)
        conf = torch.gather(cls_prob, -1, cls_pred[..., None])[..., 0]
        rd = torch.round(pred_box)  # half to even, as jnp.round
        degenerate = (rd[..., 0] >= rd[..., 3]) | (rd[..., 1] >= rd[..., 4]) | (rd[..., 2] >= rd[..., 5])
        return pred_box, conf, degenerate


def device_anchors(detector: Detector, scene_shape) -> dict:
    """{lvl: (anchors (K*A, 6), inside (K*A,))} on the detector's device, the
    form ``select_proposals`` takes."""
    return {
        lvl: (torch.from_numpy(la.anchors).to(detector.device), torch.from_numpy(la.inside).to(detector.device))
        for lvl, la in detector.level_anchors(scene_shape).items()
    }


def build_inference_fn(detector: Detector, cfg: DetectorConfig, scene_shape, mode: str = "TEST"):
    """Inference function for one static scene shape.

    Returns f(scene) for scene (N, X, Y, Z, 2) channels-last, N >= 1, which
    returns the JAX ``infer``'s dict of fixed-shape outputs; with N > 1 each
    output has a leading batch dimension.
    """
    mode_cfg = getattr(cfg, mode)
    pre_n = mode_cfg.RPN_PRE_NMS_TOP_N
    post_n = mode_cfg.RPN_POST_NMS_TOP_N
    thresh = mode_cfg.RPN_NMS_THRESH
    shape = tuple(int(s) for s in scene_shape)
    anchors = device_anchors(detector, shape)

    @torch.inference_mode()
    def infer(scene):
        scene = torch.as_tensor(scene, device=detector.device)
        if tuple(scene.shape[1:4]) != shape:
            raise ValueError(f"scene shape {tuple(scene.shape)} does not match {shape}")
        feats = detector.features(scene)
        rpn_out = detector.rpn_forward(feats)
        out = select_proposals(rpn_out, anchors, shape, pre_n, post_n, thresh)
        if detector.use_class:
            cls_score, cls_prob, cls_pred, bbox_pred = detector.classify_rois(
                feats, out["rois"], out["level_inds"]
            )
            pred_box, conf, degenerate = detector.decode_test_boxes(
                out["rois"], cls_pred, cls_prob, bbox_pred, shape
            )
            out.update(
                cls_score=cls_score,
                cls_prob=cls_prob,
                cls_pred=cls_pred,
                bbox_pred=bbox_pred,
                pred_box=pred_box,
                pred_conf=conf,
                degenerate=degenerate,
            )
        if scene.shape[0] == 1:
            out = {k: v[0] for k, v in out.items()}
        return out

    return infer
