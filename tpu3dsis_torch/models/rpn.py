"""3D RPN heads and fixed-shape proposal selection (``tpu3dsis/models/rpn.py``).

``RPNHeads`` is a mixin for the detector module: it builds the per-level
heads on it under the JAX param names (``rpn_net_level1``, ...).
``select_proposals`` works on a whole batch at once: decode, inside-volume
mask, top-k, NMS (kernel K2 on the card) and compaction of the first
``post_nms_top_n`` kept, with fixed-shape outputs and a ``valid`` mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from tpu3dsis_torch.geometry.boxes import bbox_transform_inv, clip_boxes
from tpu3dsis_torch.models.nn import Conv
from tpu3dsis_torch.ops.nms import nms_mask


class RPNHeads:
    """Per-level conv heads (reference ``network.py:38-52``)."""

    def build_rpn(self, num_anchors: dict, rpn_channels: int, level_channels: int = 128) -> None:
        self.rpn_levels = {lvl: a for lvl, a in num_anchors.items() if a > 0}
        for lvl, a in self.rpn_levels.items():
            setattr(self, f"rpn_net_level{lvl}", Conv(level_channels, rpn_channels, 3, pad=1))
            setattr(self, f"rpn_cls_score_net_level{lvl}", nn.Sequential(Conv(rpn_channels, a * 2, 1)))
            setattr(self, f"rpn_bbox_pred_net_level{lvl}", Conv(rpn_channels, a * 6, 1))

    def rpn_heads(self, level_feats: dict) -> dict:
        """{lvl: (N, C, W, H, L)} -> {lvl: (cls_score (N,W,H,L,2,A), cls_prob,
        bbox_pred (N,W,H,L,6A))}, channels-last as in the JAX package.

        The conv output is (N, 2A, W, H, L); it is made channels-last before
        the (2, A) split, which matches the JAX reshape of its channels-last
        output (channel k*A + a is class k of anchor a). The softmax runs in
        float32 whatever the compute dtype: in bfloat16 every probability
        above 0.996 rounds to 1.0, and the top-k would then rank the best
        anchors by their index (the JAX package keeps bfloat16 here).
        """
        out = {}
        for lvl, a in self.rpn_levels.items():
            t = torch.relu(getattr(self, f"rpn_net_level{lvl}")(level_feats[lvl]))
            cls = getattr(self, f"rpn_cls_score_net_level{lvl}")(t).permute(0, 2, 3, 4, 1)
            cls_score = cls.reshape(*cls.shape[:4], 2, a)
            cls_prob = torch.softmax(cls_score, dim=4, dtype=torch.float32)
            bbox = getattr(self, f"rpn_bbox_pred_net_level{lvl}")(t).permute(0, 2, 3, 4, 1)
            out[lvl] = (cls_score, cls_prob, bbox)
        return out


@dataclass(frozen=True)
class LevelAnchors:
    """Static per-level anchor data for one scene shape (host-precomputed)."""

    anchors: np.ndarray  # (K*A, 6) float32
    inside: np.ndarray  # (K*A,) bool: anchor lies inside the volume


def select_proposals(rpn_out: dict, level_anchors: dict, scene_shape,
                     pre_nms_top_n: int, post_nms_top_n: int, nms_thresh: float):
    """Fixed-shape proposal layer for a batch of N samples.

    rpn_out: {lvl: (cls_score, cls_prob, bbox_pred)} with batch dim N;
    level_anchors: {lvl: (anchors (K*A, 6), inside (K*A,))} tensors on the
    device. Returns rois (N, P, 6), scores (N, P), level_inds (N, P) (float,
    as in the JAX package) and valid (N, P).
    """
    props, scores, lvl_ids, valid = [], [], [], []
    for lvl, (_, cls_prob, bbox_pred) in sorted(rpn_out.items()):
        anchors, inside = level_anchors[lvl]
        n = bbox_pred.shape[0]
        deltas = bbox_pred.reshape(n, -1, 6)
        s = cls_prob[:, :, :, :, 1, :].reshape(n, -1)
        p = clip_boxes(bbox_transform_inv(anchors, deltas), scene_shape)
        props.append(p)
        scores.append(s)
        lvl_ids.append(torch.full_like(s, lvl))
        valid.append(inside.expand(n, -1))
    props = torch.cat(props, 1)
    scores = torch.cat(scores, 1)
    lvl_ids = torch.cat(lvl_ids, 1)
    valid = torch.cat(valid, 1)

    # outside-volume anchors never propose (proposal_layer.py:36-84)
    neg = -1e9
    masked = torch.where(valid, scores, torch.full_like(scores, neg))
    k = min(pre_nms_top_n, masked.shape[1])
    # a stable descending sort breaks ties by lower index, as lax.top_k does
    top_scores, order = torch.sort(masked, dim=1, descending=True, stable=True)
    top_scores, order = top_scores[:, :k], order[:, :k]
    top_props = torch.gather(props, 1, order[..., None].expand(-1, -1, 6))
    top_lvls = torch.gather(lvl_ids, 1, order)
    top_valid = torch.gather(valid, 1, order)

    keep = nms_mask(top_props, nms_thresh, valid=top_valid)
    # the first post_nms_top_n kept, in score order; slot p_n drops the rest
    p_n = post_nms_top_n
    rank = torch.cumsum(keep, dim=1) - 1
    slot = torch.where(keep & (rank < p_n), rank, torch.full_like(rank, p_n))
    src = torch.arange(k, device=keep.device).expand_as(slot)
    gather = torch.zeros((keep.shape[0], p_n + 1), dtype=torch.int64, device=keep.device)
    gather = gather.scatter(1, slot, src)[:, :p_n]
    num_kept = torch.clamp(keep.sum(1), max=p_n)
    out_valid = torch.arange(p_n, device=keep.device) < num_kept[:, None]
    gather = torch.where(out_valid, gather, torch.zeros_like(gather))

    return {
        "rois": torch.gather(top_props, 1, gather[..., None].expand(-1, -1, 6)),
        "scores": torch.where(
            out_valid, torch.gather(top_scores, 1, gather), torch.full_like(gather, neg, dtype=top_scores.dtype)
        ),
        "level_inds": torch.gather(top_lvls, 1, gather),
        "valid": out_valid,
    }
