"""Chunk/scene-level detection + mask mAP (host-side numpy).

A copy of the JAX package's ``tpu3dsis/eval/detection_map.py``, held equal
to it on random predictions by ``tests/test_torch_io.py``. Behavioral port
of the reference evaluator (``lib/utils/evaluation.py:13-371``):
11-point interpolated PR AP per class; greedy confidence-sorted matching at
``overlap_threshold`` IoU with gt consumption; box IoU on plain extents; mask
IoU on unmolded full-scene voxel grids; classes with no gt auto-ignored.

Two reference quirks are preserved deliberately for numeric parity:
  - when matching a class subset, the confidence recorded for a TP/FP is
    ``pred_conf[i]`` with ``i`` an index into the *filtered* subset
    (evaluation.py:209-225) — i.e. possibly a different box's confidence;
    the match bookkeeping itself is consistent, only the recorded value
    shifts ranking;
  - ``precision_recall`` returns (0, 1) when the recall threshold is never
    reached (evaluation.py:370).
The class-agnostic mode (all pred classes == -1) used for RPN RoI AP is
supported (evaluation.py:188-211).
"""

from __future__ import annotations

import numpy as np


class APAccumulator:
    """TP/FP/FN bookkeeping for one class (evaluation.py:309-371)."""

    def __init__(self):
        self.predictions = []
        self.FN = 0
        self.TP = 0

    def inc_predictions(self, tp_confs, fp_confs):
        for c in tp_confs:
            self.predictions.append([c, 1.0])
            self.TP += 1
        for c in fp_confs:
            self.predictions.append([c, 0.0])

    def inc_not_predicted(self, value=1):
        self.FN += value

    def ranking(self):
        if len(self.predictions) != 0:
            preds = np.stack(self.predictions, 0)
            order = np.argsort(preds[:, 0])[::-1]
            self.predictions = preds[order]
        else:
            self.predictions = np.empty(shape=(0, 0))

    def if_ignore(self):
        return (self.TP + self.FN) == 0

    def precision_recall(self, thresh):
        if thresh == 0.0:
            return (0.0, 0.0)
        tp = 0.0
        fp = 0.0
        total_gt = self.TP + self.FN
        for i in range(self.predictions.shape[0]):
            if self.predictions[i][1] == 1.0:
                tp += 1
            else:
                fp += 1
            recall = tp / float(total_gt)
            precision = tp / (tp + fp)
            if recall >= thresh:
                return precision, recall
        return (0.0, 1.0)


def box_jaccard(box_a, box_b):
    """(A, B) IoU, plain extents (evaluation.py:117-141)."""
    if box_a.shape[0] == 0:
        return np.zeros([box_a.shape[0], box_b.shape[0]])
    mn = np.maximum(box_a[:, None, :3], box_b[None, :, :3])
    mx = np.minimum(box_a[:, None, 3:6], box_b[None, :, 3:6])
    d = np.clip(mx - mn, 0, None)
    inter = d[:, :, 0] * d[:, :, 1] * d[:, :, 2]
    area_a = np.prod(box_a[:, 3:6] - box_a[:, :3], axis=1)[:, None]
    area_b = np.prod(box_b[:, 3:6] - box_b[:, :3], axis=1)[None, :]
    return inter / (area_a + area_b - inter)


def mask_jaccard(masks_a, masks_b):
    """(A, B) voxel IoU of full-scene binary masks (evaluation.py:144-179)."""
    if masks_a.shape[0] == 0 or masks_b.shape[0] == 0:
        return np.zeros((masks_a.shape[0], masks_b.shape[0]))
    a = masks_a.reshape(masks_a.shape[0], -1).astype(bool)
    b = masks_b.reshape(masks_b.shape[0], -1).astype(bool)
    inter = (a[:, None, :] & b[None, :, :]).sum(axis=2)
    union = (a[:, None, :] | b[None, :, :]).sum(axis=2)
    return inter / np.maximum(union, 1)


def unmold_masks(masks, boxes, scene_info):
    """Paint box-crop masks into full-scene grids (evaluation.py:293-307).

    Boxes that poke past the scene grid are clipped and the mask cropped to
    the surviving overlap (the reference paints unconditionally because its
    exported data is always in-bounds; generated scenes need the guard)."""
    dims = [int(s) for s in scene_info[:3]]
    full = np.zeros((len(masks), *dims), np.uint8)
    for i, (m, b) in enumerate(zip(masks, boxes)):
        x1, y1, z1, x2, y2, z2 = [int(round(float(v))) for v in b[:6]]
        sx, sy, sz = max(x1, 0), max(y1, 0), max(z1, 0)
        ex = min(x2, dims[0])
        ey = min(y2, dims[1])
        ez = min(z2, dims[2])
        if ex <= sx or ey <= sy or ez <= sz:
            continue
        full[i, sx:ex, sy:ey, sz:ez] = m[
            sx - x1 : ex - x1, sy - y1 : ey - y1, sz - z1 : ez - z1
        ]
    return full


def _greedy_match(pred_cls, gt_cls, pred_conf, iou, class_index):
    """TP/FP/FN for one class (evaluation.py:181-226, quirks preserved)."""
    if pred_cls.shape[0] == 0:
        return [], [], int(np.sum(gt_cls == class_index))

    class_agnostic = pred_cls[0] == -1
    iou_mask = iou != 0
    if not class_agnostic:
        iou_mask = iou_mask[pred_cls == class_index, :]
        iou = iou[pred_cls == class_index, :]
    iou_mask = iou_mask[:, gt_cls == class_index]
    iou = iou[:, gt_cls == class_index]

    tp, fp = [], []
    fn = int(np.sum(gt_cls == class_index))

    if class_agnostic:
        order = np.argsort(pred_conf[:])[::-1]
    else:
        order = np.argsort(pred_conf[pred_cls == class_index])[::-1]

    for i in order:
        ind = -1
        best = -1.0
        for j in range(iou_mask.shape[1]):
            if iou_mask[i, j] and iou[i, j] > best:
                ind = j
                best = iou[i, j]
        if ind != -1:
            # NOTE reference quirk: i indexes the filtered subset but conf is
            # read from the unfiltered array (evaluation.py:221)
            tp.append(pred_conf[i])
            iou_mask[:, ind] = False
            fn -= 1
        else:
            fp.append(pred_conf[i])
    return tp, fp, fn


class DetectionMAP:
    def __init__(
        self, n_class, pr_samples=11, overlap_threshold=0.5, ignore_class=None
    ):
        self.n_class = n_class
        self.overlap_threshold = overlap_threshold
        self.pr_scale = np.linspace(0, 1, pr_samples)
        self.ignore_class = list(ignore_class) if ignore_class else []
        self.total_accumulators = [APAccumulator() for _ in range(n_class)]

    def evaluate(self, pred_bb, pred_classes, pred_conf, gt_bb, gt_classes):
        pred_classes = np.asarray(pred_classes).astype(int)
        gt_classes = np.asarray(gt_classes).astype(int)
        iou = box_jaccard(np.asarray(pred_bb), np.asarray(gt_bb))
        iou[iou < self.overlap_threshold] = 0
        for i, acc in enumerate(self.total_accumulators):
            tp, fp, fn = _greedy_match(pred_classes, gt_classes, pred_conf, iou, i)
            acc.inc_predictions(tp, fp)
            acc.inc_not_predicted(fn)

    def evaluate_mask(
        self,
        pred_box,
        pred_class,
        pred_conf,
        pred_mask,
        gt_box,
        gt_class,
        gt_mask,
        scene_info=(64, 64, 32),
    ):
        pred_class = np.asarray(pred_class).astype(int)
        gt_class = np.asarray(gt_class).astype(int)
        pm = unmold_masks(pred_mask, pred_box, scene_info)
        gm = unmold_masks(gt_mask, gt_box, scene_info)
        iou = mask_jaccard(pm, gm)
        iou[iou < self.overlap_threshold] = 0
        for i, acc in enumerate(self.total_accumulators):
            tp, fp, fn = _greedy_match(pred_class, gt_class, pred_conf, iou, i)
            acc.inc_predictions(tp, fp)
            acc.inc_not_predicted(fn)

    def compute_precision_recall_(self, class_index, interpolated=True):
        acc = self.total_accumulators[class_index]
        precisions, recalls = [], []
        for t in self.pr_scale:
            p, r = acc.precision_recall(t)
            precisions.append(p)
            recalls.append(r)
        precisions = precisions[::-1]
        recalls = recalls[::-1]
        if interpolated:
            out = []
            for p in precisions:
                out.append(max(p, max(out) if out else 0))
            precisions = out
        return precisions, recalls

    @staticmethod
    def compute_ap(precisions, recalls):
        prev_recall = 0.0
        ap = 0.0
        for p, r in zip(precisions[::-1], recalls[::-1]):
            ap += p * (r - prev_recall)
            prev_recall = r
        return ap

    def AP(self, idx):
        p, r = self.compute_precision_recall_(idx, True)
        return self.compute_ap(p, r)

    def mAP(self):
        vals = [
            self.AP(i) for i in range(self.n_class) if i not in self.ignore_class
        ]
        return sum(vals) / len(vals) if vals else 0

    def finalize(self):
        for idx, acc in enumerate(self.total_accumulators):
            acc.ranking()
            if acc.if_ignore() and idx not in self.ignore_class:
                self.ignore_class.append(idx)
