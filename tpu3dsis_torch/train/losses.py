"""Loss assembly (``tpu3dsis/train/losses.py``, the reference's
``Network._add_losses``, ``network.py:319-501``).

  - per-level RPN cross entropy over the sampled anchors (labels != -1),
    mean; per-level RPN smooth-L1 box loss, sigma 2, summed;
  - class cross entropy with per-class weights (torch's weighted mean:
    divided by the sum of the selected weights); per-class box smooth-L1,
    sigma 1, summed over columns, mean over rois;
  - mask BCE with logits per foreground roi, mean over its voxels,
    class-weighted, divided by the count of rois of nonzero weight.

Each loss takes a leading batch dimension and returns one value per sample.
The logits are taken in float32 whatever the compute dtype (the JAX package
keeps bfloat16 there); the sums run in float32. ``index_add_`` takes the
place of ``jax.ops.segment_sum``.
"""

from __future__ import annotations

import torch


def smooth_l1(pred, target, inside_w, outside_w, sigma: float):
    """The reference's ``_smooth_l1_loss`` elementwise core (network.py:485-501)."""
    sigma2 = sigma * sigma
    diff = inside_w * (pred - target)
    abs_diff = torch.abs(diff)
    flag = (abs_diff < 1.0 / sigma2).to(pred.dtype)
    per_elem = flag * 0.5 * sigma2 * diff * diff + (1.0 - flag) * (abs_diff - 0.5 / sigma2)
    return outside_w * per_elem


def rpn_level_losses(cls_score, bbox_pred, targets: dict, sigma: float = 2.0):
    """One RPN level: cls_score (B, W, H, L, 2, A), bbox_pred (B, W, H, L,
    6A), targets of ``anchor_targets`` ((B, N) site-major, anchor-minor).
    Returns (cross entropy (B,), box loss (B,))."""
    labels = targets["labels"]
    b, n = labels.shape
    # (B, W, H, L, 2, A) -> (B, W, H, L, A, 2) -> (B, N, 2): the anchor order
    logits = cls_score.float().movedim(4, 5).reshape(b, n, 2)
    sel = labels != -1
    safe = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, safe[..., None])[..., 0]
    count = torch.clamp(sel.sum(dim=1), min=1)
    rpn_ce = torch.where(sel, ce, 0.0).sum(dim=1) / count

    pred6 = bbox_pred.float().reshape(b, n, 6)
    box = smooth_l1(pred6, targets["bbox_targets"], targets["inside_w"], targets["outside_w"], sigma)
    return rpn_ce, box.sum(dim=(1, 2))


def class_losses(cls_score, bbox_pred, ptargets: dict, class_weights):
    """RCNN class cross entropy (weighted mean) and per-class box smooth-L1.
    cls_score (B, S, C), bbox_pred (B, S, 6C), ptargets of
    ``proposal_targets``, class_weights (C,). Returns ((B,), (B,))."""
    labels = ptargets["labels"].long()
    w = class_weights[labels]
    logp = torch.log_softmax(cls_score.float(), dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
    cross_entropy = (w * ce).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1e-12)
    box = smooth_l1(bbox_pred.float(), ptargets["bbox_targets"], ptargets["inside_w"], ptargets["outside_w"],
                    sigma=1.0)
    return cross_entropy, box.sum(dim=2).mean(dim=1)


def mask_loss_windowed(mask_logits, mask_targets, own_masks, item_valid, roi_idx, labels, roi_valid,
                       class_weights, num_rois: int):
    """Mask BCE over one halo-window work queue (network.py:461-481).

    Each work item covers the owned output segment of one window of one roi
    (``ops/mask_windows.py``); the segments of a roi partition its box, so
    summing per-voxel BCE by ``roi_idx`` over the summed owned volume is the
    reference's per-roi mean over its exact-size crop. mask_logits (C, X, Y,
    Z, NC); mask_targets, own_masks (C, X, Y, Z); item_valid, roi_idx (C,);
    labels, roi_valid (M,); class_weights (NC,), whose background weight is
    taken as 0.
    """
    return mask_loss_window_groups([(mask_logits, mask_targets, own_masks, item_valid, roi_idx)], labels,
                                   roi_valid, class_weights, num_rois)


def mask_loss_window_groups(groups, labels, roi_valid, class_weights, num_rois: int):
    """Mask BCE over several window queues that share one roi space (the
    small-canvas and the large-canvas queue of the train step); every roi's
    windows lie in one group. Each group is (mask_logits, mask_targets,
    own_masks, item_valid, roi_idx). labels and roi_valid may carry leading
    batch dimensions, (..., M): roi_idx then indexes their flattened rois,
    and the result is one loss per sample, shape (...)."""
    lead = labels.shape[:-1]
    if labels.shape[-1] != num_rois:
        raise ValueError(f"labels {tuple(labels.shape)} do not hold {num_rois} rois per sample")
    total_rois = labels.numel()
    labels = labels.reshape(-1).long()
    roi_valid = roi_valid.reshape(-1)
    cw = class_weights.clone()
    cw[0] = 0.0
    dev = labels.device
    roi_sum = torch.zeros((total_rois,), dtype=torch.float32, device=dev)
    roi_cnt = torch.zeros((total_rois,), dtype=torch.float32, device=dev)
    for mask_logits, mask_targets, own_masks, item_valid, roi_idx in groups:
        if mask_logits.shape[0] == 0:
            continue
        roi_idx = roi_idx.long()
        lab = labels[roi_idx]
        logit = torch.gather(mask_logits, -1, lab.view(-1, 1, 1, 1, 1).expand(*mask_logits.shape[:4], 1))[..., 0]
        logit = logit.float()
        target = mask_targets.float()
        # numerically stable BCE with logits
        bce = torch.clamp(logit, min=0) - logit * target + torch.log1p(torch.exp(-torch.abs(logit)))
        w_own = own_masks * item_valid[:, None, None, None].to(own_masks.dtype)
        roi_sum = roi_sum.index_add(0, roi_idx, (bce * w_own).sum(dim=(1, 2, 3)))
        roi_cnt = roi_cnt.index_add(0, roi_idx, w_own.sum(dim=(1, 2, 3)))
    per_roi = (roi_sum / torch.clamp(roi_cnt, min=1.0)).reshape(*lead, num_rois)
    w = (cw[labels] * roi_valid.to(cw.dtype)).reshape(*lead, num_rois)
    counter = (w != 0.0).to(torch.float32).sum(dim=-1)
    total = (per_roi * w).sum(dim=-1)
    return torch.where(counter > 0, total / torch.clamp(counter, min=1.0), total)


def roi_region_mask(roi, shape):
    """(X, Y, Z) float mask of the voxels inside a rounded corner box."""
    dev = roi.device
    x = torch.arange(shape[0], device=dev)[:, None, None]
    y = torch.arange(shape[1], device=dev)[None, :, None]
    z = torch.arange(shape[2], device=dev)[None, None, :]
    r = torch.round(roi)
    m = (x >= r[0]) & (x < r[3]) & (y >= r[1]) & (y < r[4]) & (z >= r[2]) & (z < r[5])
    return m.to(torch.float32)
