"""Target assignment for training: anchor, proposal and mask targets
(``tpu3dsis/train/targets.py``).

Every function works on a batch: gt boxes padded to (B, MAX_GT, 7) with a
validity mask (``io/dataset.py::pad_sample``), anchors shared by the batch.
Index lists become boolean masks and ragged sets fixed-capacity rows with a
validity mask, as in the JAX package. Its random subsampling
(``np.random.choice`` without replacement in the reference) ranks the
members of a set by uniform draws; here the draws are an explicit argument,
(B, N) float32 in [0, 1) per draw, so that the train step makes them with a
``torch.Generator`` on the card and a test can pass the draws ``jax.random``
gives for the same keys. Sorts are stable, as ``jnp.argsort`` is: the
non-members, all tied at -1, keep their order.
"""

from __future__ import annotations

import torch

from tpu3dsis_torch.geometry.boxes import bbox_overlap, bbox_transform

# classes whose thin dimension is inflated for level-3 anchor matching
# (anchor_target_layer.py:182, mapped consecutive ids)
_LEVEL3_THIN_CLASSES = (6, 7, 9, 12, 18)


def _rank_select(draws: torch.Tensor, member_mask: torch.Tensor, quota) -> torch.Tensor:
    """Select min(quota, count) members of each row of a masked set, those
    with the largest draws. quota: an int or a (B,) tensor. Returns the
    (B, N) bool mask of the selected members."""
    scores = torch.where(member_mask, draws, torch.full_like(draws, -1.0))
    order = torch.argsort(-scores, dim=-1, stable=True)
    n = member_mask.shape[-1]
    ar = torch.arange(n, device=order.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, ar)
    quota = torch.as_tensor(quota, device=rank.device)
    return member_mask & (rank < (quota[..., None] if quota.dim() else quota))


def _ranked_indices(draws: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Members first, in the order of their draws (largest first), then the
    non-members in index order."""
    scores = torch.where(member, draws, torch.full_like(draws, -1.0))
    return torch.argsort(-scores, dim=-1, stable=True)


def _masked_overlaps(boxes, gt_box, gt_valid):
    """IoU against the valid gt only -> (max (B, N), argmax (B, N))."""
    ov = bbox_overlap(boxes, gt_box[..., :6])
    ov = torch.where(gt_valid[..., None, :], ov, torch.full_like(ov, -1.0))
    return ov.amax(dim=-1), ov.argmax(dim=-1)


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (B, G, ...) gathered along dim 1 by idx (B, N) -> (B, N, ...)."""
    flat = idx.reshape(idx.shape[0], -1)
    if values.dim() == 2:
        return torch.gather(values, 1, flat).reshape(idx.shape)
    tail = values.shape[2:]
    out = torch.gather(values, 1, flat.reshape(*flat.shape, *([1] * len(tail))).expand(*flat.shape, *tail))
    return out.reshape(*idx.shape, *tail)


def _inflate_gt_for_level3(gt_box: torch.Tensor) -> torch.Tensor:
    """Level-3 thin-box inflation (anchor_target_layer.py:175-203): thin
    classes get +-2 voxels along their thinnest dim, all others are
    y-degenerated (miny + 100, maxy - 100) so they match no level-3 anchor."""
    label = gt_box[..., 6].to(torch.int32)
    is_thin = torch.zeros_like(label, dtype=torch.bool)
    for c in _LEVEL3_THIN_CLASSES:
        is_thin = is_thin | (label == c)
    sz = gt_box[..., 3:6] - gt_box[..., :3]
    thinnest = torch.argmin(sz, dim=-1)  # ties: the first, x <= y <= z, as jnp.argmin
    delta_lo = torch.zeros_like(gt_box[..., :3]).scatter(-1, thinnest[..., None], -2.0)
    inflated = torch.cat([gt_box[..., :3] + delta_lo, gt_box[..., 3:6] - delta_lo, gt_box[..., 6:]], -1)
    squash = torch.cat([gt_box[..., 0:1], gt_box[..., 1:2] + 100.0, gt_box[..., 2:3], gt_box[..., 3:4],
                        gt_box[..., 4:5] - 100.0, gt_box[..., 5:6], gt_box[..., 6:]], -1)
    return torch.where(is_thin[..., None], inflated, squash)


def anchor_targets(draws: torch.Tensor, level_anchor_arrays: dict, level_inside_masks: dict, gt_box, gt_valid,
                   rpn_batchsize: int, rpn_fg_fraction: float, pos_overlap: float, neg_overlap: float) -> dict:
    """Per-level RPN training targets for a batch.

    draws: (B, 2, N) uniform draws, N the anchors of all levels (fg, then
    bg subsampling); level_anchor_arrays {lvl: (N_l, 6)}; level_inside_masks
    {lvl: (N_l,) bool}; gt_box (B, G, 7); gt_valid (B, G). Returns {lvl:
    dict(labels (B, N_l) int32 in {-1, 0, 1}, bbox_targets, inside_w,
    outside_w (B, N_l, 6))}. As in the reference: labels on inside anchors
    only, fg/bg subsampling joint across levels, outside weights normalised
    by each level's positive count.
    """
    levels = sorted(level_anchor_arrays)
    labels_per_level, argmax_per_level = {}, {}
    for lvl in levels:
        anchors = level_anchor_arrays[lvl]
        inside = level_inside_masks[lvl]
        gt = _inflate_gt_for_level3(gt_box) if lvl == 3 else gt_box
        max_ov, argmax = _masked_overlaps(anchors, gt, gt_valid)
        labels = torch.full_like(argmax, -1, dtype=torch.int32)
        labels = torch.where(max_ov >= pos_overlap, 1, labels)
        labels = torch.where(max_ov < neg_overlap, 0, labels)
        labels = torch.where(inside, labels, -1)
        labels_per_level[lvl] = labels.to(torch.int32)
        argmax_per_level[lvl] = argmax

    # joint subsampling (anchor_target_layer.py:252-270)
    all_labels = torch.cat([labels_per_level[l] for l in levels], dim=1)
    fg = all_labels == 1
    fg_keep = _rank_select(draws[:, 0], fg, int(rpn_fg_fraction * rpn_batchsize))
    all_labels = torch.where(fg & ~fg_keep, -1, all_labels)
    bg = all_labels == 0
    bg_keep = _rank_select(draws[:, 1], bg, rpn_batchsize - (all_labels == 1).sum(dim=1))
    all_labels = torch.where(bg & ~bg_keep, -1, all_labels).to(torch.int32)

    out = {}
    off = 0
    for lvl in levels:
        anchors = level_anchor_arrays[lvl]
        n = anchors.shape[0]
        labels = all_labels[:, off:off + n]
        off += n
        targets = bbox_transform(anchors, _take(gt_box[..., :6], argmax_per_level[lvl]))
        pos = labels == 1
        ones = torch.ones((1, 1, 6), dtype=torch.float32, device=labels.device)
        inside_w = torch.where(pos[..., None], 1.0, 0.0) * ones
        npos = torch.clamp(pos.sum(dim=1), min=1)
        outside_w = torch.where(pos[..., None], 1.0 / npos[:, None, None], 0.0) * ones
        out[lvl] = {
            "labels": labels,
            "bbox_targets": torch.where(level_inside_masks[lvl][:, None], targets, 0.0),
            "inside_w": inside_w,
            "outside_w": outside_w,
        }
    return out


def proposal_targets(draws: torch.Tensor, rois, roi_valid, level_inds, gt_box, gt_valid, num_classes: int,
                     class_batch_size: int, fg_fraction: float, fg_thresh: float, bg_thresh: float,
                     bg_thresh_lo: float, use_gt: bool = True) -> dict:
    """Sample CLASS_BATCH_SIZE rois per sample with labels and per-class
    regression targets (``proposal_target_layer.py:13-171``).

    draws: (B, 2, R') uniform draws (fg, then bg ranking), R' = R + G with
    ``use_gt`` (the gt boxes join the candidates, at level 1 if every dim is
    <= 20, else level 2), else R. rois (B, R, 6), roi_valid (B, R),
    level_inds (B, R). Rows are fixed: the first num_fg are foreground; a
    pool smaller than its quota cycles. Returns dict(rois (B, S, 6), labels
    (B, S) int32, level_inds (B, S), bbox_targets, inside_w, outside_w
    (B, S, 6C), valid (B, S)).
    """
    if use_gt:
        dims = gt_box[..., 3:6] - gt_box[..., :3]
        gt_levels = torch.where((dims <= 20.0).all(dim=-1), 1.0, 2.0).to(level_inds.dtype)
        rois = torch.cat([rois, gt_box[..., :6]], dim=1)
        level_inds = torch.cat([level_inds, gt_levels], dim=1)
        roi_valid = torch.cat([roi_valid, gt_valid], dim=1)

    max_ov, assignment = _masked_overlaps(rois, gt_box, gt_valid)
    roi_labels = _take(gt_box[..., 6], assignment)

    fg = roi_valid & (max_ov >= fg_thresh)
    bg = roi_valid & (max_ov < bg_thresh) & (max_ov >= bg_thresh_lo)
    fg_count = fg.sum(dim=1)
    bg_count = bg.sum(dim=1)

    quota_fg = int(round(fg_fraction * class_batch_size))
    # the reference's case analysis (proposal_target_layer.py:95-124): no bg
    # -> every row fg (resampled); no fg -> every row bg
    zero = torch.zeros_like(fg_count)
    num_fg = torch.where(bg_count > 0, torch.clamp(fg_count, max=quota_fg),
                         torch.where(fg_count > 0, zero + class_batch_size, zero))

    fg_ranked = _ranked_indices(draws[:, 0], fg)
    bg_ranked = _ranked_indices(draws[:, 1], bg)
    b = class_batch_size
    row = torch.arange(b, device=rois.device)[None]
    is_fg_row = row < num_fg[:, None]
    fg_idx = torch.gather(fg_ranked, 1, row % torch.clamp(fg_count, min=1)[:, None])
    bg_idx = torch.gather(bg_ranked, 1, (row - num_fg[:, None]) % torch.clamp(bg_count, min=1)[:, None])
    keep = torch.where(is_fg_row, fg_idx, bg_idx)

    out_rois = _take(rois, keep)
    out_levels = _take(level_inds, keep)
    labels = torch.where(is_fg_row, _take(roi_labels, keep), 0.0).to(torch.int32)
    valid = torch.where(is_fg_row, (fg_count > 0)[:, None], (bg_count > 0)[:, None])
    # degenerate fallback (reference lines 118-124)
    valid = valid | _take(roi_valid, keep)

    targets6 = bbox_transform(out_rois, _take(gt_box[..., :6], _take(assignment, keep)))
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).to(targets6.dtype)
    # (B, S, C, 6) -> (B, S, 6C), class-major blocks (6 * cls + d,
    # proposal_target_layer.py:161-164)
    bbox_targets = (onehot[..., None] * targets6[..., None, :]).reshape(*labels.shape, -1)
    inside_w = (onehot * (labels > 0)[..., None])[..., None].expand(*labels.shape, num_classes, 6)
    inside_w = inside_w.reshape(*labels.shape, -1)
    outside_w = (inside_w > 0).to(targets6.dtype)
    return {
        "rois": out_rois,
        "labels": labels,
        "level_inds": out_levels,
        "bbox_targets": bbox_targets,
        "inside_w": inside_w,
        "outside_w": outside_w,
        "valid": valid,
    }


def mask_targets(rois, roi_valid, gt_box, gt_valid, mask_fg_thresh: float, max_mask_rois: int) -> dict:
    """Mask-training rois per sample (``mask_target_layer.py:10-50``): the
    candidates are the proposals and the gt boxes, the foreground those with
    IoU >= MASK_FG_THRESH to a gt box, the first ``max_mask_rois`` of them
    in candidate order kept. Returns dict(rois (B, M, 6) rounded, labels
    (B, M) int32, valid (B, M))."""
    cand = torch.cat([rois, gt_box[..., :6]], dim=1)
    cand_valid = torch.cat([roi_valid, gt_valid], dim=1)
    max_ov, assignment = _masked_overlaps(cand, gt_box, gt_valid)
    fg = cand_valid & (max_ov >= mask_fg_thresh)

    # the first M fg, in order
    m = max_mask_rois
    rank = torch.cumsum(fg.to(torch.int64), dim=1) - 1
    slot = torch.where(fg & (rank < m), rank, m)
    src = torch.arange(cand.shape[1], device=cand.device).expand_as(slot)
    gather = torch.zeros((cand.shape[0], m + 1), dtype=torch.int64, device=cand.device).scatter(1, slot, src)[:, :m]
    valid = torch.arange(m, device=cand.device)[None] < torch.clamp(fg.sum(dim=1), max=m)[:, None]
    gather = torch.where(valid, gather, 0)

    sel_rois = torch.round(_take(cand, gather))  # half to even, as jnp.round
    labels = _take(gt_box[..., 6], _take(assignment, gather)).to(torch.int32)
    return {"rois": sel_rois, "labels": labels, "valid": valid}
