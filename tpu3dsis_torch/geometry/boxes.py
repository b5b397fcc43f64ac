"""3D axis-aligned box math on tensors (``tpu3dsis/geometry/boxes.py``).

Boxes are corner-format ``(minx, miny, minz, maxx, maxy, maxz)``. Every
function takes any leading batch dimensions and keeps the JAX version's
operation order. ``clip_boxes`` and ``nms_overlap`` agree with it to the last
bit on the CPU; ``bbox_transform_inv`` goes through ``exp``, where XLA's and
torch's may round an ulp apart, so its coordinates agree to a few float32
ulps of the decode's largest intermediate. ``bbox_overlap`` agrees to the
last bit; ``bbox_transform`` (the training targets' encoding) goes through
``log``, so its size deltas may differ by an ulp.
"""

from __future__ import annotations

import torch


def bbox_transform(anchor_rois: torch.Tensor, gt_rois: torch.Tensor) -> torch.Tensor:
    """Encode (..., 6) gt boxes against (..., 6) anchors -> (..., 6) center
    and log-size deltas, with the reference's epsilon placement (1e-14 in
    the log argument and on the denominators)."""
    aw = anchor_rois[..., 3] - anchor_rois[..., 0]
    ah = anchor_rois[..., 4] - anchor_rois[..., 1]
    al = anchor_rois[..., 5] - anchor_rois[..., 2]
    acx = anchor_rois[..., 0] + 0.5 * aw
    acy = anchor_rois[..., 1] + 0.5 * ah
    acz = anchor_rois[..., 2] + 0.5 * al

    gw = gt_rois[..., 3] - gt_rois[..., 0]
    gh = gt_rois[..., 4] - gt_rois[..., 1]
    gl = gt_rois[..., 5] - gt_rois[..., 2]
    gcx = gt_rois[..., 0] + 0.5 * gw
    gcy = gt_rois[..., 1] + 0.5 * gh
    gcz = gt_rois[..., 2] + 0.5 * gl

    dx = (gcx - acx) / (aw + 1e-14)
    dy = (gcy - acy) / (ah + 1e-14)
    dz = (gcz - acz) / (al + 1e-14)
    dw = torch.log(gw / (aw + 1e-14) + 1e-14)
    dh = torch.log(gh / (ah + 1e-14) + 1e-14)
    dl = torch.log(gl / (al + 1e-14) + 1e-14)
    return torch.stack([dx, dy, dz, dw, dh, dl], dim=-1)


def bbox_overlap(boxes: torch.Tensor, query_boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 6) x (..., K, 6) -> (..., N, K) 3D IoU with plain extents
    (``lib/utils/overlap.py:5-25``), the convention of target assignment."""
    va = (boxes[..., 3] - boxes[..., 0]) * (boxes[..., 4] - boxes[..., 1]) * (boxes[..., 5] - boxes[..., 2])
    vb = ((query_boxes[..., 3] - query_boxes[..., 0]) * (query_boxes[..., 4] - query_boxes[..., 1])
          * (query_boxes[..., 5] - query_boxes[..., 2]))
    q = query_boxes[..., None, :, :]
    iw = torch.clamp(torch.minimum(boxes[..., 3:4], q[..., 3]) - torch.maximum(boxes[..., 0:1], q[..., 0]), min=0)
    ih = torch.clamp(torch.minimum(boxes[..., 4:5], q[..., 4]) - torch.maximum(boxes[..., 1:2], q[..., 1]), min=0)
    il = torch.clamp(torch.minimum(boxes[..., 5:6], q[..., 5]) - torch.maximum(boxes[..., 2:3], q[..., 2]), min=0)
    inter = iw * ih * il
    union = va[..., :, None] + vb[..., None, :] - inter
    return inter / union


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Decode (..., 6K) deltas against (..., 6) boxes -> (..., 6K).

    Same interleaving as the JAX version: all K minx first, then all miny, ...
    """
    w = boxes[..., 3] - boxes[..., 0]
    h = boxes[..., 4] - boxes[..., 1]
    l = boxes[..., 5] - boxes[..., 2]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    cz = boxes[..., 2] + 0.5 * l

    pcx = deltas[..., 0::6] * w[..., None] + cx[..., None]
    pcy = deltas[..., 1::6] * h[..., None] + cy[..., None]
    pcz = deltas[..., 2::6] * l[..., None] + cz[..., None]
    pw = torch.exp(deltas[..., 3::6]) * w[..., None]
    ph = torch.exp(deltas[..., 4::6]) * h[..., None]
    pl = torch.exp(deltas[..., 5::6]) * l[..., None]
    return torch.cat(
        [
            pcx - 0.5 * pw,
            pcy - 0.5 * ph,
            pcz - 0.5 * pl,
            pcx + 0.5 * pw,
            pcy + 0.5 * ph,
            pcz + 0.5 * pl,
        ],
        dim=-1,
    )


def clip_boxes(boxes: torch.Tensor, scene_shape) -> torch.Tensor:
    """Clamp (..., 6) corner boxes to [0, scene_shape]."""
    sx, sy, sz = (float(s) for s in scene_shape[:3])
    hi = (sx, sy, sz, sx, sy, sz)
    return torch.stack(
        [boxes[..., k].clamp(0, hi[k]) for k in range(6)], dim=-1
    )


def nms_overlap(boxes: torch.Tensor, query_boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 6) x (..., K, 6) -> (..., N, K) IoU with +1 extents."""
    a = boxes[..., :, None, :]
    b = query_boxes[..., None, :, :]
    va = (
        (boxes[..., 3] - boxes[..., 0] + 1)
        * (boxes[..., 4] - boxes[..., 1] + 1)
        * (boxes[..., 5] - boxes[..., 2] + 1)
    )
    vb = (
        (query_boxes[..., 3] - query_boxes[..., 0] + 1)
        * (query_boxes[..., 4] - query_boxes[..., 1] + 1)
        * (query_boxes[..., 5] - query_boxes[..., 2] + 1)
    )
    iw = (
        torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 0], b[..., 0]) + 1
    ).clamp(min=0)
    ih = (
        torch.minimum(a[..., 4], b[..., 4]) - torch.maximum(a[..., 1], b[..., 1]) + 1
    ).clamp(min=0)
    il = (
        torch.minimum(a[..., 5], b[..., 5]) - torch.maximum(a[..., 2], b[..., 2]) + 1
    ).clamp(min=0)
    inter = iw * ih * il
    union = va[..., :, None] + vb[..., None, :] - inter
    return inter / union
