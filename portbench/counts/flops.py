"""The model's floating-point operations, counted from its layer shapes: 2
per multiply-add of every conv and linear (biases, activations, pools and
the softmax left out), at the sizes a room or a training step needs: the
mask FCN on each box's exact crop, which is what the model needs whatever
windows an implementation cuts."""

from __future__ import annotations

import numpy as np

from portbench.reference import nets


def conv3d(cin, cout, k, out_voxels) -> float:
    return 2.0 * cin * cout * k**3 * out_voxels


def _stream(layers, voxels) -> tuple:
    """FLOPs of a backbone stream on ``voxels`` input voxels, and the voxels
    it ends at (a stride-2 conv divides them by 8)."""
    total = 0.0
    for layer in layers or []:
        if layer[0] == "conv":
            _, _, cin, cout, k, stride, _, _ = layer
            voxels //= stride**3
            total += conv3d(cin, cout, k, voxels)
        elif layer[0] == "bneck":
            inp, planes = layer[2], layer[3]
            total += conv3d(inp, planes, 1, voxels) + conv3d(planes, planes, 3, voxels) + conv3d(planes, inp, 1, voxels)
    return total, voxels


def backbone(model: dict, shape) -> dict:
    """{stream: FLOPs} of one chunk or tile of ``shape`` voxels."""
    g1, color, g2 = nets.STREAMS[model["NET"]](bool(model["USE_IMAGES"]))
    n = shape[0] * shape[1] * shape[2]
    out = {"geometry1": _stream(g1, n)[0]}
    if color is not None:
        out["color"] = _stream(color, n)[0]
    out["geometry2"] = _stream(g2, n // nets.FEAT_STRIDE**3)[0]
    return out


def rpn(model: dict, shape) -> float:
    n = (shape[0] // 4) * (shape[1] // 4) * (shape[2] // 4)
    rc = int(model["RPN_CHANNELS"])
    total = 0.0
    for lvl in (1, 2):
        a = int(model[f"NUM_ANCHORS_LEVEL{lvl}"])
        total += conv3d(128, rc, 3, n) + conv3d(rc, 2 * a, 1, n) + conv3d(rc, 6 * a, 1, n)
    return total


def classifier(model: dict, rois: int) -> float:
    p, nc = int(model["CLASS_POOLING_SIZE"]), int(model["NUM_CLASSES"])
    per = 128 * p**3 * 256 + 256 * 256 + 256 * 128 + 128 * nc + 128 * 6 * nc
    return 2.0 * per * rois


def mask_fcn(model: dict, voxels: int) -> float:
    nc = int(model["NUM_CLASSES"])
    return conv3d(2, 64, 3, voxels) + 4 * conv3d(64, 64, 3, voxels) + conv3d(64, nc, 1, voxels)


def enet(height: int = 256, width: int = 328) -> float:
    """ENet modules 0-25 on one (H, W) image."""
    h, w = height // 2, width // 2
    total = 2.0 * 3 * 13 * 9 * h * w
    for blk in nets.enet_blocks():
        kind, cin, mid = blk[0], blk[2], blk[3]
        cout = blk[4] if kind == "down" else cin
        if kind == "down":
            total += 2.0 * cin * mid * 4 * (h // 2) * (w // 2)
            h, w = h // 2, w // 2
        else:
            total += 2.0 * cin * mid * h * w
        total += 2.0 * mid * mid * (10 if kind == "asym" else 9) * h * w
        total += 2.0 * mid * cout * h * w
    return total


def box_voxels(box) -> int:
    """Voxels of a box rounded to the grid, at least one a side: the exact
    crop the mask FCN needs for it."""
    r = np.round(np.asarray(box, np.float64)).astype(np.int64)
    return int(np.prod(np.maximum(r[3:6] - r[:3], 1)))


def room(model: dict, serve: dict, shape, views: int, boxes) -> dict:
    """A served room's FLOPs by part: the ENet over its views, the tiles'
    backbone and RPN, the classifier over every tile's rois, the mask FCN
    over each served detection's exact crop."""
    tile = tuple(serve["TPU_TILE_SIZE"])
    stride = tuple(serve["TPU_TILE_STRIDE"])
    tiles = 1
    for e, t, s in zip(shape, tile, stride):
        tiles *= 1 if e <= t else len(range(0, e - t, s)) + 1
    bb = backbone(model, tile)
    return {"enet": enet(*serve["IMAGE_SHAPE"][::-1]) * views,
            "backbone": sum(bb.values()) * tiles,
            "rpn": rpn(model, tile) * tiles,
            "classifier": classifier(model, int(serve["TEST"]["RPN_POST_NMS_TOP_N"]) * tiles),
            "mask": mask_fcn(model, sum(box_voxels(b) for b in boxes))}


def train_step(model: dict, train: dict, batch: int, gt_boxes) -> dict:
    """A training step's FLOPs by part, forward and backward: the forward of
    every part, and twice the forward of each part a gradient passes
    through or that trains (the ``FIX_*`` keys decide). ``gt_boxes``: each
    sample's valid gt boxes; the mask rois are counted as
    ``TPU_MAX_MASK_ROIS`` of them, cycled, each on its exact crop."""
    shape = tuple(train["TPU_TILE_SIZE"])
    bb = backbone(model, shape)
    views = int(train["NUM_IMAGES"]) if model["USE_IMAGES"] else 0
    m = int(train["TPU_MAX_MASK_ROIS"])
    mask_vox = sum(box_voxels(boxes[i % len(boxes)]) for boxes in gt_boxes for i in range(m if len(boxes) else 0))
    fwd = {"enet": enet(*train["IMAGE_SHAPE"][::-1]) * views * batch,
           "backbone": sum(bb.values()) * batch,
           "rpn": rpn(model, shape) * batch,
           "classifier": classifier(model, int(train["CLASS_BATCH_SIZE"]) * batch),
           "mask": mask_fcn(model, mask_vox)}
    # the RPN's and the classifier's losses exist only where they train; a
    # gradient from them passes the backbone where it or the ENet before it
    # trains; the mask FCN reads the TSDF alone
    detect_loss = not train["FIX_RPN"] or not train["FIX_CLASS"]
    enet_trains = bool(model["USE_IMAGES"]) and not train["FIX_ENET"]
    grad = {"enet": detect_loss and enet_trains,
            "backbone": detect_loss and (enet_trains or not train["FIX_BACKBONE"]),
            "rpn": not train["FIX_RPN"], "classifier": not train["FIX_CLASS"], "mask": bool(train["USE_MASK"])}
    return {"forward": fwd, "backward": {k: 2.0 * v if grad[k] else 0.0 for k, v in fwd.items()}}
