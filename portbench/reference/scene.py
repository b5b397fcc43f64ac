"""A whole room through 3D-SIS in plain PyTorch: the benchmark's reference
for served rooms.

Semantics (3D-SIS's test-time sliding window, ``lib/model/trainval.py``):
the room's encoded TSDF is padded with free space to a multiple of 48
voxels a side (at least one tile); every view's ENet features are fused
into one color volume of that shape; overlapping 96x48x96 tiles at stride
43x9x43 run the backbone, the RPN (top 256 by objectness, greedy NMS at
0.1, the first 32 kept), the RoI pool and the classifier; a tile's
detections (foreground class, confidence above ``CLASS_THRESH``, not
degenerate) move to room coordinates, the best 1024 go through a greedy
NMS per class at 0.25, the first 64 are kept and clipped to the room; each
kept box gets the mask FCN's logits of its class on the exact crop of its
rounded box, thresholded at 0.

``room`` returns the final detections and masks (what a server returns)
and the "pool": every tile's top 512 proposals classified without the
RPN's NMS, each with every class's probability and box, in room coordinates,
which the comparison searches for each served detection, so that an NMS
tie or a close second class decided otherwise in a lower precision does
not read as a wrong answer.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import geometry as G
from portbench.reference import nets as N

TILE = (96, 48, 96)
STRIDE = (43, 9, 43)
BUCKET = 48
# the pool holds this many times the RPN's top proposals, so that a proposal
# the program ranks just inside its top and the reference just outside is there
POOL_FACTOR = 2


def bucket_shape(shape):
    return tuple(-(-max(int(d), t) // BUCKET) * BUCKET for d, t in zip(shape[:3], TILE))


def pad_scene(tsdf: np.ndarray, shape):
    """Pad (X, Y, Z, 2) with free space (|tsdf| 3, occupancy 1)."""
    out = np.empty((*shape, 2), np.float32)
    out[..., 0], out[..., 1] = 3.0, 1.0
    out[:tsdf.shape[0], :tsdf.shape[1], :tsdf.shape[2]] = tsdf
    return out


def origins(shape):
    axes = []
    for e, t, s in zip(shape, TILE, STRIDE):
        axes.append([0] if e <= t else list(range(0, e - t, s)) + [e - t])
    return [(x, y, z) for x in axes[0] for y in axes[1] for z in axes[2]]


class RoomReference:
    """The reference for one configuration and one parameter dict."""

    def __init__(self, cfg: dict, params: dict, prec: N.Precision = N.FP32):
        self.cfg, self.p, self.prec = cfg, params, prec
        self.anchors = {}
        for lvl in (1, 2):
            a, inside = G.level_anchors(cfg[f"ANCHORS_TYPE_LEVEL{lvl}"], TILE)
            dev = params["geometry2.0.weight"].device
            self.anchors[lvl] = (torch.from_numpy(a).to(dev), torch.from_numpy(inside).to(dev))

    @torch.no_grad()
    def color_volume(self, frames: dict, shape):
        cfg = self.cfg
        dev = self.p["geometry2.0.weight"].device
        feats = []
        images = torch.as_tensor(frames["images"])
        for s in range(0, images.shape[0], 32):
            x = N.normalise_images(images[s:s + 32].to(dev), cfg["COLOR_MEAN"], cfg["COLOR_STD"])
            feats.append(N.enet_features(self.p, x, self.prec))
        feats = torch.cat(feats)
        return G.fuse_views(feats, torch.as_tensor(frames["depths"]).to(dev), frames["poses"],
                            frames["world_to_grid"], cfg["INTRINSIC"], shape, cfg["PROJ_DEPTH_MIN"],
                            cfg["PROJ_DEPTH_MAX"], cfg["VOXEL_SIZE"])

    @torch.no_grad()
    def tile(self, scene_t, color_t):
        """One tile (2, X, Y, Z) and (128, X, Y, Z) -> (pool, kept) dicts of
        boxes (tile coords), classes, confidences; pool = the top 256
        proposals classified, kept = the RPN-NMS survivors' detections."""
        cfg, p, prec = self.cfg, self.p, self.prec
        lvl1, lvl2 = N.backbone(p, cfg["NET"], cfg["USE_IMAGES"], scene_t[None],
                                None if color_t is None else color_t[None], prec)
        maps = {1: lvl1, 2: lvl2}
        props, scores, levels, valid = [], [], [], []
        for lvl in (1, 2):
            cls, box = N.rpn_level(p, lvl, maps[lvl], int(cfg[f"NUM_ANCHORS_LEVEL{lvl}"]), prec)
            prob = torch.softmax(cls.float(), dim=4)[0, :, :, :, 1, :].reshape(-1)
            a, inside = self.anchors[lvl]
            props.append(G.clip_boxes(G.bbox_transform_inv(a, box[0].float()), TILE))
            scores.append(prob)
            levels.append(torch.full_like(prob, lvl))
            valid.append(inside)
        props, scores, levels, valid = (torch.cat(t) for t in (props, scores, levels, valid))
        order = torch.sort(scores, descending=True, stable=True)[1]
        order = order[valid[order]]  # anchors outside the volume never propose
        pre_n = int(cfg["TEST"]["RPN_PRE_NMS_TOP_N"])
        pool_idx = order[:POOL_FACTOR * pre_n]
        rois, lv = props[pool_idx], levels[pool_idx].long()
        keep = G.greedy_nms(rois[:pre_n], float(cfg["TEST"]["RPN_NMS_THRESH"]))
        kept = torch.from_numpy(np.nonzero(keep)[0][:int(cfg["TEST"]["RPN_POST_NMS_TOP_N"])]).to(rois.device)
        pool5 = G.roi_pool({1: lvl1[0], 2: lvl2[0]}, rois, lv, int(cfg["CLASS_POOLING_SIZE"]))
        score, deltas = N.classifier(p, pool5, prec)
        prob = torch.softmax(score.float(), dim=-1)
        cls = torch.argmax(score, dim=-1)
        every = G.clip_boxes(G.bbox_transform_inv(rois[:, None, :], deltas.float().reshape(deltas.shape[0], -1, 6)),
                             TILE)  # (R, C, 6): each class's box
        boxes = every[torch.arange(cls.shape[0]), cls]
        conf = prob[torch.arange(cls.shape[0]), cls]
        r = torch.round(boxes)
        ok = (r[:, 3:] > r[:, :3]).all(1) & (cls > 0)
        pool = {"boxes": every, "prob": prob}
        sel = torch.zeros_like(ok)
        sel[kept] = True
        sel &= ok
        return pool, {"boxes": boxes[sel], "classes": cls[sel], "conf": conf[sel]}

    @torch.no_grad()
    def mask(self, scene_t, box, cls):
        """The mask FCN on the exact crop of the rounded box -> (bw, bh, bl)
        uint8, logit of the class >= 0."""
        r = torch.round(torch.as_tensor(box, dtype=torch.float64)).long().tolist()
        dims = [max(r[3 + d] - r[d], 0) for d in range(3)]
        if min(dims) == 0 or min(r[:3]) < 0 or any(r[3 + d] > scene_t.shape[1 + d] for d in range(3)):
            return np.zeros(dims, np.uint8)  # flat at the room's edge, or not a box of this room
        crop = scene_t[:, r[0]:r[3], r[1]:r[4], r[2]:r[5]]
        logits = N.mask_fcn(self.p, crop[None], self.prec)[0, int(cls)]
        return (logits >= 0).to(torch.uint8).cpu().numpy()

    @torch.no_grad()
    def room(self, tsdf: np.ndarray, frames: dict | None):
        cfg = self.cfg
        dev = self.p["geometry2.0.weight"].device
        shape = bucket_shape(tsdf.shape)
        scene = torch.from_numpy(pad_scene(tsdf, shape)).to(dev).permute(3, 0, 1, 2).contiguous()
        color = None
        if cfg["USE_IMAGES"]:
            color = self.color_volume(frames, shape).permute(3, 0, 1, 2).contiguous()
        pools, kept = [], []
        for o in origins(shape):
            sl = (slice(None), slice(o[0], o[0] + TILE[0]), slice(o[1], o[1] + TILE[1]), slice(o[2], o[2] + TILE[2]))
            pool, k = self.tile(scene[sl], None if color is None else color[sl])
            off = torch.tensor([*o, *o], dtype=torch.float32, device=dev)
            pools.append({"boxes": pool["boxes"] + off, "prob": pool["prob"]})
            kept.append({"boxes": k["boxes"] + off, "classes": k["classes"], "conf": k["conf"]})
        extent = tsdf.shape[:3]
        cat = {key: torch.cat([d[key] for d in kept]) for key in ("boxes", "classes", "conf")}
        good = cat["conf"] > float(cfg["CLASS_THRESH"])
        cat = {k: v[good] for k, v in cat.items()}
        order = torch.sort(cat["conf"], descending=True, stable=True)[1][:int(cfg["TPU_FUSED_PRE_NMS"])]
        cat = {k: v[order] for k, v in cat.items()}
        keep = G.greedy_nms(cat["boxes"], float(cfg["TPU_STITCH_NMS_THRESH"]), cat["classes"])
        idx = torch.from_numpy(np.nonzero(keep)[0][:int(cfg["TPU_FUSED_MAX_DETECTIONS"])]).to(dev)
        det = {"pred_box": G.clip_boxes(cat["boxes"][idx], extent).cpu().numpy(),
               "pred_class": cat["classes"][idx].cpu().numpy().astype(np.int32),
               "pred_conf": cat["conf"][idx].cpu().numpy().astype(np.float32)}
        masks = [self.mask(scene, b, c) for b, c in zip(det["pred_box"], det["pred_class"])]
        pool = {k: torch.cat([d[k] for d in pools]) for k in ("boxes", "prob")}
        pool["boxes"] = G.clip_boxes(pool["boxes"], extent)
        return det, masks, {k: v.cpu() for k, v in pool.items()}, scene
