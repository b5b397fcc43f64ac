"""Boxes, anchors, greedy NMS, the RoI max pool and the view fusion, in
plain PyTorch and numpy (3D-SIS's ``lib/utils``, ``lib/layer_utils`` and
``lib/nets/network.py``'s projection), for the benchmark's reference.

Boxes are corner format (minx, miny, minz, maxx, maxy, maxz) in voxels.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ANCHOR_DIR = Path(__file__).resolve().parent.parent / "configs" / "anchors"


def bbox_transform(ex, gt):
    """Encode gt boxes against boxes ex: centre and log-size deltas."""
    ew, gw = ex[..., 3:6] - ex[..., :3], gt[..., 3:6] - gt[..., :3]
    ec, gc = ex[..., :3] + 0.5 * ew, gt[..., :3] + 0.5 * gw
    return torch.cat([(gc - ec) / (ew + 1e-14), torch.log(gw / (ew + 1e-14) + 1e-14)], dim=-1)


def bbox_transform_inv(boxes, deltas):
    """Decode (..., 6) deltas against (..., 6) boxes."""
    w = boxes[..., 3:6] - boxes[..., :3]
    c = boxes[..., :3] + 0.5 * w
    pc = deltas[..., :3] * w + c
    pw = torch.exp(deltas[..., 3:6]) * w
    return torch.cat([pc - 0.5 * pw, pc + 0.5 * pw], dim=-1)


def clip_boxes(boxes, shape):
    hi = torch.tensor([*shape[:3], *shape[:3]], dtype=boxes.dtype, device=boxes.device)
    return torch.minimum(torch.clamp(boxes, min=0), hi)


def iou(a, b):
    """(N, 6) x (K, 6) -> (N, K) IoU with plain extents."""
    lo = torch.maximum(a[:, None, :3], b[None, :, :3])
    hi = torch.minimum(a[:, None, 3:], b[None, :, 3:])
    inter = torch.clamp(hi - lo, min=0).prod(-1)
    va, vb = (a[:, 3:] - a[:, :3]).prod(-1), (b[:, 3:] - b[:, :3]).prod(-1)
    return inter / (va[:, None] + vb[None, :] - inter)


def iou_plus1(a, b):
    """(N, 6) x (K, 6) -> (N, K) IoU with +1 extents (the NMS convention)."""
    lo = torch.maximum(a[:, None, :3], b[None, :, :3])
    hi = torch.minimum(a[:, None, 3:], b[None, :, 3:])
    inter = torch.clamp(hi - lo + 1, min=0).prod(-1)
    va, vb = (a[:, 3:] - a[:, :3] + 1).prod(-1), (b[:, 3:] - b[:, :3] + 1).prod(-1)
    return inter / (va[:, None] + vb[None, :] - inter)


def greedy_nms(boxes, thresh, classes=None):
    """Boxes in descending score order -> (N,) bool keep: a kept box
    suppresses every later one (of its class, given classes) whose +1 IoU
    exceeds thresh. On the host, in numpy."""
    n = boxes.shape[0]
    keep = np.zeros(n, bool)
    if n == 0:
        return keep
    over = (iou_plus1(boxes, boxes) > thresh).cpu().numpy()
    if classes is not None:
        c = classes.cpu().numpy()
        over &= c[:, None] == c[None, :]
    suppressed = np.zeros(n, bool)
    for i in range(n):
        if suppressed[i]:
            continue
        keep[i] = True
        suppressed |= over[i]
    return keep


def read_anchors(name: str) -> np.ndarray:
    """An anchor file's ``w, h, l`` lines -> (A, 6) boxes centred at 0."""
    sizes = np.loadtxt(ANCHOR_DIR / name, delimiter=",", ndmin=2)
    return np.concatenate([-sizes / 2, sizes / 2], axis=1)


def level_anchors(name: str, shape, stride: int = 4):
    """The anchors of one level over a volume of ``shape`` voxels: (K*A, 6)
    float32 (sites x-major, anchors innermost) and the (K*A,) mask of those
    wholly inside the volume."""
    base = read_anchors(name)
    feat = [s // stride for s in shape]
    g = np.meshgrid(*(np.arange(f) * stride for f in feat), indexing="ij")
    shifts = np.stack([g[0].ravel(), g[1].ravel(), g[2].ravel()] * 2, axis=1)
    a = (base[None] + shifts[:, None]).reshape(-1, 6).astype(np.float32)
    inside = (a[:, :3] >= 0).all(1) & (a[:, 3] < shape[0]) & (a[:, 4] < shape[1]) & (a[:, 5] < shape[2])
    return a, inside


def roi_pool(level_maps, rois, levels, pooled: int = 4, stride: int = 4):
    """Max pool of each roi over its level's map: level_maps {lvl: (C, W, H,
    L)} of one sample, rois (R, 6) voxels, levels (R,) ints -> (R, C, P, P,
    P). A roi covers feature voxels floor(lo / stride) to ceil(hi /
    stride) (at least one a side), split into P bins a side with bin p from
    floor(p * n / P) to ceil((p + 1) * n / P): adaptive max pooling of that
    crop. A bin outside the map gives 0."""
    out = []
    r = rois.detach().float().cpu()
    lo = torch.floor(r[:, :3] / stride).long()
    hi = torch.ceil(r[:, 3:] / stride).long()
    size = torch.clamp(hi - lo, min=1)
    for i in range(r.shape[0]):
        f = level_maps[int(levels[i])]
        ext = f.shape[1:]
        a = [int(lo[i, d]) for d in range(3)]
        n = [int(size[i, d]) for d in range(3)]
        if all(a[d] >= 0 and a[d] + n[d] <= ext[d] for d in range(3)):
            crop = f[:, a[0]:a[0] + n[0], a[1]:a[1] + n[1], a[2]:a[2] + n[2]]
            out.append(F.adaptive_max_pool3d(crop[None], pooled)[0])
        else:
            out.append(_roi_pool_clamped(f, a, n, pooled))
    if not out:
        c = next(iter(level_maps.values())).shape[0]
        return rois.new_zeros((0, c, pooled, pooled, pooled))
    return torch.stack(out)


def _roi_pool_clamped(f, a, n, pooled):
    """One roi whose bins reach outside the map: each bin clamped to it, an
    empty bin 0."""
    c, ext = f.shape[0], f.shape[1:]
    bins = []
    for d in range(3):
        bins.append([(min(max(a[d] + (p * n[d]) // pooled, 0), ext[d]),
                      min(max(a[d] + -(-((p + 1) * n[d]) // pooled), 0), ext[d])) for p in range(pooled)])
    cells = []
    for sx, ex in bins[0]:
        for sy, ey in bins[1]:
            for sz, ez in bins[2]:
                if ex > sx and ey > sy and ez > sz:
                    cells.append(f[:, sx:ex, sy:ey, sz:ez].amax(dim=(1, 2, 3)))
                else:
                    cells.append(f.new_zeros(c))
    return torch.stack(cells, -1).reshape(c, pooled, pooled, pooled)


def fuse_views(feats2d, depths, poses, world_to_grid, intrinsic, dims, depth_min, depth_max, voxel_size,
               block: int = 1 << 21):
    """Back-project every view's feature map into a (X, Y, Z, C) volume:
    each voxel centre goes through grid-to-world and world-to-camera into
    the view's depth map; the view is taken where the rounded pixel lies in
    the image, its depth is in [depth_min, depth_max] and within voxel_size
    of the voxel's camera depth, else it gives 0; views fuse by max.
    feats2d (V, H, W, C), depths (V, H, W), poses (V, 4, 4) camera to world,
    world_to_grid (4, 4), intrinsic (4, 4) at the depth maps' size. Float64
    matrices, float32 volume, in blocks of voxels."""
    v, h, w, c = feats2d.shape
    dev = feats2d.device
    g2c = torch.linalg.inv(torch.as_tensor(np.asarray(poses, np.float64), device=dev)) @ torch.linalg.inv(
        torch.as_tensor(np.asarray(world_to_grid, np.float64), device=dev))
    k = np.asarray(intrinsic, np.float64)
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    n = int(np.prod(dims))
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    flat = feats2d.reshape(v, h * w, c).float()
    dflat = depths.reshape(v, h * w).double()
    for s in range(0, n, block):
        idx = torch.arange(s, min(s + block, n), device=dev)
        z = idx % dims[2]
        y = (idx // dims[2]) % dims[1]
        x = idx // (dims[1] * dims[2])
        pts = torch.stack([x, y, z, torch.ones_like(x)], 0).double()
        acc = torch.full((idx.numel(), c), -torch.inf, dtype=torch.float32, device=dev)
        for i in range(v):
            cam = g2c[i, :3] @ pts
            zc = cam[2]
            px = torch.round(cam[0] * fx / zc + cx)
            py = torch.round(cam[1] * fy / zc + cy)
            ok = (zc > 0) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
            pix = (torch.where(ok, py, 0) * w + torch.where(ok, px, 0)).long()
            d = dflat[i][pix]
            ok &= (d >= depth_min) & (d <= depth_max) & ((d - zc).abs() <= voxel_size)
            acc = torch.maximum(acc, torch.where(ok[:, None], flat[i][pix], 0.0))
        out[s:s + idx.numel()] = acc
    out = torch.where(torch.isneginf(out), 0.0, out)
    return out.reshape(*dims, c)
