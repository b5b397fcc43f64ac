"""The benchmark's one traffic generator: rooms and training chunks from a
seed, as a traffic file (``portbench/traffic/<mix>.json``) describes them.

Rooms are furnished boxes in a walled room (about a third sofas, then
chairs and tables, on the floor, 0.1 m apart), with cameras 1.55 +- 0.15 m
high pitched down 11 +- 8 degrees, most looking at a piece of furniture:
the generator of ``chip_smoke.py`` (``room_objects``, ``room_tsdf``,
``room_cameras``, ``render_views``, ``make_color_scene``), frozen here. The
views are ray-cast at the depth maps' 41x32 and upsampled 8x to the
328x256 images. The TSDF and the views are computed on the device, in
bulk.

The sizes are a fixed set, the same for every seed: the seed draws the
rooms' contents and the order in which sizes meet contents and are served.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"

VOXEL = 0.046875  # benchmark.yml's VOXEL_SIZE
ROOM_OFFSET = np.array([6.0, 0.0, 6.0])
WALL_HEIGHT_M = 2.4
KIND_DIMS_M = {"sofa": ((2.2, 2.6), (0.8, 1.1), (0.9, 1.2)), "chair": ((0.45, 0.7), (0.4, 0.65), (0.45, 0.7)),
               "table": ((0.75, 1.05), (0.18, 0.33), (0.75, 1.05))}
FLOOR_RGB, WALL_RGB = (90, 80, 70), (120, 120, 120)


def load(name: str) -> dict:
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


def room_objects(rng, room_m, n_objects):
    """(lo, hi) world boxes in metres and each box's kind."""
    ex, _, ez = room_m
    kinds = ["sofa"] * max(1, n_objects // 3)
    kinds += ["chair", "table"] * (n_objects - len(kinds))
    placed, placed_kinds = [], []
    for kind in kinds[:n_objects]:
        (dx0, dx1), (dy0, dy1), (dz0, dz1) = KIND_DIMS_M[kind]
        sx, sy, sz = rng.uniform(dx0, dx1), rng.uniform(dy0, dy1), rng.uniform(dz0, dz1)
        if rng.rand() < 0.5:
            sx, sz = sz, sx
        for _ in range(60):
            x0, z0 = rng.uniform(0.2, max(ex - sx - 0.2, 0.3)), rng.uniform(0.2, max(ez - sz - 0.2, 0.3))
            box = (x0, 0.0, z0, x0 + sx, sy, z0 + sz)
            if any(not (box[3] + 0.1 <= b[0] or b[3] + 0.1 <= box[0] or box[5] + 0.1 <= b[2] or b[5] + 0.1 <= box[2])
                   for b in placed):
                continue
            placed.append(box)
            placed_kinds.append(kind)
            break
    return np.asarray(placed, np.float64).reshape(-1, 6), placed_kinds


def room_sdf(extent, room_m, boxes_m, device):
    """The signed distance in voxels to the boxes, the floor and the walls
    (positive in free space) on the (X, Y, Z) grid, float32 on ``device``."""
    g = [torch.arange(n, dtype=torch.float32, device=device) for n in extent]
    x, y, z = g[0][:, None, None], g[1][None, :, None], g[2][None, None, :]
    hi_x, hi_z = (float(v) for v in ROOM_OFFSET[[0, 2]] + np.asarray(room_m)[[0, 2]] / VOXEL)
    lo_x, lo_z = float(ROOM_OFFSET[0]), float(ROOM_OFFSET[2])
    sdf = torch.minimum(torch.minimum(x - lo_x, hi_x - x), torch.minimum(z - lo_z, hi_z - z))
    sdf = torch.minimum(sdf, y)
    for b in boxes_m:
        lo = [float(v) for v in b[:3] / VOXEL + ROOM_OFFSET]
        hi = [float(v) for v in b[3:] / VOXEL + ROOM_OFFSET]
        q = [torch.maximum(lo[0] - x, x - hi[0]), torch.maximum(lo[1] - y, y - hi[1]), torch.maximum(lo[2] - z, z - hi[2])]
        outside = torch.sqrt(sum(torch.clamp(a, min=0) ** 2 for a in q))
        inside = torch.clamp(torch.maximum(torch.maximum(q[0], q[1]), q[2]), max=0)
        sdf = torch.minimum(sdf, outside + inside)
    return sdf


def encode_tsdf(sdf):
    """(X, Y, Z) sdf -> (X, Y, Z, 2): |sdf| truncated at 3, and sdf > -1."""
    return torch.stack([torch.abs(torch.clamp(sdf, -3.0, 3.0)), (sdf > -1).float()], -1)


def camera_pose(eye, yaw_deg, pitch_deg):
    yaw, pitch = np.radians(yaw_deg), np.radians(pitch_deg)
    ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
    rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)], [0, np.sin(pitch), np.cos(pitch)]])
    r = ry @ rx
    look, up = r[:, 2], r[:, 1]
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = np.cross(up, look), up, look, eye
    return pose


def room_cameras(rng, n_views, room_m, boxes_m):
    ex, _, ez = room_m
    poses = []
    for _ in range(n_views):
        eye = np.array([rng.uniform(0.5, ex - 0.5), np.clip(rng.normal(1.55, 0.15), 1.25, 1.85),
                        rng.uniform(0.5, ez - 0.5)])
        yaw = rng.uniform(0.0, 360.0)
        if len(boxes_m) and rng.rand() < 0.75:
            c = boxes_m[rng.randint(len(boxes_m))]
            d = (c[:3] + c[3:]) / 2 - eye
            yaw = np.degrees(np.arctan2(d[0], d[2])) + rng.normal(0, 10)
        poses.append(camera_pose(eye, yaw, rng.normal(11.0, 8.0)))
    return np.asarray(poses, np.float32)


def render_views(poses, intrinsic, room_m, boxes_m, colors, device, depth_wh=(41, 32), far=6.0):
    """Ray-cast every view at the depth maps' size, all views at once on
    ``device`` in float64: (V, H, W) z-depth in metres (0 where nothing is
    hit within ``far``) and (V, H, W, 3) uint8 RGB. colors: (n_boxes + 5, 6,
    3) albedo per solid and face; the solids are the boxes, the floor and
    the four walls."""
    f64 = dict(dtype=torch.float64, device=device)
    w, h = depth_wh
    fx, fy, cx, cy = intrinsic[0][0], intrinsic[1][1], intrinsic[0][2], intrinsic[1][2]
    v, u = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64), indexing="ij")
    rays = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1).reshape(-1, 3)
    pose = torch.as_tensor(np.asarray(poses, np.float64), **f64)
    o = pose[:, None, :3, 3]  # (V, 1, 3)
    d = torch.einsum("pk,vjk->vpj", rays, pose[:, :3, :3]).contiguous()  # (V, P, 3): camera z = ray parameter
    inv = 1.0 / d
    best = torch.full(d.shape[:2], torch.inf, **f64)
    solid = torch.full(d.shape[:2], -1, dtype=torch.long, device=device)
    face = torch.zeros(d.shape[:2], dtype=torch.long, device=device)
    for i, b in enumerate(np.asarray(boxes_m, np.float64)):  # slabs
        lo, hi = torch.as_tensor(b[:3], **f64), torch.as_tensor(b[3:], **f64)
        t1, t2 = (lo - o) * inv, (hi - o) * inv
        tn, tf = torch.minimum(t1, t2), torch.maximum(t1, t2)
        t_near, t_far = tn.amax(-1), tf.amin(-1)
        hit = (t_near <= t_far) & (t_near > 0) & (t_near < best)
        axis = tn.argmax(-1)
        best = torch.where(hit, t_near, best)
        solid = torch.where(hit, i, solid)
        face = torch.where(hit, 2 * axis + (d.gather(-1, axis[..., None])[..., 0] > 0), face)
    ex, ey, ez = room_m
    for k, (axis, at) in enumerate(((1, 0.0), (0, 0.0), (0, ex), (2, 0.0), (2, ez))):
        t = (at - o[..., axis]) * inv[..., axis]
        p = o + t[..., None] * d
        inside = (p[..., 0] >= -1e-9) & (p[..., 0] <= ex + 1e-9) & (p[..., 2] >= -1e-9) & (p[..., 2] <= ez + 1e-9)
        if axis != 1:
            inside &= (p[..., 1] >= 0) & (p[..., 1] <= ey)
        hit = (t > 0) & inside & (t < best)
        best = torch.where(hit, t, best)
        solid = torch.where(hit, len(boxes_m) + k, solid)
        face = torch.where(hit, 2 * axis, face)
    seen = torch.isfinite(best) & (best <= far)
    depth = torch.where(seen, best, 0.0)
    normal = torch.nn.functional.one_hot(face // 2, 3).to(torch.float64)
    shade = 0.3 + 0.7 * torch.abs((normal * pose[:, None, :3, 2]).sum(-1))
    albedo = torch.as_tensor(np.asarray(colors, np.float64), **f64)[solid.clamp(min=0), face]
    rgb = torch.where(seen[..., None], albedo * shade[..., None], 0.0)
    images = torch.clamp(rgb, 0, 255).to(torch.uint8).reshape(-1, h, w, 3)
    return depth.reshape(-1, h, w).float(), images


def make_room(rng, extent, n_views, n_objects, intrinsic, device):
    """One room: its (X, Y, Z) sdf on ``device``, its object boxes in voxels
    (N, 6) with their kinds, and its frames {images (V, 256, 328, 3) uint8,
    depths (V, 32, 41), poses (V, 4, 4), world_to_grid (4, 4)}."""
    room_m = ((extent[0] - 2 * ROOM_OFFSET[0]) * VOXEL, WALL_HEIGHT_M, (extent[2] - 2 * ROOM_OFFSET[2]) * VOXEL)
    boxes_m, kinds = room_objects(rng, room_m, n_objects)
    colors = np.empty((len(boxes_m) + 5, 6, 3))
    colors[:len(boxes_m)] = rng.randint(60, 220, (len(boxes_m), 1, 3))
    colors[len(boxes_m)] = FLOOR_RGB
    colors[len(boxes_m) + 1:] = WALL_RGB
    colors = np.clip(colors + rng.randint(-25, 26, colors.shape), 0, 255)
    poses = room_cameras(rng, n_views, room_m, boxes_m)
    depths, small = render_views(poses, intrinsic, room_m, boxes_m, colors, device)
    images = small.repeat_interleave(8, dim=1).repeat_interleave(8, dim=2)
    w2g = np.eye(4, dtype=np.float32)
    w2g[[0, 1, 2], [0, 1, 2]] = 1.0 / VOXEL
    w2g[:3, 3] = ROOM_OFFSET
    frames = {"images": images.contiguous().cpu().numpy(), "depths": depths.contiguous().cpu().numpy(), "poses": poses,
              "world_to_grid": w2g}
    boxes = np.concatenate([boxes_m[:, :3] / VOXEL + ROOM_OFFSET, boxes_m[:, 3:] / VOXEL + ROOM_OFFSET], 1)
    return room_sdf(extent, room_m, boxes_m, device), boxes.astype(np.float32), kinds, frames


def room_sizes(mix: dict):
    """The fixed set of (extent, views, objects) of a mix: ``pool`` rooms,
    the extents in turn, view counts from ``view_counts`` evenly spaced
    over ``views`` and object counts spread evenly over ``objects``, each
    in its own stride, so that they meet in many combinations."""
    extents, pool = mix["extents"], int(mix["pool"])
    v_lo, v_hi = mix["views"]
    o_lo, o_hi = mix["objects"]
    counts = np.linspace(v_lo, v_hi, int(mix.get("view_counts", pool))).round().astype(int)
    out = []
    for i in range(pool):
        views = int(counts[(i * 7) % len(counts)])
        objects = int(round(o_lo + (o_hi - o_lo) * ((i * 5) % pool) / max(pool - 1, 1)))
        out.append((tuple(extents[i % len(extents)]), views, objects))
    return out


def rooms(mix: dict, seed: int, intrinsic, device):
    """The pool of rooms: [(encoded TSDF (X, Y, Z, 2) float32 numpy, gt
    boxes, frames)] in a seeded order of the fixed sizes."""
    rng = np.random.RandomState(np.random.SeedSequence(seed).generate_state(4))
    sizes = room_sizes(mix)
    order = rng.permutation(len(sizes))
    out = []
    for i in order:
        extent, views, objects = sizes[i]
        sdf, boxes, _, frames = make_room(rng, extent, views, objects, intrinsic, device)
        out.append((encode_tsdf(sdf).cpu().numpy(), boxes, frames))
    return out


def serve_order(n: int, count: int, seed: int):
    """``count`` indices into a pool of ``n``: seeded permutations one after
    another, none starting with the index the last one ended on."""
    rng = np.random.RandomState(np.random.SeedSequence([seed, 1]).generate_state(4))
    out = []
    while len(out) < count:
        perm = list(rng.permutation(n))
        if out and n > 1 and perm[0] == out[-1]:
            perm[0], perm[-1] = perm[-1], perm[0]
        out += perm
    return out[:count]


# --- training chunks ----------------------------------------------------------------
def _frustum_hits(pose, w2g, intrinsic, origin, chunk, depth_wh=(41, 32), near=0.4, far=4.0):
    """Does a view's frustum (near to far) meet the chunk's box?"""
    w, h = depth_wh
    fx, fy, cx, cy = intrinsic[0][0], intrinsic[1][1], intrinsic[0][2], intrinsic[1][2]
    pts = []
    for dpt in (near, far):
        for ux, uy in ((0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)):
            pts.append([dpt * (ux - cx) / fx, dpt * (uy - cy) / fy, dpt, 1.0])
    g = (np.asarray(w2g, np.float64) @ np.asarray(pose, np.float64) @ np.asarray(pts).T)[:3].T
    lo, hi = g.min(0), g.max(0)
    return bool((hi >= origin).all() and (lo <= np.asarray(origin) + np.asarray(chunk)).all())


def train_pool(mix: dict, seed: int, intrinsic, labels: dict, max_gt: int, device):
    """Chunks cut from generated rooms: a list of dicts {data (X, Y, Z, 2)
    float32, gt_box (max_gt, 7), gt_valid (max_gt,), mask_canvas (X, Y, Z)
    uint8 (the objects' voxels within a voxel of their surface), images (V,
    256, 328, 3) uint8, depths (V, 32, 41), poses (V, 4, 4), view_valid (V,),
    world_to_grid (4, 4) of the chunk's grid}. Every chunk holds at least
    one object wholly."""
    rng = np.random.RandomState(np.random.SeedSequence([seed, 2]).generate_state(4))
    chunk = tuple(mix["chunk"])
    n_views = int(mix["views_per_chunk"])
    sizes = room_sizes(mix)
    order = rng.permutation(len(sizes))
    out = []
    for i in order:
        extent, views, objects = sizes[i]
        sdf, boxes, kinds, frames = make_room(rng, extent, views, objects, intrinsic, device)
        enc = encode_tsdf(sdf)
        made = 0
        for _ in range(200):
            if made == int(mix["chunks_per_room"]):
                break
            o = np.array([rng.randint(0, extent[d] - chunk[d] + 1) for d in range(3)])
            lo, hi = boxes[:, :3] - o, boxes[:, 3:] - o
            whole = (lo >= 0).all(1) & (hi <= np.asarray(chunk)).all(1)
            if not whole.any():
                continue
            keep = np.nonzero(whole)[0][:max_gt]
            gt = np.full((max_gt, 7), -1e4, np.float32)
            gt[:, 3:6] = gt[:, :3] + 1.0
            gt[:, 6] = 0.0
            gt[:len(keep), :3], gt[:len(keep), 3:6] = lo[keep], hi[keep]
            gt[:len(keep), 6] = [labels[kinds[k]] for k in keep]
            valid = np.zeros(max_gt, bool)
            valid[:len(keep)] = True
            sl = tuple(slice(int(o[d]), int(o[d]) + chunk[d]) for d in range(3))
            near = (sdf[sl].abs() <= 1.0)
            inside = torch.zeros(chunk, dtype=torch.bool, device=device)
            for k in keep:
                a, b = np.floor(lo[k]).astype(int), np.ceil(hi[k]).astype(int)
                inside[a[0]:b[0], a[1]:b[1], a[2]:b[2]] = True
            w2g = frames["world_to_grid"].copy()
            w2g[:3, 3] -= o
            seen = [j for j in rng.permutation(len(frames["poses"]))
                    if _frustum_hits(frames["poses"][j], frames["world_to_grid"], intrinsic, o, chunk)]
            seen = (seen + list(rng.permutation(len(frames["poses"]))))[:n_views]
            out.append({"data": enc[sl].cpu().numpy(), "gt_box": gt, "gt_valid": valid,
                        "mask_canvas": (near & inside).to(torch.uint8).cpu().numpy(),
                        "images": frames["images"][seen], "depths": frames["depths"][seen],
                        "poses": frames["poses"][seen], "view_valid": np.ones(n_views, bool),
                        "world_to_grid": w2g})
            made += 1
    return out


def batch_order(n: int, batch: int, steps: int, seed: int):
    """``steps`` batches of ``batch`` chunk indices: seeded permutations of
    the pool cut in turn, so that the rows of consecutive batches differ
    until the pool is spent."""
    rng = np.random.RandomState(np.random.SeedSequence([seed, 3]).generate_state(4))
    out, perm = [], []
    while len(out) < steps:
        if len(perm) < batch:
            perm = list(rng.permutation(n))
        out.append(np.asarray(perm[:batch]))
        perm = perm[batch:]
    return out
