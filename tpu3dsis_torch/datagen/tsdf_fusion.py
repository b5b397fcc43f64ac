"""Offline TSDF fusion: depth frames + labels -> weighted TSDF voxel grid.

Python re-implementation of the reference's Windows/DirectX datagen core
(``datagen/ScanReal/src/VoxelGrid.cpp:4-130`` integrate and
``src/Fuser.cpp:21-132`` fuse). No renderer: depth/label/instance images
come from disk (e.g. exported from .sens). The per-voxel loop is vectorized
with numpy — integration is a masked gather/blend over the frustum bbox.

Semantics preserved:
  - truncation(d) = 2.5 * voxel + d * voxel (VoxelGrid.h:33-34, 394-396)
  - weight update w(d) = max(3 * 1.5 * (1 - (d-0.4)/(4-0.4)), 1), weights
    saturate at 255 (VoxelGrid.cpp:62-77)
  - sdf running weighted mean; free-space counter for voxels in front
  - label/instance voting: overwrite when |v.sdf| <= 2*voxel and
    (no label yet or new label nonzero) (VoxelGrid.cpp:79-84)
  - normalizeSDFs divides by voxel size (VoxelGrid.h:54-66); unobserved
    voxels stay -inf
  - world2grid = scale(1/voxel) * translation(-bbox_min + pad*voxel)
    with pad 16 (Fuser.cpp:44-47)

A copy of the JAX package's ``tpu3dsis/datagen/tsdf_fusion.py``, numpy on the host as the
original is; ``tests/test_torch_datagen.py`` holds its outputs equal to
the original's.
"""

from __future__ import annotations

import struct

import numpy as np

NEG_INF = -np.inf


class VoxelGrid:
    def __init__(self, dims, world_to_grid, voxel_size, depth_min=0.4,
                 depth_max=4.0):
        self.dims = tuple(int(d) for d in dims)
        self.world_to_grid = np.asarray(world_to_grid, np.float64)
        self.grid_to_world = np.linalg.inv(self.world_to_grid)
        self.voxel_size = float(voxel_size)
        self.depth_min = float(depth_min)
        self.depth_max = float(depth_max)
        self.truncation = self.voxel_size * 2.5
        self.truncation_scale = self.voxel_size

        self.sdf = np.full(self.dims, NEG_INF, np.float32)
        self.weight = np.zeros(self.dims, np.float32)
        self.free_ctr = np.zeros(self.dims, np.int32)
        self.label = np.zeros(self.dims, np.uint8)
        self.instance = np.zeros(self.dims, np.uint16)

    def _voxel_world_coords(self):
        x, y, z = np.meshgrid(
            np.arange(self.dims[0]),
            np.arange(self.dims[1]),
            np.arange(self.dims[2]),
            indexing="ij",
        )
        homo = np.stack(
            [x.ravel(), y.ravel(), z.ravel(), np.ones(x.size)], axis=0
        ).astype(np.float64)
        return self.grid_to_world @ homo  # (4, N) world coords of voxel corners

    def integrate(self, intrinsic, camera_to_world, depth, label=None,
                  instance=None):
        """One frame. depth: (H, W) meters; label/instance: (H, W) ids."""
        intrinsic = np.asarray(intrinsic, np.float64)
        world_to_camera = np.linalg.inv(np.asarray(camera_to_world, np.float64))
        h, w = depth.shape

        p = world_to_camera @ self._voxel_world_coords()  # (4, N) cam coords
        zc = p[2]
        with np.errstate(divide="ignore", invalid="ignore"):
            px = np.round(p[0] * intrinsic[0, 0] / zc + intrinsic[0, 2])
            py = np.round(p[1] * intrinsic[1, 1] / zc + intrinsic[1, 2])
        in_img = (
            (px >= 0) & (py >= 0) & (px < w) & (py < h) & np.isfinite(px)
            & np.isfinite(py)
        )
        pxi = np.where(in_img, px, 0).astype(np.int64)
        pyi = np.where(in_img, py, 0).astype(np.int64)
        d = depth[pyi, pxi]
        valid = in_img & (d > 0) & (d >= self.depth_min) & (d <= self.depth_max)

        sdf = d - zc
        trunc = self.truncation + d * self.truncation_scale
        observed = valid & (sdf > -trunc)
        sdf = np.clip(sdf, -trunc, trunc)

        # free-space counter: voxel in front of the observation
        free = valid & (zc < d)
        self.free_ctr += free.reshape(self.dims)

        # weight(d)
        depth01 = (d - 0.4) / (4.0 - 0.4)
        w_update = np.maximum(3.0 * 1.5 * (1.0 - depth01), 1.0)

        flat_sdf = self.sdf.reshape(-1)
        flat_w = self.weight.reshape(-1)
        first = observed & (flat_sdf == NEG_INF)
        blend = observed & ~first
        new_sdf = flat_sdf.copy()
        new_sdf[first] = sdf[first]
        denom = flat_w[blend] + w_update[blend]
        new_sdf[blend] = (
            flat_sdf[blend] * flat_w[blend] + sdf[blend] * w_update[blend]
        ) / denom
        new_w = flat_w.copy()
        new_w[observed] = np.minimum(flat_w[observed] + w_update[observed], 255)

        if label is not None:
            lbl = label[pyi, pxi]
            inst = (instance if instance is not None else label)[pyi, pxi]
            near = (
                observed
                & (np.abs(new_sdf) <= 2.0 * self.voxel_size)
                & (np.abs(sdf) <= 2.0 * self.voxel_size)
            )
            flat_l = self.label.reshape(-1)
            write = near & ((flat_l == 0) | (lbl != 0))
            flat_l[write] = lbl[write]
            self.instance.reshape(-1)[write] = inst[write]

        self.sdf = new_sdf.reshape(self.dims)
        self.weight = new_w.reshape(self.dims)

    def normalize_sdfs(self):
        obs = (self.sdf != NEG_INF) & (self.sdf != 0.0)
        self.sdf[obs] /= self.voxel_size

    # --- AABB / mask extraction (VoxelGrid.cpp:105-135) -------------------
    def instance_mask_for_aabb(self, aabb, instance_id, weight_thresh=1,
                               sdf_thresh=1.0):
        """(mask, occ_count, total_count) for one instance box (grid coords)."""
        lo = np.floor(np.asarray(aabb[:3])).astype(int)
        hi = np.ceil(np.asarray(aabb[3:6])).astype(int)
        lo_c = np.clip(lo, 0, np.asarray(self.dims) - 1)
        hi_c = np.clip(hi, None, self.dims)
        mask = np.zeros(tuple(hi_c - lo_c), np.uint16)
        sub_sdf = self.sdf[lo_c[0]:hi_c[0], lo_c[1]:hi_c[1], lo_c[2]:hi_c[2]]
        sub_w = self.weight[lo_c[0]:hi_c[0], lo_c[1]:hi_c[1], lo_c[2]:hi_c[2]]
        sub_i = self.instance[lo_c[0]:hi_c[0], lo_c[1]:hi_c[1], lo_c[2]:hi_c[2]]
        occ = (sub_w >= weight_thresh) & (np.abs(sub_sdf) <= sdf_thresh)
        mask[occ & (sub_i == instance_id)] = 1
        return mask, int((occ & (sub_i == instance_id)).sum()), int(occ.sum())


def make_world_to_grid(bbox_min, voxel_size, pad=16):
    """Fuser.cpp:46: scale(1/voxel) * translation(-bbox_min + pad*voxel)."""
    t = np.eye(4)
    t[:3, 3] = -np.asarray(bbox_min) + pad * voxel_size
    s = np.diag([1.0 / voxel_size] * 3 + [1.0])
    return s @ t


def fuse_scene(
    frames,
    bbox_world,
    voxel_size=0.046875,
    pad=16,
    depth_min=0.4,
    depth_max=4.0,
    debug_mesh_path=None,
):
    """Fuse a list of (intrinsic, pose, depth[, label, instance]) frames.

    bbox_world: (min3, max3) world-space scene bounds. Returns (VoxelGrid,
    world_to_grid) with dims = round(extent/voxel) + 2*pad (Fuser.cpp:43-45).
    debug_mesh_path: write the fused isosurface as a PLY for inspection
    (the reference's s_bDebugOut marching-cubes dump, Fuser.cpp:88-126).
    """
    bmin, bmax = np.asarray(bbox_world[0]), np.asarray(bbox_world[1])
    dims = np.round((bmax - bmin) / voxel_size).astype(int) + 2 * pad
    w2g = make_world_to_grid(bmin, voxel_size, pad)
    grid = VoxelGrid(dims, w2g, voxel_size, depth_min, depth_max)
    for frame in frames:
        grid.integrate(*frame)
    grid.normalize_sdfs()
    if debug_mesh_path:
        from tpu3dsis_torch.datagen.marching_tets import grid_to_mesh
        from tpu3dsis_torch.tools.ply import write_ply

        verts, faces = grid_to_mesh(grid)
        write_ply(debug_mesh_path, verts, faces=faces)
    return grid, w2g


# --- .scsdf / .aabbs binary formats ----------------------------------------


def save_scsdf(path, sdf, voxel_size, bbox_min, bbox_max):
    """VoxelGrid::saveToFile layout used by the SceneSampler reader
    (SceneSampler/main.cpp:193-215): dims, voxel size, world bbox, F-order
    float grid."""
    with open(path, "wb") as f:
        f.write(struct.pack("<QQQ", *[int(d) for d in sdf.shape]))
        f.write(struct.pack("<f", float(voxel_size)))
        f.write(struct.pack("<fff", *[float(v) for v in bbox_min]))
        f.write(struct.pack("<fff", *[float(v) for v in bbox_max]))
        f.write(np.asarray(sdf, np.float32).ravel(order="F").tobytes())


def load_scsdf(path):
    with open(path, "rb") as f:
        buf = f.read()
    off = 0
    dims = struct.unpack_from("<QQQ", buf, off); off += 24
    (voxel_size,) = struct.unpack_from("<f", buf, off); off += 4
    bmin = struct.unpack_from("<fff", buf, off); off += 12
    bmax = struct.unpack_from("<fff", buf, off); off += 12
    n = int(dims[0] * dims[1] * dims[2])
    grid = np.frombuffer(buf, np.float32, n, off).reshape(
        [int(d) for d in dims], order="F"
    )
    return grid.copy(), voxel_size, np.asarray(bmin), np.asarray(bmax)


def save_aabbs(path, boxes, labels, masks):
    """BBHelper::exportAABBsToFile layout (non-SUNCG; BBHelper.h:9-38):
    count, then per box: anchor + 3 axis vectors (axis-aligned), uint16
    label, mask grid (dims as 3x uint64 + uint16 data, F-order)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(boxes)))
        for box, label, mask in zip(boxes, labels, masks):
            lo = np.asarray(box[:3], np.float32)
            ext = np.asarray(box[3:6], np.float32) - lo
            f.write(lo.tobytes())
            f.write(np.array([ext[0], 0, 0], np.float32).tobytes())
            f.write(np.array([0, ext[1], 0], np.float32).tobytes())
            f.write(np.array([0, 0, ext[2]], np.float32).tobytes())
            f.write(struct.pack("<H", int(label)))
            m = np.asarray(mask, np.uint16)
            f.write(struct.pack("<QQQ", *[int(d) for d in m.shape]))
            f.write(m.ravel(order="F").tobytes())


def load_aabbs(path):
    with open(path, "rb") as f:
        buf = f.read()
    off = 0
    (count,) = struct.unpack_from("<Q", buf, off); off += 8
    boxes, labels, masks = [], [], []
    for _ in range(count):
        anchor = np.frombuffer(buf, np.float32, 3, off); off += 12
        ax = np.frombuffer(buf, np.float32, 3, off); off += 12
        ay = np.frombuffer(buf, np.float32, 3, off); off += 12
        az = np.frombuffer(buf, np.float32, 3, off); off += 12
        hi = anchor + ax + ay + az
        (label,) = struct.unpack_from("<H", buf, off); off += 2
        dims = struct.unpack_from("<QQQ", buf, off); off += 24
        n = int(dims[0] * dims[1] * dims[2])
        mask = np.frombuffer(buf, np.uint16, n, off).reshape(
            [int(d) for d in dims], order="F"
        )
        off += n * 2
        boxes.append(np.concatenate([anchor, hi]))
        labels.append(int(label))
        masks.append(mask.copy())
    return np.asarray(boxes, np.float32), np.asarray(labels), masks
