"""Depth/semantic/instance rendering from annotated triangle meshes.

TPU-native replacement for the reference's DirectX render-then-fuse step
(``datagen/ScanReal/src/Fuser.cpp:21-132`` renders depth + semantics +
instance ids per frame via ``Scene::renderDepthSemantics`` before TSDF
integration). This lets ``tsdf_fusion.fuse_scene`` regenerate scenes from
the annotated ``.ply`` alone — no exported sensor frames required.

Offline datagen runs on the host, so this is a vectorized numpy z-buffer:
faces are projected in chunks, rasterized over per-chunk fixed-size pixel
windows with barycentric coverage, and resolved with a two-pass depth
buffer (scatter-min, then attribute assignment where the depth matches).
Typical annotated ScanNet meshes have few-pixel triangles at datagen
resolution, so the fast path covers almost everything; oversized triangles
fall back to a per-face path.

A copy of the JAX package's ``tpu3dsis/datagen/mesh_render.py``, numpy on the host as the
original is; ``tests/test_torch_datagen.py`` holds its outputs equal to
the original's.
"""

from __future__ import annotations

import numpy as np


def _project(vertices, intrinsic, world_to_camera):
    """world verts (N, 3) -> (pixel_x, pixel_y, depth) under the reference's
    pinhole model (intrinsic[0,0]=fx, [1,1]=fy, [0,2]=cx, [1,2]=cy)."""
    v = np.concatenate([vertices, np.ones((len(vertices), 1))], axis=1)
    cam = v @ world_to_camera.T
    z = cam[:, 2]
    safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
    px = cam[:, 0] / safe * intrinsic[0, 0] + intrinsic[0, 2]
    py = cam[:, 1] / safe * intrinsic[1, 1] + intrinsic[1, 2]
    return px, py, z


class MeshRenderer:
    """Rasterize an annotated mesh into depth/semantic/instance frames.

    vertices: (N, 3) float world coords; faces: (M, 3) int; semantics /
    instances: per-FACE attributes ((M,), any int dtype). Use
    :func:`vertex_to_face_attr` for per-vertex annotations.
    """

    def __init__(self, vertices, faces, semantics=None, instances=None,
                 colors=None):
        self.vertices = np.asarray(vertices, np.float64)
        self.faces = np.asarray(faces, np.int64)
        self.semantics = (
            None if semantics is None else np.asarray(semantics)
        )
        self.instances = (
            None if instances is None else np.asarray(instances)
        )
        # per-face albedo (M, 3) in [0, 255] -> shaded RGB frames (the
        # reference renders lit color via phong.hlsl for the 2D ENet stream,
        # datagen/SUNCGScan/shaders/phong.hlsl:1-107; Lambertian with a
        # headlight at the camera reproduces that capability)
        self.colors = None if colors is None else np.asarray(colors, np.float64)
        if self.colors is not None:
            assert self.colors.shape == (len(self.faces), 3)
            v = self.vertices
            f = self.faces
            n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
            norm = np.linalg.norm(n, axis=1, keepdims=True)
            self._face_normals = n / np.maximum(norm, 1e-12)
        if self.semantics is not None:
            assert len(self.semantics) == len(self.faces)
        if self.instances is not None:
            assert len(self.instances) == len(self.faces)

    def render(self, intrinsic, camera_to_world, width, height,
               near=0.4, far=4.0, window=12, chunk=65536):
        """-> dict(depth (H, W) f32 [0 = no hit], face (H, W) int64 [-1],
        semantic (H, W), instance (H, W)) for one camera pose."""
        world_to_camera = np.linalg.inv(np.asarray(camera_to_world, np.float64))
        px, py, z = _project(self.vertices, intrinsic, world_to_camera)

        f = self.faces
        fx = np.stack([px[f[:, 0]], px[f[:, 1]], px[f[:, 2]]], 1)  # (M, 3)
        fy = np.stack([py[f[:, 0]], py[f[:, 1]], py[f[:, 2]]], 1)
        fz = np.stack([z[f[:, 0]], z[f[:, 1]], z[f[:, 2]]], 1)

        # cull: any vertex behind the near plane or fully out of frustum
        keep = (fz > near).all(1) & (fz < far).any(1)
        x0 = np.floor(fx.min(1)).astype(np.int64)
        x1 = np.ceil(fx.max(1)).astype(np.int64)
        y0 = np.floor(fy.min(1)).astype(np.int64)
        y1 = np.ceil(fy.max(1)).astype(np.int64)
        keep &= (x1 >= 0) & (x0 < width) & (y1 >= 0) & (y0 < height)
        idx_all = np.nonzero(keep)[0]

        depth = np.full(height * width, np.inf, np.float32)
        fbuf = np.full(height * width, -1, np.int64)

        small = idx_all[
            (x1[idx_all] - x0[idx_all] < window)
            & (y1[idx_all] - y0[idx_all] < window)
        ]
        large = np.setdiff1d(idx_all, small, assume_unique=True)

        for start in range(0, len(small), chunk):
            ids = small[start : start + chunk]
            self._raster_chunk(
                ids, fx, fy, fz, x0, y0, window, width, height, near, far,
                depth, fbuf,
            )
        for i in large:  # rare oversize triangles: exact per-face window
            w = max(int(x1[i] - x0[i]) + 1, int(y1[i] - y0[i]) + 1)
            self._raster_chunk(
                np.array([i]), fx, fy, fz, x0, y0, w, width, height, near,
                far, depth, fbuf,
            )

        depth = np.where(np.isfinite(depth), depth, 0.0).reshape(height, width)
        fbuf = fbuf.reshape(height, width)
        out = {"depth": depth.astype(np.float32), "face": fbuf}
        for name, attr in (("semantic", self.semantics),
                           ("instance", self.instances)):
            if attr is not None:
                img = np.zeros((height, width), attr.dtype)
                hit = fbuf >= 0
                img[hit] = attr[fbuf[hit]]
                out[name] = img
        if self.colors is not None:
            # Lambertian, headlight at the camera: two-sided |n . l| (box
            # meshes have arbitrary winding) + ambient floor
            cam_fwd = np.asarray(camera_to_world, np.float64)[:3, 2]
            lambert = np.abs(self._face_normals @ cam_fwd)
            ambient = 0.3
            shade = ambient + (1.0 - ambient) * lambert  # (M,)
            img = np.zeros((height, width, 3), np.uint8)
            hit = fbuf >= 0
            fid = fbuf[hit]
            img[hit] = np.clip(
                self.colors[fid] * shade[fid][:, None], 0, 255
            ).astype(np.uint8)
            out["color"] = img
        return out

    def _raster_chunk(self, ids, fx, fy, fz, x0, y0, window, width, height,
                      near, far, depth, fbuf):
        """Barycentric raster of `ids` over (window x window) pixel tiles
        anchored at each face's bbox corner; two-pass z-buffer resolve."""
        if len(ids) == 0:
            return
        ax, ay = fx[ids, 0], fy[ids, 0]
        bx, by = fx[ids, 1], fy[ids, 1]
        cx, cy = fx[ids, 2], fy[ids, 2]
        area = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay)
        ok = np.abs(area) > 1e-12  # degenerate faces drop out
        inv_area = np.where(ok, 1.0 / np.where(ok, area, 1.0), 0.0)

        gx = x0[ids][:, None, None] + np.arange(window)[None, None, :] + 0.5
        gy = y0[ids][:, None, None] + np.arange(window)[None, :, None] + 0.5
        w0 = ((bx[:, None, None] - gx) * (cy[:, None, None] - gy)
              - (cx[:, None, None] - gx) * (by[:, None, None] - gy))
        w1 = ((cx[:, None, None] - gx) * (ay[:, None, None] - gy)
              - (ax[:, None, None] - gx) * (cy[:, None, None] - gy))
        w2 = ((ax[:, None, None] - gx) * (by[:, None, None] - gy)
              - (bx[:, None, None] - gx) * (ay[:, None, None] - gy))
        s = np.sign(area)[:, None, None]
        inside = (
            (w0 * s >= 0) & (w1 * s >= 0) & (w2 * s >= 0)
            & ok[:, None, None]
        )
        # perspective-correct depth: interpolate 1/z with barycentrics
        b0 = w0 * inv_area[:, None, None]
        b1 = w1 * inv_area[:, None, None]
        b2 = w2 * inv_area[:, None, None]
        inv_z = (
            b0 / fz[ids, 0][:, None, None]
            + b1 / fz[ids, 1][:, None, None]
            + b2 / fz[ids, 2][:, None, None]
        )
        zpix = 1.0 / np.maximum(inv_z, 1e-12)
        pix_x = np.floor(gx).astype(np.int64)
        pix_y = np.floor(gy).astype(np.int64)
        inside &= (
            (pix_x >= 0) & (pix_x < width) & (pix_y >= 0) & (pix_y < height)
            & (zpix > near) & (zpix < far)
        )
        flat = np.where(inside, pix_y * width + pix_x, 0).ravel()
        zflat = np.where(inside, zpix, np.inf).astype(np.float32).ravel()
        sel = np.isfinite(zflat)
        flat, zflat = flat[sel], zflat[sel]
        face_ids = np.broadcast_to(
            ids[:, None, None], inside.shape
        ).ravel()[sel]
        # pass 1: depth winner per pixel; pass 2: its face id
        np.minimum.at(depth, flat, zflat)
        match = zflat <= depth[flat]
        fbuf[flat[match]] = face_ids[match]


def vertex_to_face_attr(faces, vertex_attr):
    """Per-vertex annotation -> per-face (first vertex, the reference's
    nearest-vertex convention for flat-shaded annotated meshes)."""
    return np.asarray(vertex_attr)[np.asarray(faces)[:, 0]]


def render_and_fuse(vertices, faces, semantics, instances, poses, intrinsic,
                    width, height, voxel_size, pad=16, depth_min=0.4,
                    depth_max=4.0):
    """Full Fuser.cpp equivalent: render every pose and TSDF-fuse.

    -> (VoxelGrid, world_to_grid) with semantics/instances integrated; pair
    with tsdf_fusion.save_scsdf / save_aabbs for the on-disk formats.
    """
    from tpu3dsis_torch.datagen.tsdf_fusion import VoxelGrid, make_world_to_grid

    renderer = MeshRenderer(vertices, faces, semantics, instances)
    bb_min = vertices.min(0)
    bb_max = vertices.max(0)
    dims = np.round((bb_max - bb_min) / voxel_size).astype(int) + 2 * pad
    w2g = make_world_to_grid(bb_min, voxel_size, pad)
    grid = VoxelGrid(tuple(dims), w2g, voxel_size, depth_min, depth_max)
    for pose in poses:
        frame = renderer.render(
            intrinsic, pose, width, height, depth_min, depth_max
        )
        if not (frame["depth"] > 0).any():
            continue
        grid.integrate(
            intrinsic, pose, frame["depth"],
            label=frame.get("semantic"), instance=frame.get("instance"),
        )
    grid.normalize_sdfs()
    return grid, w2g
