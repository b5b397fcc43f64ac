"""Virtual-scan generation: sample camera trajectories in a synthetic scene,
render, and TSDF-fuse — the SUNCGScan pipeline rebuilt on the numpy
rasterizer.

Re-implements ``datagen/SUNCGScan/src/ViewGenerator.{h,cpp}`` semantics:

- key-view generation (ViewGenerator.cpp:52-185): a 1.5 m ground-level
  coverage grid per room, visited in zigzag scanline order; per uncovered
  cell up to N candidate cameras (eye uniform in the cell, height/pitch
  drawn from learned view statistics, yaw uniform); each candidate is
  rendered and scored, the first "good enough" one is accepted early;
  with probability 0.5 an extra upward-looking camera (-1.5x pitch) is
  sampled per cell;
- view scoring (ViewGenerator.h:219-306): fraction of valid pixels on
  labeled objects within 6 m, plus a depth-histogram score = erfc
  probability of the 1D-EMD distance to the mean ScanNet depth histogram;
- trajectory interpolation (ViewGenerator.cpp:7-50): Catmull-Rom spline
  between key views at 2 cameras/m (0.01 cameras/rad), dropping cameras
  whose free-space probe fails (the reference intersects a 0.2 m camera
  box with the scene; here the probe renders a thumbnail and requires
  min depth > the same radius) and keeping survivors with p=0.8.

The reference learns ViewStats from real ScanNet trajectories
(initViewStats, a stats CSV); the defaults below are typical human-held
scanner values and every field is constructor-overridable. SUNCG itself is
withdrawn, so the scene input is a generic annotated triangle mesh — any
synthetic house/room mesh works.

A copy of the JAX package's ``tpu3dsis/datagen/virtual_scan.py``, numpy on the host as the
original is; ``tests/test_torch_datagen.py`` holds its outputs equal to
the original's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from tpu3dsis_torch.datagen.mesh_render import MeshRenderer

# default mean ScanNet-like depth histogram (16 bins x 0.5 m): mass around
# 1-3 m, the range a handheld scanner actually sees
_DEFAULT_HIST = np.array(
    [0.00, 0.02, 0.08, 0.14, 0.17, 0.16, 0.13, 0.10,
     0.07, 0.05, 0.03, 0.02, 0.01, 0.01, 0.005, 0.005]
)


@dataclass
class ViewStats:
    """Camera statistics (reference: learned from ScanNet, initViewStats)."""

    cam_height_mean: float = 1.55
    cam_height_std: float = 0.15
    cam_angle_mean: float = 11.0  # degrees, + looks down
    cam_angle_std: float = 8.0
    depth_hist_mean: np.ndarray = field(
        default_factory=lambda: _DEFAULT_HIST.copy()
    )
    depth_hist_med_emd: float = 0.15
    depth_hist_std_emd: float = 0.15


def compute_emd(p, q):
    """1D earth-mover's distance, partial-sum form (ViewGenerator.h:289)."""
    emd = 0.0
    dist = 0.0
    for i in range(1, len(p)):
        emd += p[i - 1] - q[i - 1]
        dist += abs(emd)
    return dist


def emd_probability(score, med, std):
    """Two-sided erfc probability (ViewGenerator.h:300-306)."""
    z = (score - med) / std
    return math.erfc(abs(z) / math.sqrt(2.0))


def evaluate_view(depth, semantic, stats: ViewStats, max_depth=6.0):
    """-> (object_score, hist_score) per ViewGenerator.h:219-254."""
    valid = depth > 0
    n_pix = depth.size
    objects = valid & (semantic > 0) & (depth < max_depth)
    object_score = objects.sum() / n_pix

    bins = np.clip((depth[valid] / 0.5).astype(int), 0, 15)
    hist = np.bincount(bins, minlength=16).astype(np.float64) / n_pix
    emd = compute_emd(hist, stats.depth_hist_mean)
    hist_score = emd_probability(
        emd, stats.depth_hist_med_emd, stats.depth_hist_std_emd
    )
    return float(object_score), float(hist_score)


def camera_pose(eye, yaw_deg, pitch_deg):
    """camera_to_world with look = Ry(yaw) Rx(pitch) ez (ViewGenerator.cpp:88).

    + pitch looks down (y-up world, matching the reference convention)."""
    yaw = math.radians(yaw_deg)
    pitch = math.radians(pitch_deg)
    ry = np.array(
        [[math.cos(yaw), 0, math.sin(yaw)],
         [0, 1, 0],
         [-math.sin(yaw), 0, math.cos(yaw)]]
    )
    rx = np.array(
        [[1, 0, 0],
         [0, math.cos(pitch), -math.sin(pitch)],
         [0, math.sin(pitch), math.cos(pitch)]]
    )
    r = ry @ rx
    look = r @ np.array([0.0, 0.0, 1.0])
    up = r @ np.array([0.0, 1.0, 0.0])
    right = np.cross(up, look)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, up, look, eye
    return pose


def intrinsic_from_fov(width, height, fov_deg=60.0):
    """Square-pixel pinhole intrinsic from a vertical field of view."""
    f = (height / 2.0) / math.tan(math.radians(fov_deg) / 2.0)
    k = np.eye(4)
    k[0, 0] = k[1, 1] = f
    k[0, 2], k[1, 2] = width / 2.0, height / 2.0
    return k


class ViewGenerator:
    """Key-view sampling + trajectory interpolation over a rendered scene."""

    def __init__(self, renderer: MeshRenderer, width=64, height=48,
                 stats: ViewStats | None = None, fov_deg=60.0,
                 depth_min=0.4, depth_max=6.0, seed=0):
        self.renderer = renderer
        self.width, self.height = int(width), int(height)
        self.stats = stats or ViewStats()
        self.intrinsic = intrinsic_from_fov(width, height, fov_deg)
        self.depth_min, self.depth_max = depth_min, depth_max
        self.rng = np.random.RandomState(seed)

    def _render(self, pose):
        return self.renderer.render(
            self.intrinsic, pose, self.width, self.height,
            near=self.depth_min, far=self.depth_max,
        )

    def _sample_candidate(self, cell_lo, cell_hi, pitch_scale=1.0):
        rng = self.rng
        s = self.stats
        eye = np.array(
            [
                rng.uniform(cell_lo[0], cell_hi[0]),
                np.clip(
                    rng.normal(s.cam_height_mean, s.cam_height_std),
                    cell_lo[1], cell_hi[1],
                ),
                rng.uniform(cell_lo[2], cell_hi[2]),
            ]
        )
        yaw = rng.uniform(0.0, 360.0)
        pitch = pitch_scale * rng.normal(s.cam_angle_mean, s.cam_angle_std)
        return camera_pose(eye, yaw, pitch)

    def _best_cell_camera(self, cell_lo, cell_hi, n_candidates,
                          min_percent_objects=0.2, pitch_scale=1.0):
        """Sample-and-score loop with the reference's early accept
        (ViewGenerator.cpp:97-119)."""
        best, best_score = None, (0.0, 0.0)
        for _ in range(n_candidates):
            pose = self._sample_candidate(cell_lo, cell_hi, pitch_scale)
            view = self._render(pose)
            sx, sy = evaluate_view(
                view["depth"], view.get("semantic", np.zeros(1)), self.stats
            )
            if (
                sx > min_percent_objects
                and sy > 0.0
                and self.rng.uniform() <= sy
            ):
                return pose, (sx, sy)  # good enough: accept early
            if sx > best_score[0] or (best_score[0] == 0 and sy > best_score[1]):
                best, best_score = pose, (sx, sy)
        return best, best_score

    def generate_keys(self, room_bboxes=None, coverage_vox=1.5,
                      max_samples=64, up_camera_prob=0.5):
        """Coverage-driven key views (ViewGenerator.cpp:52-185).

        room_bboxes: list of (min3, max3) world boxes; default = the scene
        bbox as one room (mesh inputs carry no room graph)."""
        verts = self.renderer.vertices
        bb_min, bb_max = verts.min(0), verts.max(0)
        bb_min[1] = max(bb_min[1], 0.0)
        if room_bboxes is None:
            room_bboxes = [(bb_min, bb_max)]
        cov_dims = np.maximum(
            np.ceil((bb_max - bb_min) / coverage_vox).astype(int), 1
        )
        cov_dims[1] = 1  # ground level only (reference maxLevel=1)
        covered = np.zeros(cov_dims, bool)
        n_try = max(3, min(10, max_samples // max(cov_dims[0] * cov_dims[2], 1)))

        cameras = []
        for r_lo, r_hi in room_bboxes:
            r_lo, r_hi = np.asarray(r_lo, float), np.asarray(r_hi, float)
            room_dims = np.maximum(
                np.ceil((r_hi - r_lo) / coverage_vox).astype(int), 1
            )
            room_dims[1] = 1
            for z in range(room_dims[2]):
                xs = range(room_dims[0])
                if z % 2:  # zigzag scanline order
                    xs = reversed(list(xs))
                for x in xs:
                    cell = np.array([x, 0, z], float)
                    loc = np.round(
                        (cell * coverage_vox + r_lo - bb_min) / coverage_vox
                    ).astype(int)
                    if (loc < 0).any() or (loc >= cov_dims).any():
                        continue
                    if covered[tuple(loc)]:
                        continue
                    cell_lo = cell * coverage_vox + r_lo
                    cell_hi = np.minimum(r_hi, cell_lo + coverage_vox)
                    cell_hi[1] = r_hi[1]  # eye height spans the room
                    pose, score = self._best_cell_camera(
                        cell_lo, cell_hi, n_try
                    )
                    if pose is not None and max(score) > 0.0:
                        covered[tuple(loc)] = True
                        cameras.append(pose)
                    if self.rng.uniform() < up_camera_prob:
                        pose, score = self._best_cell_camera(
                            cell_lo, cell_hi, n_try, pitch_scale=-1.5
                        )
                        if pose is not None and max(score) > 0.0:
                            covered[tuple(loc)] = True
                            cameras.append(pose)
        return cameras

    def interpolate_trajectory(self, keys, max_views=200,
                               cameras_per_m=2.0, cameras_per_rad=0.01,
                               keep_prob=0.8, free_radius=0.2):
        """Catmull-Rom densification of key views (ViewGenerator.cpp:14-50)."""
        if len(keys) < 4:
            return list(keys)
        out = [keys[0]]
        max_per_segment = max(5, max_views // len(keys))
        for i in range(len(keys) - 3):
            c = keys[i : i + 4]
            eyes = [p[:3, 3] for p in c]
            looks = [p[:3, 2] for p in c]
            dist = np.linalg.norm(eyes[2] - eyes[1])
            ang = math.acos(float(np.clip(np.dot(looks[1], looks[2]), -1, 1)))
            num = min(
                max_per_segment,
                max(round(dist * cameras_per_m), round(ang * cameras_per_rad)),
            )
            out.append(keys[i + 1])
            for j in range(1, int(num)):
                t = j / max(num, 1)
                eye = _catmull_rom(*eyes, t)
                look = _catmull_rom(*looks, t)
                nl = np.linalg.norm(look)
                if nl < 1e-6:
                    continue
                look = look / nl
                up = np.array([0.0, 1.0, 0.0])
                if abs(np.dot(up, look)) > 0.99:
                    up = np.array([1.0, 0.0, 0.0])
                right = np.cross(up, look)
                right /= np.linalg.norm(right)
                true_up = np.cross(look, right)
                pose = np.eye(4)
                pose[:3, 0], pose[:3, 1] = right, true_up
                pose[:3, 2], pose[:3, 3] = look, eye
                # free-space probe (stands in for intersectsCameraBox)
                probe = self.renderer.render(
                    intrinsic_from_fov(8, 8), pose, 8, 8,
                    near=0.01, far=self.depth_max,
                )
                d = probe["depth"]
                if (d > 0).any() and d[d > 0].min() < free_radius:
                    continue
                if self.rng.uniform() < keep_prob:
                    out.append(pose)
        out.extend(keys[-2:])
        return out


def _catmull_rom(p0, p1, p2, p3, t):
    t2, t3 = t * t, t * t * t
    return 0.5 * (
        2 * p1
        + (-p0 + p2) * t
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
        + (-p0 + 3 * p1 - 3 * p2 + p3) * t3
    )


def virtual_scan(vertices, faces, semantics, instances, voxel_size=0.046875,
                 width=64, height=48, stats=None, seed=0, max_views=200,
                 room_bboxes=None):
    """Full SUNCGScan equivalent: views -> trajectory -> render -> fuse.

    -> (grid, world_to_grid, cameras). Pair with tsdf_fusion.save_scsdf /
    save_aabbs (+ VoxelGrid.instance_mask_for_aabb) for the on-disk formats.
    """
    from tpu3dsis_torch.datagen.mesh_render import render_and_fuse

    renderer = MeshRenderer(vertices, faces, semantics, instances)
    gen = ViewGenerator(renderer, width, height, stats=stats, seed=seed)
    keys = gen.generate_keys(room_bboxes=room_bboxes)
    traj = gen.interpolate_trajectory(keys, max_views=max_views)
    grid, w2g = render_and_fuse(
        vertices, faces, semantics, instances, traj, gen.intrinsic,
        width, height, voxel_size, depth_min=gen.depth_min,
        depth_max=gen.depth_max,
    )
    return grid, w2g, traj
