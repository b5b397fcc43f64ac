"""Synthetic annotated COLOR scenes: the full datagen loop on generated data.

Composes the datagen stack end to end the way the reference's offline C++
does for SUNCG (``datagen/SUNCGScan`` render + fuse, ``datagen/SceneSampler``
chunk/scene export, ``datagen/ScanReal/python/prepare_2d_data.py`` frame
export) but from procedurally generated furniture-box rooms, so the
datagen -> color training -> scene eval -> benchmark-export loop can run
without any real ScanNet/SUNCG data:

  room mesh (cuboids + floor/walls, per-face nyu40 labels, instance ids,
  albedo colors)
    -> ViewGenerator trajectory (virtual_scan semantics)
    -> per-pose shaded RGB + depth + label frames written in the
       frames_square layout (color/ depth/ label/ pose/ world2grid.txt)
    -> TSDF fusion with label/instance voting (tsdf_fusion.VoxelGrid)
    -> .scsdf/.aabbs -> SceneSampler .chunk (with greedy nearest-image
       selection) + .scene files.

A copy of the JAX package's ``tpu3dsis/datagen/synthetic_color.py``, numpy on the host as the
original is; ``tests/test_torch_datagen.py`` holds its outputs equal to
the original's.
"""

from __future__ import annotations

import os

import numpy as np

from tpu3dsis_torch.datagen.mesh_render import MeshRenderer
from tpu3dsis_torch.datagen.tsdf_fusion import (
    VoxelGrid,
    make_world_to_grid,
    save_aabbs,
    save_scsdf,
)
from tpu3dsis_torch.datagen.virtual_scan import ViewGenerator, intrinsic_from_fov

# nyu40 ids (mapped to consecutive by the label map CSV at train time)
SOFA, CHAIR, TABLE = 6, 5, 7
_KIND_DIMS_M = {
    # (x, y, z) extents in meters, roughly the tiling_parity_check voxel
    # dims at the ScanNet 4.7 cm voxel size
    "sofa": ((2.2, 2.6), (0.8, 1.1), (0.9, 1.2)),
    "chair": ((0.45, 0.7), (0.4, 0.65), (0.45, 0.7)),
    "table": ((0.75, 1.05), (0.18, 0.33), (0.75, 1.05)),
}
_KIND_LABEL = {"sofa": SOFA, "chair": CHAIR, "table": TABLE}


def _add_quad(mesh, corners, label, instance, color):
    verts, faces, sem, inst, cols = mesh
    base = len(verts)
    verts.extend(corners)
    faces.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    sem.extend([label, label])
    inst.extend([instance, instance])
    cols.extend([color, color])


def _add_box(mesh, lo, hi, label, instance, color):
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    quads = [
        [(x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0)],
        [(x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)],
        [(x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)],
        [(x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0)],
        [(x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1)],
        [(x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)],
    ]
    for q in quads:
        _add_quad(mesh, q, label, instance, color)


def room_mesh(rng, extent_m=(6.0, 2.4, 6.0), n_objects=10):
    """Procedural furnished room.

    Returns (vertices, faces, semantics, instances, colors, objects) where
    objects is a list of (lo_m, hi_m, nyu40_label, instance_id) and colors
    are per-face uint8 albedos (distinct hue per instance, face jitter so
    the 2D stream sees texture-like variation).
    """
    mesh = ([], [], [], [], [])
    ex, ey, ez = extent_m
    grey = (120, 120, 120)
    _add_quad(mesh, [(0, 0, 0), (ex, 0, 0), (ex, 0, ez), (0, 0, ez)], 2, 0,
              (90, 80, 70))  # floor (nyu40 2, weight 0 -> not an instance)
    _add_quad(mesh, [(0, 0, 0), (ex, 0, 0), (ex, ey, 0), (0, ey, 0)], 1, 0,
              grey)  # wall
    _add_quad(mesh, [(0, 0, 0), (0, 0, ez), (0, ey, ez), (0, ey, 0)], 1, 0,
              grey)
    _add_quad(mesh, [(ex, 0, 0), (ex, 0, ez), (ex, ey, ez), (ex, ey, 0)], 1,
              0, grey)
    _add_quad(mesh, [(0, 0, ez), (ex, 0, ez), (ex, ey, ez), (0, ey, ez)], 1,
              0, grey)

    kinds = ["sofa"] * max(1, n_objects // 3)
    kinds += ["chair", "table"] * (n_objects - len(kinds))
    objects = []
    placed = []
    inst_id = 1
    for kind in kinds[:n_objects]:
        (dx0, dx1), (dy0, dy1), (dz0, dz1) = _KIND_DIMS_M[kind]
        sx = rng.uniform(dx0, dx1)
        sy = rng.uniform(dy0, dy1)
        sz = rng.uniform(dz0, dz1)
        if rng.rand() < 0.5:
            sx, sz = sz, sx
        for _ in range(60):
            x0 = rng.uniform(0.2, max(ex - sx - 0.2, 0.3))
            z0 = rng.uniform(0.2, max(ez - sz - 0.2, 0.3))
            box = (x0, 0.0, z0, x0 + sx, sy, z0 + sz)
            if any(
                not (box[3] + 0.1 <= b[0] or b[3] + 0.1 <= box[0]
                     or box[5] + 0.1 <= b[2] or b[5] + 0.1 <= box[2])
                for b in placed
            ):
                continue
            placed.append(box)
            base = rng.randint(60, 220, 3)
            _add_box(
                mesh, box[:3], box[3:], _KIND_LABEL[kind], inst_id,
                tuple(int(c) for c in base),
            )
            objects.append((np.asarray(box[:3]), np.asarray(box[3:]),
                            _KIND_LABEL[kind], inst_id))
            inst_id += 1
            break
    verts, faces, sem, inst, cols = mesh
    # per-face albedo jitter (texture-like variation for the color stream)
    cols = np.asarray(cols, np.float64)
    cols = np.clip(cols + rng.randint(-25, 26, cols.shape), 0, 255)
    return (
        np.asarray(verts, np.float64),
        np.asarray(faces, np.int64),
        np.asarray(sem, np.uint8),
        np.asarray(inst, np.uint16),
        cols,
        objects,
    )


def scaled_intrinsic(intrinsic, src_wh, dst_wh):
    """Rescale a pinhole intrinsic from one image resolution to another
    (the reference stores the DEPTH_SHAPE-resolution intrinsic in cfg)."""
    out = np.asarray(intrinsic, np.float64).copy()
    sx = dst_wh[0] / float(src_wh[0])
    sy = dst_wh[1] / float(src_wh[1])
    out[0, 0] *= sx
    out[0, 2] *= sx
    out[1, 1] *= sy
    out[1, 2] *= sy
    return out


def generate_scene(
    rng,
    out_root,
    scene_name="synth0",
    extent_m=(6.0, 2.4, 6.0),
    n_objects=10,
    voxel_size=0.046875,
    image_wh=(328, 256),
    max_views=96,
    traj_wh=(64, 48),
    frames_subdir="frames_square",
    chunks=True,
    sample_factor=48,
    num_nearest=5,
    chunk_dim=None,
):
    """Generate one fully-annotated color scene on disk.

    Writes:
      <out_root>/<frames_subdir>/<scene_name>/{color,depth,label,pose}/<i>.*
        + world2grid.txt  (frames_square layout, io/frames.py::FrameSource)
      <out_root>/scenes/<scene_name>__0__.scene
      <out_root>/chunks/<scene_name>__<i>__.chunk  (when chunks=True)

    Returns dict with mesh arrays, objects, poses, file lists, and the
    frame-resolution intrinsic.
    """
    from PIL import Image  # only where frames are written

    from tpu3dsis_torch.datagen.scene_sampler import (
        process_scene,
        process_scene_chunks,
    )

    verts, faces, sem, inst, cols, objects = room_mesh(
        rng, extent_m, n_objects
    )
    # trajectory from the virtual-scan ViewGenerator (low-res scoring)
    gen = ViewGenerator(
        MeshRenderer(verts, faces, sem, inst),
        width=traj_wh[0], height=traj_wh[1],
        seed=int(rng.randint(0, 2**31 - 1)),
    )
    keys = gen.generate_keys()
    traj = gen.interpolate_trajectory(keys, max_views=max_views)
    if not traj:
        raise RuntimeError("virtual scan produced no views")
    traj = traj[:max_views]

    w, h = image_wh
    intr = intrinsic_from_fov(w, h)
    color_renderer = MeshRenderer(verts, faces, sem, inst, colors=cols)

    frames_dir = os.path.join(out_root, frames_subdir, scene_name)
    for sub in ("color", "depth", "label", "pose"):
        os.makedirs(os.path.join(frames_dir, sub), exist_ok=True)

    bb_min = verts.min(0)
    bb_max = verts.max(0)
    dims = np.round((bb_max - bb_min) / voxel_size).astype(int) + 32
    w2g = make_world_to_grid(bb_min, voxel_size, pad=16)
    grid = VoxelGrid(tuple(dims), w2g, voxel_size, gen.depth_min,
                     gen.depth_max)

    depths = []
    for i, pose in enumerate(traj):
        frame = color_renderer.render(
            intr, pose, w, h, near=gen.depth_min, far=gen.depth_max
        )
        Image.fromarray(frame["color"]).save(
            os.path.join(frames_dir, "color", f"{i}.jpg"), quality=92
        )
        Image.fromarray(
            (frame["depth"] * 1000.0).astype(np.uint16)
        ).save(os.path.join(frames_dir, "depth", f"{i}.png"))
        Image.fromarray(frame["semantic"].astype(np.uint8)).save(
            os.path.join(frames_dir, "label", f"{i}.png")
        )
        np.savetxt(
            os.path.join(frames_dir, "pose", f"{i}.txt"), pose, fmt="%.8f"
        )
        depths.append(frame["depth"])
        if (frame["depth"] > 0).any():
            grid.integrate(
                intr, pose, frame["depth"], label=frame["semantic"],
                instance=frame["instance"],
            )
    grid.normalize_sdfs()
    # the scene-mode loader subtracts the pad-16 -> crop-6 offset [10,16,10]
    np.savetxt(os.path.join(frames_dir, "world2grid.txt"), w2g, fmt="%.8f")

    # AABBs + masks from the fused instance grid (Fuser.cpp AABB export)
    boxes, labels, masks = [], [], []
    for lo_m, hi_m, label, inst_id in objects:
        lo = (w2g @ np.array([*lo_m, 1.0]))[:3]
        hi = (w2g @ np.array([*hi_m, 1.0]))[:3]
        aabb = np.concatenate([
            np.maximum(np.floor(lo - 1), 0),
            np.minimum(np.ceil(hi + 1), np.asarray(dims, np.float64)),
        ])
        mask, n_inst, _ = grid.instance_mask_for_aabb(aabb, inst_id)
        if n_inst < 5:
            continue  # barely observed: drop (reference min-size behavior)
        # tighten to the observed instance voxels (Fuser exports AABBs of
        # the fused geometry, not of the source objects)
        nz = np.nonzero(mask)
        lo_t = aabb[:3] + np.array([a.min() for a in nz])
        hi_t = aabb[:3] + np.array([a.max() + 1 for a in nz])
        # clamp to the scene-crop window (processScene crops the padded grid
        # by [OFFSET, SCENE_PAD, OFFSET] low / OFFSET high without clipping
        # boxes — the TSDF band puts instance voxels a voxel below the floor,
        # which would land at y<0 in the cropped scene)
        from tpu3dsis_torch.datagen.scene_sampler import OFFSET, SCENE_PAD

        crop_lo = np.array([OFFSET, SCENE_PAD, OFFSET], np.float64)
        crop_hi = np.asarray(dims, np.float64) - OFFSET
        lo_c = np.maximum(lo_t, crop_lo)
        hi_c = np.minimum(hi_t, crop_hi)
        if np.any(hi_c - lo_c < 1):
            continue
        mask = mask[
            int(lo_c[0] - aabb[0]) : int(hi_c[0] - aabb[0]),
            int(lo_c[1] - aabb[1]) : int(hi_c[1] - aabb[1]),
            int(lo_c[2] - aabb[2]) : int(hi_c[2] - aabb[2]),
        ]
        lo_t, hi_t = lo_c, hi_c
        boxes.append(np.concatenate([lo_t, hi_t]).astype(np.float64))
        labels.append(label)
        masks.append(mask.astype(np.uint16))

    os.makedirs(os.path.join(out_root, "gen"), exist_ok=True)
    scsdf = os.path.join(out_root, "gen", f"{scene_name}.scsdf")
    aabbs = os.path.join(out_root, "gen", f"{scene_name}.aabbs")
    save_scsdf(scsdf, grid.sdf, voxel_size, bb_min, bb_max)
    save_aabbs(aabbs, boxes, labels, masks)

    os.makedirs(os.path.join(out_root, "scenes"), exist_ok=True)
    scene_path = os.path.join(
        out_root, "scenes", f"{scene_name}__0__.scene"
    )
    process_scene(scsdf, aabbs, scene_path)

    chunk_paths = []
    if chunks:
        from tpu3dsis_torch.datagen.scene_sampler import CHUNK_DIM

        os.makedirs(os.path.join(out_root, "chunks"), exist_ok=True)
        chunk_paths = process_scene_chunks(
            scsdf,
            aabbs,
            os.path.join(out_root, "chunks", f"{scene_name}__"),
            depths=depths,
            poses=traj,
            frame_skip=1,  # exported frame ids are sequential
            chunk_dim=chunk_dim or CHUNK_DIM,
            sample_factor=sample_factor,
            num_nearest=num_nearest,
            rotate90=False,  # rotated chunks cannot reuse unrotated frames'
            # projection (the reference rotates masks but trains color on
            # the unrotated stream; keep the color loop unrotated)
        )
        for p in chunk_paths:
            # SceneSampler numbers chunks <prefix><i>.chunk; the dataset
            # resolves the frames dir from the '<scene>__' split
            assert os.path.basename(p).startswith(scene_name + "__")

    return {
        "mesh": (verts, faces, sem, inst, cols),
        "grid": grid,
        "objects": objects,
        "poses": traj,
        "intrinsic": intr,
        "frames_dir": frames_dir,
        "scene_path": scene_path,
        "chunk_paths": chunk_paths,
        "scsdf": scsdf,
        "aabbs": aabbs,
        "world_to_grid": w2g,
    }
