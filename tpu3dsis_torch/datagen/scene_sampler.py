"""SceneSampler: `.scsdf`+`.aabbs` -> training `.chunk`s and test `.scene`s.

Python re-implementation of ``datagen/SceneSampler/main.cpp``:
  - grid-strided 96x48x96 chunk extraction with optional 90-degree y-axis
    rotations (processSceneChunks, main.cpp:727-830; getCoord/rotateMask
    index math main.cpp:237-282/264-303)
  - per-chunk box intersection fractions (extractChunk, main.cpp:284-346)
  - greedy max-coverage nearest-image selection (findNearestImages,
    main.cpp:615-724) using the 80x60-downscaled intrinsic and voxel-size
    depth-consistency test
  - whole-scene crop pad 16 -> 6 (processScene, main.cpp:832-896)
  - validateChunk mask/box consistency (main.cpp:901-919)
  - byte-exact .chunk writer (tpu3dsis_torch.io.chunk_format.write_chunk_file)

A copy of the JAX package's ``tpu3dsis/datagen/scene_sampler.py``, numpy on the host as the
original is; ``tests/test_torch_datagen.py`` holds its outputs equal to
the original's.
"""

from __future__ import annotations

import numpy as np

from tpu3dsis_torch.datagen.tsdf_fusion import load_aabbs, load_scsdf
from tpu3dsis_torch.io.chunk_format import write_chunk_file

SCENE_PAD = 16
PAD = 6
OFFSET = SCENE_PAD - PAD  # 10
CHUNK_DIM = (96, 48, 96)
IMAGE_FIND_BBOX_INTERSECT_THRESH = 0.5
VALID_NYU40_CLASSES = {3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39}

# ScanNet intrinsic downscaled to 80x60 (main.cpp:624-632)
def nearest_image_intrinsic(suncg=False):
    if suncg:
        k = np.array([[554.256, 0, 319.5], [0, 554.256, 239.5], [0, 0, 1.0]])
    else:
        k = np.array(
            [[577.870605, 0, 319.5], [0, 577.870605, 239.5], [0, 0, 1.0]]
        )
    k = k.copy()
    k[0, 0] *= 80.0 / 640.0
    k[1, 1] *= 60.0 / 480.0
    k[0, 2] *= (80.0 - 1.0) / (640.0 - 1.0)
    k[1, 2] *= (60.0 - 1.0) / (480.0 - 1.0)
    return k


def _rot_coord(xyz, rot):
    """getCoord (main.cpp:243-262): y-axis 90-degree rotations."""
    x, y, z = xyz
    if rot % 4 == 0:
        return np.array([x, y, z])
    if rot == 1:
        return np.array([z, y, -x])
    if rot == 2:
        return np.array([-x, y, -z])
    if rot == 3:
        return np.array([-z, y, x])
    raise ValueError(rot)


def rotate_mask(mask, rot):
    """rotateMask (main.cpp:264-282)."""
    if rot == 0:
        return mask
    return np.ascontiguousarray(np.rot90(mask, k=rot, axes=(2, 0)))


def _rotate_grid_index_math(mask, rot):
    """Direct port of the reference's per-voxel rotate, used as an oracle for
    rotate_mask in tests."""
    dims = np.asarray(mask.shape)
    rdims = _rot_coord(dims, rot)
    roffset = np.zeros(3, int)
    for i in (0, 2):
        if rdims[i] < 0:
            roffset[i] = -rdims[i] - 1
    rdims = np.abs(rdims)
    out = np.zeros(tuple(rdims), mask.dtype)
    for x in range(mask.shape[0]):
        for y in range(mask.shape[1]):
            for z in range(mask.shape[2]):
                c = _rot_coord((x, y, z), rot) + roffset
                out[c[0], c[1], c[2]] = mask[x, y, z]
    return out


def _intersection_volume(b0, b1):
    lo = np.maximum(b0[:3], b1[:3])
    hi = np.minimum(b0[3:6], b1[3:6])
    return float(np.prod(hi - lo))


def _is_inside(b0, b1):
    return bool((b0[:3] >= b1[:3]).all() and (b0[3:6] <= b1[3:6]).all())


def extract_chunk(grid, boxes, labels, masks, start, rot, chunk_dim=CHUNK_DIM):
    """extractChunk (main.cpp:284-346): rotated chunk data + per-box
    intersection fractions + rotated masks. Returns (data, sel) where sel is
    a list of (box_in_chunk_coords, label, mask, portion)."""
    start = np.asarray(start, int)
    dim = np.asarray(chunk_dim, int)
    grid_dim = np.asarray(grid.shape, int)
    rot_grid_dim = _rot_coord(grid_dim, rot)
    offset_grid = np.zeros(3, int)
    for i in (0, 2):
        if rot_grid_dim[i] < 0:
            offset_grid[i] = -rot_grid_dim[i]

    # rotated whole grid (match the reference's unrotate index math by
    # rotating the grid array with the same convention as rotate_mask)
    rgrid = rotate_mask(grid, rot)

    # chunk data with default fill where out of bounds
    data = np.full(tuple(dim), -np.inf, np.float32)
    lo = start
    hi = np.minimum(start + dim, np.asarray(rgrid.shape))
    lo_c = np.maximum(lo, 0)
    if (hi > lo_c).all():
        data[
            lo_c[0] - lo[0] : hi[0] - lo[0],
            lo_c[1] - lo[1] : hi[1] - lo[1],
            lo_c[2] - lo[2] : hi[2] - lo[2],
        ] = rgrid[lo_c[0] : hi[0], lo_c[1] : hi[1], lo_c[2] : hi[2]]

    chunk_box = np.concatenate([start, start + dim]).astype(np.float64)
    sel = []
    for box, label, mask in zip(boxes, labels, masks):
        b0 = _rot_coord(box[:3], rot) + offset_grid
        b1 = _rot_coord(box[3:6], rot) + offset_grid
        bb = np.concatenate([np.minimum(b0, b1), np.maximum(b0, b1)])
        inter = _intersection_volume(chunk_box, bb)
        if inter <= 0 or (bb[:3] >= chunk_box[3:6]).any() or (
            bb[3:6] <= chunk_box[:3]
        ).any():
            continue
        box_vol = float(np.prod(bb[3:6] - bb[:3]))
        portion = 1.0 if _is_inside(bb, chunk_box) else inter / box_vol
        local = bb.copy()
        local[:3] -= start
        local[3:6] -= start
        sel.append((local.astype(np.float32), label, rotate_mask(mask, rot),
                    portion))
    return data, sel


def validate_chunk(sel):
    """validateChunk (main.cpp:901-919): fully-inside boxes must have masks
    matching their rounded extents."""
    for box, _, mask, portion in sel:
        if abs(portion - 1.0) > 0.001:
            continue
        extent = np.ceil(box[3:6]) - np.floor(box[:3])
        if tuple(int(e) for e in extent) != mask.shape:
            return -1
    return 0


def find_nearest_images(
    sel,
    chunk_to_world,
    voxel_size,
    chunk_dim,
    depths,
    poses,
    num_nearest,
    intrinsic=None,
    depth_min=0.4,
    depth_max=4.0,
):
    """Greedy max-coverage view selection (main.cpp:615-724).

    For each frame: project every chunk voxel into the (80x60) depth map
    with the voxel-size depth-consistency test; hits inside instance masks
    (for boxes with portion >= 0.5) count as coverage. Greedily add frames
    maximizing mean per-instance coverage. Returns list of frame indices.
    (The C++ names its transform `sampleGridToWorld` but constructs a
    world->chunk matrix and hands it to VoxelGrid as worldToGrid,
    main.cpp:796/638 — this function takes the honest chunk->world.)
    """
    if intrinsic is None:
        intrinsic = nearest_image_intrinsic()
    g2w = np.asarray(chunk_to_world, np.float64)

    dims = np.asarray(chunk_dim, int)
    xs, ys, zs = np.meshgrid(
        np.arange(dims[0]), np.arange(dims[1]), np.arange(dims[2]),
        indexing="ij",
    )
    coords = np.stack(
        [xs.ravel(), ys.ravel(), zs.ravel(), np.ones(xs.size)], 0
    ).astype(np.float64)
    world = g2w @ coords

    # per-box voxel membership (flattened indices) for eligible boxes
    eligible = []
    box_voxels = []
    geo_count = []
    for bi, (box, label, mask, portion) in enumerate(sel):
        if portion < IMAGE_FIND_BBOX_INTERSECT_THRESH or (
            label not in VALID_NYU40_CLASSES
        ):
            eligible.append(False)
            box_voxels.append(None)
            geo_count.append(max(int((np.asarray(mask) != 0).sum()), 1))
            continue
        eligible.append(True)
        lo = np.floor(box[:3]).astype(int)
        hi = np.ceil(box[3:6]).astype(int)
        member = np.zeros(tuple(dims), bool)
        lo_c = np.maximum(lo, 0)
        hi_c = np.minimum(hi, dims)
        if (hi_c > lo_c).all():
            msub = np.asarray(mask)[
                lo_c[0] - lo[0] : hi_c[0] - lo[0],
                lo_c[1] - lo[1] : hi_c[1] - lo[1],
                lo_c[2] - lo[2] : hi_c[2] - lo[2],
            ]
            member[lo_c[0] : hi_c[0], lo_c[1] : hi_c[1], lo_c[2] : hi_c[2]] = (
                msub != 0
            )
        box_voxels.append(member.ravel())
        geo_count.append(max(int((np.asarray(mask) != 0).sum()), 1))

    h, w = depths[0].shape
    per_frame_hits = []  # frame -> {box: set of voxel flat indices}
    for fi, (depth, pose) in enumerate(zip(depths, poses)):
        if not np.isfinite(pose).all():
            continue
        w2c = np.linalg.inv(np.asarray(pose, np.float64))
        p = w2c @ world
        zc = p[2]
        with np.errstate(divide="ignore", invalid="ignore"):
            px = np.round(p[0] * intrinsic[0, 0] / zc + intrinsic[0, 2])
            py = np.round(p[1] * intrinsic[1, 1] / zc + intrinsic[1, 2])
        ok = (px >= 0) & (py >= 0) & (px < w) & (py < h) & np.isfinite(px)
        pxi = np.where(ok, px, 0).astype(int)
        pyi = np.where(ok, py, 0).astype(int)
        d = depth[pyi, pxi]
        hit = ok & (d >= depth_min) & (d <= depth_max) & (
            np.abs(d - zc) <= voxel_size
        )
        if not hit.any():
            continue
        frame_boxes = {}
        for bi, member in enumerate(box_voxels):
            if member is None:
                continue
            voxels = np.where(hit & member)[0]
            if voxels.size:
                frame_boxes[bi] = set(voxels.tolist())
        if frame_boxes:
            per_frame_hits.append((fi, frame_boxes))

    if not per_frame_hits:
        return []

    # seed: frame hitting the most boxes (priority by #boxes, then index;
    # main.cpp:639-645 orders by map size)
    per_frame_hits.sort(key=lambda t: (len(t[1]), t[0]), reverse=True)
    chosen = [per_frame_hits[0][0]]
    covered = {b: set(v) for b, v in per_frame_hits[0][1].items()}
    candidates = list(per_frame_hits[1:])

    n_eligible = max(sum(eligible), 1)
    while len(chosen) < num_nearest and candidates:
        best_cov, best_i = -1.0, 0
        for i, (fi, fb) in enumerate(candidates):
            cov = 0.0
            for bi in range(len(sel)):
                if not eligible[bi]:
                    continue
                s = covered.get(bi, set())
                extra = fb.get(bi, set())
                u = len(s | extra)
                cov += u / geo_count[bi]
            cov /= n_eligible
            if cov > best_cov:
                best_cov, best_i = cov, i
        fi, fb = candidates.pop(best_i)
        for bi, v in fb.items():
            covered.setdefault(bi, set()).update(v)
        chosen.append(fi)
    return chosen


def process_scene_chunks(
    scsdf_path,
    aabb_path,
    out_prefix,
    depths=None,
    poses=None,
    frame_skip=20,
    chunk_dim=CHUNK_DIM,
    sample_factor=64,
    num_nearest=5,
    rotate90=True,
    default_value=-np.inf,
    require_images=True,
):
    """processSceneChunks (main.cpp:727-830). Returns written file paths."""
    grid, voxel_size, bmin, bmax = load_scsdf(scsdf_path)
    boxes, labels, masks = load_aabbs(aabb_path)
    written = []
    counter = 0
    num_rots = 4 if rotate90 else 1
    for rot in range(num_rots):
        end_dim = np.abs(_rot_coord(np.asarray(grid.shape), rot))
        for z in range(OFFSET, int(end_dim[2]) - OFFSET, sample_factor):
            y = SCENE_PAD
            for x in range(OFFSET, int(end_dim[0]) - OFFSET, sample_factor):
                data, sel = extract_chunk(
                    grid, boxes, labels, masks, (x, y, z), rot, chunk_dim
                )
                if not sel:
                    continue
                if not (np.abs(data) <= 1).any():
                    continue  # empty chunk (main.cpp:805-816)
                if validate_chunk(sel) < 0:
                    continue

                nearest = []
                if depths is not None:
                    # sampleGridToWorld: grid->world for the chunk frame
                    # (main.cpp:796): translate(-start) after world->grid,
                    # inverted to grid->world
                    w2g = make_scene_world_to_grid(bmin, voxel_size)
                    w2chunk = rot_chunk_transform(
                        w2g, grid.shape, rot, (x, y, z)
                    )
                    chunk2world = np.linalg.inv(w2chunk)
                    nearest = find_nearest_images(
                        sel, chunk2world, voxel_size, chunk_dim, depths,
                        poses, num_nearest,
                    )
                    nearest = [f * frame_skip for f in nearest]
                    if require_images and not nearest:
                        continue
                else:
                    w2chunk = rot_chunk_transform(
                        make_scene_world_to_grid(bmin, voxel_size),
                        grid.shape, rot, (x, y, z),
                    )

                path = f"{out_prefix}{counter}.chunk"
                write_chunk_file(
                    path,
                    np.where(np.isfinite(data), data, default_value if
                             np.isfinite(default_value) else -15.0),
                    np.stack([s[0] for s in sel]),
                    np.asarray([s[1] for s in sel], np.uint32),
                    [s[2] for s in sel],
                    np.asarray([s[3] for s in sel], np.float32),
                    np.linalg.inv(w2chunk).astype(np.float32),
                    np.asarray(nearest, np.uint32),
                )
                written.append(path)
                counter += 1
    return written


def make_scene_world_to_grid(bbox_min, voxel_size, pad=SCENE_PAD):
    t = np.eye(4)
    t[:3, 3] = -np.asarray(bbox_min) + pad * voxel_size
    return np.diag([1.0 / voxel_size] * 3 + [1.0]) @ t


def rot_chunk_transform(world_to_grid, grid_shape, rot, start):
    """world -> rotated-chunk coords (main.cpp:779-796 sampleGridToWorld^-1)."""
    center = np.asarray(grid_shape, np.float64) * 0.5
    new_dim = _rot_coord(np.asarray(grid_shape), rot)
    new_center = _rot_coord(center, rot).astype(np.float64)
    if new_center[0] < 0:
        new_center[0] -= new_dim[0]
    if new_center[2] < 0:
        new_center[2] -= new_dim[2]
    theta = np.deg2rad(90.0 * rot)
    c, s = np.cos(theta), np.sin(theta)
    roty = np.eye(4)
    roty[0, 0], roty[0, 2], roty[2, 0], roty[2, 2] = c, s, -s, c
    t1 = np.eye(4); t1[:3, 3] = new_center
    t2 = np.eye(4); t2[:3, 3] = -center
    rotation_grid = t1 @ roty @ t2
    t3 = np.eye(4); t3[:3, 3] = -np.asarray(start, np.float64)
    return t3 @ rotation_grid @ np.asarray(world_to_grid, np.float64)


def process_scene(scsdf_path, aabb_path, out_path, default_value=-15.0,
                  generate_test_only=False):
    """processScene (main.cpp:832-896): crop pad 16 -> 6 and write .scene."""
    grid, voxel_size, bmin, bmax = load_scsdf(scsdf_path)
    if generate_test_only or aabb_path is None:
        boxes = np.zeros((0, 6), np.float32)
        labels = np.zeros((0,), np.uint32)
        masks = []
    else:
        boxes, labels, masks = load_aabbs(aabb_path)

    gd = np.asarray(grid.shape)
    scene = grid[
        OFFSET : gd[0] - OFFSET, SCENE_PAD : gd[1] - OFFSET,
        OFFSET : gd[2] - OFFSET,
    ]
    scene = np.where(np.isfinite(scene), scene, default_value)

    scene_box = np.array(
        [OFFSET, SCENE_PAD, OFFSET, gd[0] - OFFSET, gd[1] - OFFSET,
         gd[2] - OFFSET], np.float64,
    )
    out_boxes, out_fracs = [], []
    for box in boxes:
        vol = _intersection_volume(scene_box, box)
        box_vol = float(np.prod(box[3:6] - box[:3]))
        portion = 1.0 if _is_inside(box, scene_box) else vol / box_vol
        nb = box.copy()
        nb[:3] -= scene_box[:3]
        nb[3:6] -= scene_box[:3]
        out_boxes.append(nb)
        out_fracs.append(portion)

    w2g = make_scene_world_to_grid(bmin, voxel_size)
    t = np.eye(4); t[:3, 3] = -scene_box[:3]
    grid_to_cropped = t @ w2g
    write_chunk_file(
        out_path,
        scene,
        np.stack(out_boxes) if out_boxes else np.zeros((0, 6), np.float32),
        labels,
        masks,
        np.asarray(out_fracs, np.float32),
        np.linalg.inv(grid_to_cropped).astype(np.float32),
        np.zeros(0, np.uint32),
    )
    return out_path
