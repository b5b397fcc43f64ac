"""Voxel/box visualization: PLY exports for chunks, predictions, benchmarks.

Capability parity with ``tools/visualization.py`` in the reference (color
palette, per-voxel cube mask meshes, wireframe bounding boxes, `data` and
`result` CLI modes) with a simpler wireframe construction: box edges are
emitted as thin axis-aligned cuboids instead of tessellated cylinders —
visually equivalent and dependency-free.

A copy of the JAX package's ``tpu3dsis/tools/visualization.py``;
``tests/test_torch_visualization.py`` holds the PLY files it writes byte
for byte equal to the original's.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from tpu3dsis_torch.tools.ply import write_ply


def create_color_palette():
    """The nyu40 color palette (reference tools/visualization.py:15-57)."""
    return [
        (0, 0, 0), (174, 199, 232), (152, 223, 138), (31, 119, 180),
        (255, 187, 120), (188, 189, 34), (140, 86, 75), (255, 152, 150),
        (214, 39, 40), (197, 176, 213), (148, 103, 189), (196, 156, 148),
        (23, 190, 207), (178, 76, 76), (247, 182, 210), (66, 188, 102),
        (219, 219, 141), (140, 57, 197), (202, 185, 52), (51, 176, 203),
        (200, 54, 131), (92, 193, 61), (78, 71, 183), (172, 114, 82),
        (255, 127, 14), (91, 163, 138), (153, 98, 156), (140, 153, 101),
        (158, 218, 229), (100, 125, 154), (178, 127, 135), (120, 185, 128),
        (146, 111, 194), (44, 160, 44), (112, 128, 144), (96, 207, 209),
        (227, 119, 194), (213, 92, 176), (94, 106, 211), (82, 84, 163),
        (100, 85, 144),
    ]


_CUBE_V = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.float32,
)
_CUBE_F = np.array(
    [
        [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
        [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
        [1, 2, 6], [1, 6, 5], [0, 4, 7], [0, 7, 3],
    ],
    np.int64,
)


def _cuboid(lo, hi):
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    return lo + _CUBE_V * (hi - lo)


def write_mask(mask, path, color=(0, 255, 0), threshold=0.5):
    """Cube-per-voxel mesh of a binary/soft 3D mask (visualization.py
    write_mask equivalent). mask: (X, Y, Z)."""
    mask = np.asarray(mask)
    verts, faces, colors = [], [], []
    for x, y, z in zip(*np.where(mask > threshold)):
        base = len(verts)
        v = _cuboid((x, y, z), (x + 1, y + 1, z + 1))
        verts.extend(v)
        faces.extend(_CUBE_F + base)
        colors.extend([color] * 8)
    if not verts:
        verts = [(0, 0, 0)]
        colors = [color]
        faces = []
    write_ply(path, np.asarray(verts), colors=colors, faces=faces)


def write_bbox(boxes, path, edge_radius=0.15):
    """Wireframe boxes: 12 thin cuboid edges per box.

    boxes: (N, >=6) corner boxes; column 6 (if present) colors by class via
    the palette (visualization.py write_bbox equivalent).
    """
    palette = create_color_palette()
    verts, faces, colors = [], [], []
    edges = [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
    for box in np.asarray(boxes):
        x0, y0, z0, x1, y1, z1 = box[:6]
        cls = int(box[6]) if box.shape[0] > 6 else 1
        color = palette[cls % len(palette)]
        corners = np.array(
            [
                [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
            ]
        )
        for a, b in edges:
            lo = np.minimum(corners[a], corners[b]) - edge_radius
            hi = np.maximum(corners[a], corners[b]) + edge_radius
            base = len(verts)
            verts.extend(_cuboid(lo, hi))
            faces.extend(_CUBE_F + base)
            colors.extend([color] * 8)
    if not verts:
        verts = [(0, 0, 0)]
        colors = [(0, 0, 0)]
        faces = []
    write_ply(path, np.asarray(verts), colors=colors, faces=faces)


def visualize_chunk(chunk_path, out_dir, cfg):
    """`data` mode: dump geometry/boxes/masks of one .chunk file
    (visualization.py:340-420 equivalent)."""
    from tpu3dsis_torch.io.dataset import SceneDataset, paint_mask_canvas

    os.makedirs(out_dir, exist_ok=True)
    ds = SceneDataset.__new__(SceneDataset)
    ds.mode = "chunk"
    ds.cfg = cfg
    if cfg.LABEL_MAP:
        from tpu3dsis_torch.config import load_label_mapping

        ds.mapping, ds.weights = load_label_mapping(cfg.LABEL_MAP)
    else:
        ds.mapping, ds.weights = None, None
    sample = ds.load(chunk_path)
    occupancy = sample.data[..., 0] <= 1.0
    write_mask(occupancy, os.path.join(out_dir, "data.ply"), color=(128, 128, 128))
    write_bbox(sample.gt_box, os.path.join(out_dir, "bbox.ply"))
    write_mask(
        paint_mask_canvas(sample), os.path.join(out_dir, "mask.ply"),
        color=(0, 200, 0),
    )


def visualize_result(result_dir, out_dir):
    """`result` mode: render saved predictions from a TEST_SAVE_DIR scene
    folder (visualization.py:422-505 equivalent)."""
    os.makedirs(out_dir, exist_ok=True)
    scene = np.load(os.path.join(result_dir, "scene.npy"))
    write_mask(scene, os.path.join(out_dir, "scene.ply"), color=(128, 128, 128))
    boxes = np.load(os.path.join(result_dir, "pred_box.npy"))
    classes = np.load(os.path.join(result_dir, "pred_class.npy"))
    stacked = np.concatenate([boxes, classes[:, None]], axis=1)
    write_bbox(stacked, os.path.join(out_dir, "pred_bbox.ply"))
    mask_file = os.path.join(result_dir, "pred_mask")
    if os.path.isfile(mask_file):
        with open(mask_file, "rb") as f:
            masks = pickle.load(f)
        canvas = np.zeros(scene.shape, np.uint8)
        for box, mask in zip(boxes, masks):
            r = np.round(box).astype(int)
            r = np.clip(r, 0, [*scene.shape, *scene.shape])
            sub = canvas[r[0] : r[3], r[1] : r[4], r[2] : r[5]]
            m = np.asarray(mask)[: sub.shape[0], : sub.shape[1], : sub.shape[2]]
            sub |= m.astype(np.uint8)
        write_mask(canvas, os.path.join(out_dir, "pred_mask.ply"), color=(0, 200, 0))
