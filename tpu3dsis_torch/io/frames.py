"""RGB-D frame loading: color, depth and pose with the reference's preprocessing.

A copy of the JAX package's ``tpu3dsis/io/frames.py`` (reference
``lib/datasets/dataset.py:231-266``): resize (NEAREST) to the target height
keeping the aspect ratio, centre crop to (H, W); depth in mm -> metres;
color scaled to [0, 1] and normalised by mean and std, or kept ``uint8``;
label images stay single-channel. Arrays are channels-last (H, W, C).

PIL decodes the images. It is imported inside the loaders only, so that no
path without frames on disk imports it; where it is missing, reading
frames raises an ImportError that names it.
"""

from __future__ import annotations

import math
import os

import numpy as np


def _pil_image():
    """PIL's ``Image`` module, imported at the first frame read."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading frames from disk (USE_IMAGES with a frames directory) needs PIL (the Pillow "
                          "package), which is not installed") from e
    return Image


def load_pose(filename: str) -> np.ndarray:
    """4x4 camera-to-world (dataset.py:231-236)."""
    with open(filename) as f:
        lines = [l.split() for l in f.read().splitlines() if l.strip()]
    if len(lines) != 4:
        raise ValueError(f"{filename}: a pose has 4 rows, not {len(lines)}")
    return np.asarray([[float(x) for x in row[:4]] for row in lines], np.float32)


def resize_crop_image(image: np.ndarray, image_dims) -> np.ndarray:
    """image_dims = (W, H) — reference convention (dataset.py:238-246)."""
    h, w = image.shape[0], image.shape[1]
    if [w, h] == list(image_dims):
        return image
    Image = _pil_image()
    new_w, new_h = image_dims
    resize_width = int(math.floor(new_h * float(w) / float(h)))
    im = Image.fromarray(image).resize((resize_width, new_h), resample=Image.NEAREST)
    # center crop to (new_h, new_w)
    left = (resize_width - new_w) // 2
    im = im.crop((left, 0, left + new_w, new_h))
    return np.array(im)


def load_depth(path: str, depth_shape) -> np.ndarray:
    """(H, W) float32 meters (dataset.py:248-253). depth_shape = (W, H)."""
    depth = np.array(_pil_image().open(path))
    depth = resize_crop_image(depth, depth_shape)
    return depth.astype(np.float32) / 1000.0


def load_color(path: str, image_shape, color_mean, color_std, normalize=True) -> np.ndarray:
    """(H, W, 3) normalized float32 (dataset.py:255-261).

    normalize=False returns the resized image as raw uint8;
    ``ColorProjector.image_features`` applies the same /255, -mean, /std
    float32 ops on the device.
    """
    img = np.array(_pil_image().open(path))
    img = resize_crop_image(img, image_shape)
    if not normalize:
        return img.astype(np.uint8)
    img = img.astype(np.float32) / 255.0
    return (img - np.asarray(color_mean, np.float32)) / np.asarray(color_std, np.float32)


def load_label_image(path: str, image_shape, mapping=None, weights=None):
    """(H, W, 1) label image with the gt-label remap (dataset.py:175-182)."""
    img = np.array(_pil_image().open(path))
    img = resize_crop_image(img, image_shape)
    img = np.where(img <= 40, img, 0)
    if mapping is not None:
        out = np.zeros_like(img)
        for k, v in mapping.items():
            if weights is not None and weights[v] == 0:
                v = 0
            out[img == k] = v
        img = out
    return img[..., None].astype(np.float32)


class FrameSource:
    """Per-scene frame directory access (BASE_IMAGE_PATH layout).

    Layout (frames_square): <base>/<scene>/{depth,pose,color|label}/<id>.*
    plus world2grid.txt for whole scenes (dataset.py:151-186).
    """

    def __init__(self, cfg, scene_name: str):
        self.cfg = cfg
        self.root = os.path.join(cfg.BASE_IMAGE_PATH, scene_name)

    def frame_ids(self):
        d = os.path.join(self.root, "depth")
        return sorted(int(f.split(".")[0]) for f in os.listdir(d) if f[0].isdigit())

    def world_to_grid(self, padding=(10, 16, 10)):
        w2g = load_pose(os.path.join(self.root, "world2grid.txt"))
        w2g = w2g.copy()
        w2g[0, 3] -= padding[0]
        w2g[1, 3] -= padding[1]
        w2g[2, 3] -= padding[2]
        return w2g

    def load_frame(self, frameid, mapping=None, weights=None):
        cfg = self.cfg
        depth = load_depth(os.path.join(self.root, "depth", f"{frameid}.png"), cfg.DEPTH_SHAPE)
        pose = load_pose(os.path.join(self.root, "pose", f"{frameid}.txt"))
        img_path = os.path.join(self.root, cfg.IMAGE_TYPE, f"{frameid}{cfg.IMAGE_EXT}")
        if cfg.USE_IMAGES_GT:
            image = load_label_image(img_path, cfg.IMAGE_SHAPE, mapping, weights)
        else:
            image = load_color(img_path, cfg.IMAGE_SHAPE, cfg.COLOR_MEAN, cfg.COLOR_STD,
                               normalize=not bool(dict.get(cfg, "TPU_COMPACT_TRANSFERS", False)))
        return image, depth, pose
