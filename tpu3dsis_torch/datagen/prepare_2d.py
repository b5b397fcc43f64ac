"""2D frame prep: ScanNet `.sens` -> color / depth / pose (/ label) files.

Python re-implementation of ``datagen/ScanReal/python/prepare_2d_data.py:34-108``
and its SensorData reader: export every ``frame_skip``-th frame's color
(jpeg, resized), depth (16-bit png, mm) and camera-to-world pose, at
320x240 by default, into the ``frames_square`` layout the color pipeline
reads (BASE_IMAGE_PATH/<scene>/{color,depth,pose}). With ``label_dir`` +
``label_mapping`` it additionally exports mapped label frames
(``prepare_2d_data.py:38-56,84-108``: raw ScanNet label pngs -> nearest
resize -> raw-id->nyu40id remap -> uint8 png under label/) — the input of
``USE_IMAGES_GT`` runs (io/frames.py::load_label_image).

The .sens binary layout is the public ScanNet SensorData format:
  version i4, strlen Q + sensor name,
  4x 4x4 f4 matrices (calibration color/depth intrinsic+extrinsic),
  color/depth compression type i4 each,
  color W/H i4, depth W/H i4, depth shift f4, num_frames Q,
  then per frame: camera_to_world 16f, 2x u64 timestamps,
  color_size Q, depth_size Q, jpeg bytes, zlib-compressed u16 depth.

A copy of the JAX package's ``tpu3dsis/datagen/prepare_2d.py``, numpy on the host as the
original is; ``tests/test_torch_datagen.py`` holds its outputs equal to
the original's.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


class SensFile:
    def __init__(self, path):
        self.path = path
        self.file = open(path, "rb")
        f = self.file
        (self.version,) = struct.unpack("<I", f.read(4))
        (strlen,) = struct.unpack("<Q", f.read(8))
        self.sensor_name = f.read(strlen).decode("ascii", "replace")
        self.intrinsic_color = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.extrinsic_color = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.intrinsic_depth = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.extrinsic_depth = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        (self.color_compression,) = struct.unpack("<i", f.read(4))
        (self.depth_compression,) = struct.unpack("<i", f.read(4))
        self.color_width, self.color_height = struct.unpack("<II", f.read(8))
        self.depth_width, self.depth_height = struct.unpack("<II", f.read(8))
        (self.depth_shift,) = struct.unpack("<f", f.read(4))
        (self.num_frames,) = struct.unpack("<Q", f.read(8))
        self._frame_offsets = None

    def _index_frames(self):
        if self._frame_offsets is not None:
            return
        self._frame_offsets = []
        f = self.file
        f.seek(4 + 8 + len(self.sensor_name) + 4 * 64 + 8 + 8 + 8 + 4 + 8)
        for _ in range(self.num_frames):
            off = f.tell()
            f.seek(16 * 4 + 8 + 8, os.SEEK_CUR)
            color_size, depth_size = struct.unpack("<QQ", f.read(16))
            f.seek(color_size + depth_size, os.SEEK_CUR)
            self._frame_offsets.append(off)

    def read_frame(self, idx):
        """-> (pose 4x4, color jpeg bytes, depth (H, W) uint16)."""
        self._index_frames()
        f = self.file
        f.seek(self._frame_offsets[idx])
        pose = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        f.seek(16, os.SEEK_CUR)  # timestamps
        color_size, depth_size = struct.unpack("<QQ", f.read(16))
        color = f.read(color_size)
        depth_bytes = zlib.decompress(f.read(depth_size))
        depth = np.frombuffer(depth_bytes, np.uint16).reshape(
            self.depth_height, self.depth_width
        )
        return pose, color, depth

    def close(self):
        self.file.close()


def read_scannet_label_mapping(tsv_path, label_from="id", label_to="nyu40id"):
    """ScanNet BenchmarkScripts ``util.read_label_mapping`` equivalent.

    Parses scannetv2-labels.combined.tsv into {raw label id -> nyu40 id}
    (the mapping prepare_2d_data.py:70 loads for --export_label_images).
    Rows without a source id are skipped.
    """
    import csv

    mapping = {}
    with open(tsv_path, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            src = row.get(label_from, "").strip()
            dst = row.get(label_to, "").strip()
            if src == "":
                continue
            mapping[int(src)] = int(dst) if dst else 0
    return mapping


def map_label_image(image, label_mapping):
    """convert_scannet_label_image semantics (prepare_2d_data.py:57-62):
    remap every known raw id; UNMAPPED ids pass through; result uint8."""
    mapped = np.copy(image)
    for k, v in label_mapping.items():
        mapped[image == k] = v
    return mapped.astype(np.uint8)


def export_frames(
    sens_path,
    out_dir,
    frame_skip=20,
    image_size=(320, 240),
    label_dir=None,
    label_mapping=None,
):
    """prepare_2d_data.py:63-108 equivalent (frame_skip 20, 320x240).

    label_dir: the scene's raw label-png directory (scene*/label-filt) —
    when given (with label_mapping from read_scannet_label_mapping), mapped
    uint8 label frames are exported under out_dir/label/<i>.png, nearest-
    resized to image_size (prepare_2d_data.py:102-108).
    """
    import io as _io

    from PIL import Image

    if label_dir is not None and label_mapping is None:
        raise ValueError("label export needs label_mapping "
                         "(read_scannet_label_mapping of the combined tsv)")
    sens = SensFile(sens_path)
    subs = ("color", "depth", "pose") + (("label",) if label_dir else ())
    for sub in subs:
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    w, h = image_size
    for i in range(0, sens.num_frames, frame_skip):
        pose, color_jpeg, depth = sens.read_frame(i)
        img = Image.open(_io.BytesIO(color_jpeg)).convert("RGB")
        img = img.resize((w, h), Image.BILINEAR)
        img.save(os.path.join(out_dir, "color", f"{i}.jpg"))
        d = Image.fromarray(depth)
        d = d.resize((w, h), Image.NEAREST)
        d.save(os.path.join(out_dir, "depth", f"{i}.png"))
        np.savetxt(os.path.join(out_dir, "pose", f"{i}.txt"), pose, fmt="%f")
        if label_dir is not None:
            raw = np.array(
                Image.open(os.path.join(label_dir, f"{i}.png"))
            )
            raw = np.array(
                Image.fromarray(raw).resize((w, h), Image.NEAREST)
            )
            Image.fromarray(map_label_image(raw, label_mapping)).save(
                os.path.join(out_dir, "label", f"{i}.png")
            )
    sens.close()
