"""Host-side dataset: `.chunk`/`.scene` decoding -> samples.

A copy of the JAX package's ``tpu3dsis/io/dataset.py`` (``Sample``,
``encode_tsdf``, ``SceneDataset`` in its chunk, scene and benchmark modes),
held equal to it sample for sample by ``tests/test_torch_io.py``. It
reproduces the reference's ``lib/datasets/dataset.py:45-218``: the TSDF
encodings, floor/ceil box rounding, the label remap, the KEEP_THRESH
filter, the nearest-image frames, the ``world2grid`` padding and the height
crop (480 voxels in benchmark mode, else 48). Volumes are channels-last
(X, Y, Z, C) numpy arrays. The training-only helpers (``load_fast_padded``,
``paint_mask_canvas``, ``pad_sample``) come with the training slice.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

from tpu3dsis_torch.config import Config, load_label_mapping
from tpu3dsis_torch.io.chunk_format import read_chunk_file
from tpu3dsis_torch.io.frames import FrameSource

CHUNK_DIMS = (96, 48, 96)  # datagen/SceneSampler/zParameters.txt s_chunkDim


@dataclasses.dataclass
class Sample:
    """One decoded scene/chunk, before fixed-shape padding."""

    sample_id: str
    data: np.ndarray  # (X, Y, Z, 2) float32 encoded TSDF
    gt_box: np.ndarray  # (N, 7) float32 [minx..maxz, mapped label]
    gt_mask: list  # N per-instance box-crop uint8 masks
    world_to_grid: np.ndarray  # (4, 4) float32
    frame_ids: np.ndarray  # (M,) uint32
    # color pipeline (USE_IMAGES): per-frame arrays, ragged in V
    images: np.ndarray | None = None  # (V, H, W, C) color/label images
    depths: np.ndarray | None = None  # (V, Hd, Wd)
    poses: np.ndarray | None = None  # (V, 4, 4) camera-to-world


def encode_tsdf(sdf: np.ndarray, cfg: Config) -> np.ndarray:
    """(X, Y, Z) raw sdf -> (X, Y, Z, 2) [encoded |tsdf|, occupancy].

    The three encodings of ``dataset.py:55-68`` (FLIP / LOG / plain abs),
    occupancy channel = sdf > -1.
    """
    trunc = np.clip(sdf, -cfg.TRUNCATED, cfg.TRUNCATED)
    trunc_abs = np.abs(trunc)
    if cfg.FLIP_TSDF:
        enc = cfg.TRUNCATED - trunc_abs
    elif cfg.LOG_TSDF:
        enc = np.log(trunc_abs)
    else:
        enc = trunc_abs
    occ = np.greater(sdf, -1).astype(np.float32)
    return np.stack([enc.astype(np.float32), occ], axis=-1)


def _box_fraction_in_chunk(gt_box: np.ndarray) -> float:
    """Fraction of the (rounded) box inside the 96x48x96 chunk.

    Port of ``Dataset.outbbox_thresh`` (``dataset.py:220-229``) including its
    hardcoded chunk dims.
    """
    overall = (
        (gt_box[3] - gt_box[0]) * (gt_box[4] - gt_box[1]) * (gt_box[5] - gt_box[2])
    )
    minx = min(max(gt_box[0], 0), 96)
    miny = min(max(gt_box[1], 0), 48)
    minz = min(max(gt_box[2], 0), 96)
    maxx = min(max(gt_box[3], 0), 96)
    maxy = min(max(gt_box[4], 0), 48)
    maxz = min(max(gt_box[5], 0), 96)
    part_in = (maxx - minx) * (maxy - miny) * (maxz - minz)
    return part_in / overall


class SceneDataset:
    """Filelist-driven dataset over `.chunk`/`.scene` files.

    mode in {"chunk", "scene", "benchmark"} — same height-crop / filtering
    table as the reference (``dataset.py:23-30``).
    """

    def __init__(self, data_location: str, mode: str, cfg: Config):
        self.mode = mode
        self.cfg = cfg
        if os.path.isdir(data_location):
            self.scenes = sorted(
                os.path.join(data_location, x)
                for x in os.listdir(data_location)
                if os.path.isfile(os.path.join(data_location, x))
            )
        else:
            with open(data_location) as f:
                self.scenes = [x.strip() for x in f if x.strip()]
        if cfg.LABEL_MAP:
            self.mapping, self.weights = load_label_mapping(cfg.LABEL_MAP)
        else:
            self.mapping, self.weights = None, None

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, idx: int) -> Sample:
        return self.load(self.scenes[idx])

    def load(self, path: str) -> Sample:
        cfg = self.cfg
        raw = read_chunk_file(path, with_masks=True)
        data = encode_tsdf(raw.sdf, cfg)

        # --- gt boxes: floor/ceil + label remap (dataset.py:81-87) ---
        n = raw.boxes.shape[0]
        gt_box = np.zeros((n, 7), dtype=np.float32)
        for i in range(n):
            b = raw.boxes[i]
            label = int(raw.labels[i])
            if self.mapping is not None:
                label = self.mapping[label]
            gt_box[i] = [
                math.floor(b[0]),
                math.floor(b[1]),
                math.floor(b[2]),
                math.ceil(b[3]),
                math.ceil(b[4]),
                math.ceil(b[5]),
                label,
            ]
        gt_mask = [np.where(m > 1, 0, m).astype(np.uint8) for m in raw.masks]

        # --- KEEP_THRESH / zero-weight filter (dataset.py:107-130) ---
        if cfg.KEEP_THRESH or cfg.USE_IMAGES:
            keep = []
            for i in range(n):
                frac = (
                    _box_fraction_in_chunk(gt_box[i])
                    if self.mode == "chunk"
                    else float(raw.box_in_vol[i])
                )
                if frac >= cfg.KEEP_THRESH and (
                    self.weights is None or self.weights[int(gt_box[i, 6])] != 0
                ):
                    keep.append(i)
            gt_box = gt_box[keep]
            gt_mask = [gt_mask[i] for i in keep]

        # --- nearest-image frames (dataset.py:135-187) ---
        images = depths = poses = None
        world_to_grid = raw.world_to_grid
        if cfg.USE_IMAGES:
            base = os.path.basename(path)
            if cfg.BASE_IMAGE_PATH.rstrip("/").endswith("augmented"):
                scene_name = (
                    base.rsplit("_", 1)[0]
                    if self.mode == "chunk"
                    else base.split(".")[0]
                )
            elif cfg.BASE_IMAGE_PATH.rstrip("/").endswith("square"):
                scene_name = base.split("__")[0]
            else:
                raise NotImplementedError(cfg.BASE_IMAGE_PATH)
            src = FrameSource(cfg, scene_name)
            if self.mode != "chunk":
                fids = src.frame_ids()
                world_to_grid = src.world_to_grid()  # pad -[10,16,10]
            else:
                fids = [int(f) for f in raw.frame_ids]
                # train-time cap to NUM_IMAGES (dataloader.py:23-28)
                cap = cfg.NUM_IMAGES
                if cfg.RANDOM_NUM_IMAGES and cfg.MODE == "train":
                    cap = np.random.randint(1, cfg.NUM_IMAGES + 1)
                if cfg.MODE == "train":
                    fids = fids[:cap]
            ims, dps, pss = [], [], []
            for fid in fids:
                im, dp, ps = src.load_frame(fid, self.mapping, self.weights)
                ims.append(im)
                dps.append(dp)
                pss.append(ps)
            images = np.stack(ims) if ims else None
            depths = np.stack(dps) if dps else None
            poses = np.stack(pss) if pss else None

        # --- height crop (dataset.py:192-205) ---
        max_height = 480 if self.mode == "benchmark" else 48
        keep = [
            i
            for i, b in enumerate(gt_box)
            if b[1] <= max_height and b[4] <= max_height
        ]
        gt_box = gt_box[keep] if len(gt_box) else gt_box.reshape(0, 7)
        gt_mask = [gt_mask[i] for i in keep]
        data = data[:, :max_height, :, :]

        return Sample(
            sample_id=path,
            data=data,
            gt_box=gt_box,
            gt_mask=gt_mask,
            world_to_grid=world_to_grid,
            frame_ids=raw.frame_ids,
            images=images,
            depths=depths,
            poses=poses,
        )
