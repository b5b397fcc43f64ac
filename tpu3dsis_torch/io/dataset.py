"""Host-side dataset: `.chunk`/`.scene` decoding -> samples.

A copy of the JAX package's ``tpu3dsis/io/dataset.py`` (``Sample``,
``encode_tsdf``, ``SceneDataset`` in its chunk, scene and benchmark modes),
held equal to it sample for sample by ``tests/test_torch_io.py``. It
reproduces the reference's ``lib/datasets/dataset.py:45-218``: the TSDF
encodings, floor/ceil box rounding, the label remap, the KEEP_THRESH
filter, the nearest-image frames, the ``world2grid`` padding and the height
crop (480 voxels in benchmark mode, else 48). Volumes are channels-last
(X, Y, Z, C) numpy arrays. The training helpers ``paint_mask_canvas`` and
``pad_sample`` are copies too, and so is the native decoder's fast path,
``load_fast_padded`` (``runtime/native.py``).
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


def fast_path_applies(dataset: SceneDataset, cfg: Config) -> bool:
    """Whether ``load_fast_padded`` may serve this dataset: chunk-mode
    geometry training (no frames; the canvas in place of per-instance
    masks)."""
    return not cfg.USE_IMAGES and dataset.mode == "chunk"


def load_fast_padded(dataset: SceneDataset, path: str, cfg: Config):
    """Native-decoder fast path -> the padded training dict ``pad_sample``
    makes, or None where the numpy path must decide.

    None without ``fast_path_applies``, and where a gt box would be filtered
    (KEEP_THRESH / zero weight / height crop), there are none or more than
    ``TPU_MAX_GT``, or a mask's dims differ from its box's extent: the
    native painter paints ALL file boxes, so its canvas would disagree with
    the reference's painting of only the kept ones. Raises where the library
    does not build (``runtime/native.py``) and for a malformed file.
    """
    if not fast_path_applies(dataset, cfg):
        return None
    from tpu3dsis_torch.runtime.native import decode_chunk_native

    mode = 1 if cfg.FLIP_TSDF else (2 if cfg.LOG_TSDF else 0)
    try:
        out = decode_chunk_native(path, float(cfg.TRUNCATED), mode)
    except ValueError:
        return None
    n = out["boxes"].shape[0]
    if n == 0 or n > int(cfg.TPU_MAX_GT):
        return None
    gt_box = np.zeros((n, 7), np.float32)
    gt_box[:, :3] = np.floor(out["boxes"][:, :3])
    gt_box[:, 3:6] = np.ceil(out["boxes"][:, 3:6])
    for i in range(n):
        label = int(out["labels"][i])
        if dataset.mapping is not None:
            label = dataset.mapping[label]
        gt_box[i, 6] = label
        if cfg.KEEP_THRESH or cfg.USE_IMAGES:
            frac = _box_fraction_in_chunk(gt_box[i])
            if frac < cfg.KEEP_THRESH or (dataset.weights is not None and dataset.weights[label] == 0):
                return None  # a drop changes the canvas: numpy path
        if gt_box[i, 1] > 48 or gt_box[i, 4] > 48:
            return None
    max_gt = int(cfg.TPU_MAX_GT)
    boxes = np.zeros((max_gt, 7), np.float32)
    boxes[:, :3] = -1e4
    boxes[:, 3:6] = -1e4 + 1.0
    boxes[:n] = gt_box
    valid = np.zeros((max_gt,), bool)
    valid[:n] = True
    return {
        "data": out["data"][:, :48],
        "gt_box": boxes,
        "gt_valid": valid,
        "mask_canvas": out["mask_canvas"][:, :48],
    }


def paint_mask_canvas(sample: Sample, shape=None) -> np.ndarray:
    """Paint per-instance masks into one binary volume, in gt-box order.

    Matches the canvas built by the reference mask target layer
    (``mask_target_layer.py:26-29``): later boxes overwrite earlier ones
    (including their zeros), so a single canvas loses instance identity — the
    training target is a binary crop of this canvas.
    """
    if shape is None:
        shape = sample.data.shape[:3]
    canvas = np.zeros(shape, dtype=np.float32)
    for box, mask in zip(sample.gt_box, sample.gt_mask):
        x0, y0, z0, x1, y1, z1 = [int(v) for v in box[:6]]
        x0c, y0c, z0c = max(x0, 0), max(y0, 0), max(z0, 0)
        x1c = min(x1, shape[0])
        y1c = min(y1, shape[1])
        z1c = min(z1, shape[2])
        if x1c <= x0c or y1c <= y0c or z1c <= z0c:
            continue
        sub = mask[
            x0c - x0 : x1c - x0, y0c - y0 : y1c - y0, z0c - z0 : z1c - z0
        ].astype(np.float32)
        canvas[x0c:x1c, y0c:y1c, z0c:z1c] = sub
    return canvas


def pad_sample(sample: Sample, cfg: Config, with_mask_canvas: bool = True):
    """Fixed-capacity arrays: gt boxes padded to TPU_MAX_GT.

    Returns a dict of numpy arrays ready for the train step:
      data (X, Y, Z, 2) | gt_box (MAX_GT, 7) | gt_valid (MAX_GT,) bool
      mask_canvas (X, Y, Z) float32 (optional)
    Overflowing gt boxes are dropped (logged by the caller).
    """
    max_gt = int(cfg.TPU_MAX_GT)
    n = min(sample.gt_box.shape[0], max_gt)
    gt_box = np.zeros((max_gt, 7), dtype=np.float32)
    # degenerate padding boxes far outside the volume so IoU against them is 0
    gt_box[:, :3] = -1e4
    gt_box[:, 3:6] = -1e4 + 1.0
    gt_valid = np.zeros((max_gt,), dtype=bool)
    if n:
        gt_box[:n] = sample.gt_box[:n]
        gt_valid[:n] = True
    out = {
        "data": sample.data,
        "gt_box": gt_box,
        "gt_valid": gt_valid,
    }
    if with_mask_canvas:
        out["mask_canvas"] = paint_mask_canvas(sample)
    if cfg.USE_IMAGES and sample.images is not None:
        v = int(cfg.NUM_IMAGES)
        nv = min(sample.images.shape[0], v)
        # preserve the source dtype: uint8 under TPU_COMPACT_TRANSFERS
        images = np.zeros((v, *sample.images.shape[1:]), sample.images.dtype)
        depths = np.zeros((v, *sample.depths.shape[1:]), np.float32)
        poses = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
        view_valid = np.zeros((v,), bool)
        images[:nv] = sample.images[:nv]
        depths[:nv] = sample.depths[:nv]
        poses[:nv] = sample.poses[:nv]
        view_valid[:nv] = True
        out.update(
            images=images,
            depths=depths,
            poses=poses,
            view_valid=view_valid,
            world_to_grid=sample.world_to_grid,
        )
    return out
