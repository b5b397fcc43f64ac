"""Configuration: the YAML config files, and the settings the detector reads.

``Config``, ``default_config``, ``merge_into``, ``cfg_from_file``,
``cfg_to_file``, ``load_label_mapping`` and ``finalize_config`` are copies
of the JAX package's ``tpu3dsis/config/config.py``: every key and default
of ``experiments/cfgs/**/*.yml``, the same strict merge (unknown keys raise
KeyError, type mismatches ValueError, ints promoted to float and bool
defaults). The files are read and written by ``yaml_subset``, so no YAML
library is imported. ``DetectorConfig`` is the frozen subset of those keys
that the port's detection, scene and color paths read, under the same
names; ``DetectorConfig.from_cfg`` takes it from a ``Config``.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
from dataclasses import dataclass

from tpu3dsis_torch import yaml_subset


class Config(dict):
    """A dict with attribute access (replacement for easydict)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    @staticmethod
    def deep(d):
        """Recursively convert nested dicts into Config."""
        if isinstance(d, dict):
            return Config({k: Config.deep(v) for k, v in d.items()})
        if isinstance(d, list):
            return [Config.deep(v) for v in d]
        return d

    def copy(self):
        return Config.deep(copy.deepcopy(dict(self)))


def default_config() -> Config:
    """Every key with its default (``tpu3dsis/config/config.py:50-268``; the
    reference's ``lib/utils/config.py``, then the ``TPU_`` extensions)."""
    c = Config()

    c.LEARNING_RATE = 0.001
    c.MOMENTUM = 0.9
    c.WEIGHT_DECAY = 0.0005
    c.GAMMA = 0.1
    c.STEPSIZE = [30000]
    c.DISPLAY = 10
    c.DOUBLE_BIAS = True
    c.INIT_TRUNCATED = True
    c.BIAS_DECAY = False

    c.RPN_POSITIVE_OVERLAP = 0.6
    c.RPN_NEGATIVE_OVERLAP = 0.2
    c.RPN_FG_FRACTION = 0.5
    c.RPN_BATCHSIZE = 256
    c.ALLOW_BORDER = 0
    c.FIRST_TIME_ANCHORS = True
    c.RPN_CHANNELS = 256

    c.TRAIN = Config()
    c.TRAIN.RPN_NMS_THRESH = 0.7
    c.TRAIN.RPN_PRE_NMS_TOP_N = 12000
    c.TRAIN.RPN_POST_NMS_TOP_N = 2000
    c.TEST = Config()
    c.TEST.RPN_NMS_THRESH = 0.35
    c.TEST.RPN_PRE_NMS_TOP_N = 6000
    c.TEST.RPN_POST_NMS_TOP_N = 300

    c.CLASS_BATCH_SIZE = 128
    c.FG_FRACTION = 0.25
    c.FG_THRESH = 0.3
    c.BG_THRESH = 0.2
    c.BG_THRESH_LO = 0.2
    c.USE_GT = True
    c.NORMALIZE_WEIGHTS = 1.0
    c.CLASS_POOLING_SIZE = 2

    c.MASK_FG_THRESH = 0.5
    c.MASK_USE_IMAGES = False
    c.MASK_ONLY_IMAGES = False

    c.VAL_TIME = 2.0
    c.SNAPSHOT_KEPT = 3
    c.VAL_NUM = 20
    c.VAL_SAVE_DIR = ""
    c.TEST_SAVE_DIR = ""

    c.MAP_THRESH = 0.25
    c.ROI_THRESH = 0.9
    c.CLASS_THRESH = 0.9
    c.MASK_THRESH = 0.5
    c.MODE = ""
    c.MAX_IMAGE = 400
    c.MAX_VOLUME = 2000000

    c.NUM_CLASSES = 0
    c.BATCH_SIZE = 1
    c.TRAIN_FILELIST = ""
    c.VAL_FILELIST = ""
    c.TEST_FILELIST = ""
    c.TRAINVAL_FILELIST = ""
    c.KEEP_THRESH = 0.0
    c.LABEL_MAP = "datagen/fileLists/nyu40labels.csv"
    c.VOXEL_SIZE = 0.09375
    c.TRUNCATED = 3.0
    c.FLIP_TSDF = False
    c.LOG_TSDF = False

    c.NUM_ANCHORS_LEVEL1 = 9
    c.NUM_ANCHORS_LEVEL2 = 9
    c.NUM_ANCHORS_LEVEL3 = 9
    c.ANCHORS_TYPE_LEVEL1 = "suncg"
    c.ANCHORS_TYPE_LEVEL2 = "suncg"
    c.ANCHORS_TYPE_LEVEL3 = "suncg"
    c.FILTER_ANCHOR_LEVEL1 = ""
    c.FILTER_ANCHOR_LEVEL2 = ""
    c.FILTER_ANCHOR_LEVEL3 = ""

    c.LOAD_BACKBONE = False
    c.USE_BACKBONE = False
    c.FIX_BACKBONE = False
    c.LOAD_RPN = False
    c.USE_RPN = False
    c.FIX_RPN = False
    c.LOAD_CLASS = False
    c.USE_CLASS = False
    c.FIX_CLASS = False
    c.USE_MASK = True
    c.FIX_ENET = True
    c.NET = "overfitting_net"
    c.MASK_BACKBONE = ""

    c.USE_IMAGES = False
    c.ONLY_IMAGES = False
    c.USE_IMAGES_GT = True
    c.NUM_2D_CLASSES = 41
    c.NUM_IMAGES = 1
    c.RANDOM_NUM_IMAGES = False
    c.BASE_IMAGE_PATH = "/mnt/local_datasets/SUNCG/suncg_frames"
    c.PRETRAINED_ENET_PATH = ""
    c.IMAGE_SHAPE = [328, 256]
    c.PROJ_DEPTH_MIN = 0.1
    c.PROJ_DEPTH_MAX = 4.0
    c.IMAGE_TYPE = "color2"
    c.IMAGE_EXT = ".jpg"
    c.DEPTH_SHAPE = [41, 32]
    c.NUM_IMAGE_CHANNELS = 128
    c.INTRINSIC = [
        [35.5070229, 0, 20, 0],
        [0, 36.9504013, 15.5, 0],
        [0, 0, 1, 0],
        [0, 0, 0, 1],
    ]
    c.COLOR_MEAN = [0.47083, 0.44685, 0.40733]
    c.COLOR_STD = [0.27861, 0.27409, 0.28844]

    c.NYUV2_FINETUNE = False

    c.DEBUG = False
    c.TPU_MAX_GT = 64
    c.TPU_COMPUTE_DTYPE = "float32"
    c.TPU_DATA_PARALLEL = 0
    c.TPU_MASK_CANVAS = [96, 48, 96]
    c.TPU_TILE_SIZE = [96, 48, 96]
    c.TPU_TILE_STRIDE = [43, 9, 43]
    c.TPU_STITCH_NMS_THRESH = 0.25
    c.TPU_MASK_INFER_CANVAS = [64, 48, 64]
    c.TPU_MASK_INFER_CANVAS_SMALL = [32, 32, 32]
    c.TPU_FUSED_PRE_NMS = 1024
    c.TPU_FUSED_MAX_DETECTIONS = 64
    c.TPU_FUSED_LARGE_WINDOWS = 12
    c.TPU_MAX_MASK_ROIS = 16
    c.TPU_MASK_CANVAS_SMALL = [0, 0, 0]
    c.TPU_MAX_LARGE_MASK_ROIS = 16
    c.TPU_MASK_EXTRA_WINDOWS = 4
    c.TPU_MAX_TILE_VIEWS = 16
    c.TPU_SCENE_COLOR_RESIDENT = "auto"
    c.TPU_COLOR_VOLUME_MAX_MB = 2048
    c.TPU_COLOR_VIEWS_PER_STEP = 1
    c.TPU_COLOR_SCAN_UNROLL = 8
    c.TPU_SCENE_MODE = "tiled"
    c.TPU_SCENE_TILE_PARALLEL = 0
    c.TPU_COMPACT_TRANSFERS = True

    return c



def merge_into(overlay: dict, base: Config) -> None:
    """Strict merge of ``overlay`` into ``base`` in place: unknown keys raise
    KeyError; type mismatches raise ValueError, except an int for a float
    or bool default (promoted) and a list for a list."""
    if not isinstance(overlay, dict):
        return
    for k, v in overlay.items():
        if k not in base:
            raise KeyError("{} is not a valid config key".format(k))
        old = base[k]
        if isinstance(old, dict):
            if not isinstance(v, dict):
                raise ValueError("Type mismatch ({} vs. {}) for config key: {}".format(type(old), type(v), k))
            merge_into(v, old)
            continue
        if old is not None and v is not None and type(old) is not type(v):
            if isinstance(old, float) and isinstance(v, int):
                v = float(v)
            elif isinstance(old, bool) and isinstance(v, int):
                v = bool(v)
            elif isinstance(old, list) and isinstance(v, list):
                pass
            else:
                raise ValueError("Type mismatch ({} vs. {}) for config key: {}".format(type(old), type(v), k))
        base[k] = v


def cfg_from_file(filename: str, base: Config | None = None) -> Config:
    """Load a YAML overlay onto the defaults and return the merged Config."""
    cfg = base if base is not None else default_config()
    with open(filename, "r") as f:
        overlay = yaml_subset.load(f.read(), filename)
    if overlay:
        merge_into(overlay, cfg)
    return cfg


def cfg_to_file(cfg: Config, filename: str) -> None:
    with open(filename, "w") as f:
        f.write(yaml_subset.dump(cfg))


def load_label_mapping(label_file: str):
    """The label-map CSV (``nyu40id,nyu40class,mappedId,mappedIdConsecutive,weight``)
    -> (nyu40 id -> consecutive id, class weights with the background's
    0.3280746813009404 first)."""
    mapping = {}
    weights_pre = {}
    weights = [0.3280746813009404]
    with open(label_file) as csvfile:
        for row in csv.DictReader(csvfile, delimiter=","):
            mapping[int(row["nyu40id"])] = int(row["mappedIdConsecutive"])
            weights_pre[int(row["mappedIdConsecutive"])] = float(row["weight"])
    for key in sorted(weights_pre.keys()):
        weights.append(weights_pre[key])
    return mapping, weights


def finalize_config(cfg: Config) -> Config:
    """NUM_CLASSES and NORMALIZE_WEIGHTS from the label map: the weights > 0
    (background and instance classes) and their count."""
    if cfg.LABEL_MAP:
        _, weights = load_label_mapping(cfg.LABEL_MAP)
        cfg.NORMALIZE_WEIGHTS = [w for w in weights if w > 0]
        cfg.NUM_CLASSES = len(cfg.NORMALIZE_WEIGHTS)
    return cfg


def _ints(values) -> tuple:
    return tuple(int(v) for v in values)


def _floats(values) -> tuple:
    return tuple(float(v) for v in values)


# config.py:171-176
_DEFAULT_INTRINSIC = ((35.5070229, 0.0, 20.0, 0.0), (0.0, 36.9504013, 15.5, 0.0), (0.0, 0.0, 1.0, 0.0),
                      (0.0, 0.0, 0.0, 1.0))


@dataclass(frozen=True)
class ProposalConfig:
    """``cfg.TEST``: proposal selection (``tpu3dsis/models/rpn.py:104``)."""

    RPN_PRE_NMS_TOP_N: int
    RPN_POST_NMS_TOP_N: int
    RPN_NMS_THRESH: float


@dataclass(frozen=True)
class DetectorConfig:
    NUM_CLASSES: int
    NET: str
    NUM_ANCHORS_LEVEL1: int
    NUM_ANCHORS_LEVEL2: int
    NUM_ANCHORS_LEVEL3: int
    ANCHORS_TYPE_LEVEL1: str
    ANCHORS_TYPE_LEVEL2: str
    ANCHORS_TYPE_LEVEL3: str
    CLASS_POOLING_SIZE: int
    RPN_CHANNELS: int
    TEST: ProposalConfig
    TPU_COMPUTE_DTYPE: str  # "float32" or "bfloat16"
    USE_RPN: bool
    USE_CLASS: bool
    # --- whole-scene inference (tpu3dsis/config/config.py:109-110, 201-219)
    USE_MASK: bool = False
    MASK_USE_IMAGES: bool = False
    MASK_ONLY_IMAGES: bool = False
    CLASS_THRESH: float = 0.9
    MASK_THRESH: float = 0.5
    TPU_TILE_SIZE: tuple = (96, 48, 96)
    TPU_TILE_STRIDE: tuple = (43, 9, 43)
    TPU_MASK_INFER_CANVAS: tuple = (64, 48, 64)
    TPU_MASK_INFER_CANVAS_SMALL: tuple = (32, 32, 32)
    TPU_STITCH_NMS_THRESH: float = 0.25
    TPU_FUSED_PRE_NMS: int = 1024
    TPU_FUSED_MAX_DETECTIONS: int = 64
    TPU_FUSED_LARGE_WINDOWS: int = 12
    # --- the color stream (tpu3dsis/config/config.py:157-176, 233-253)
    USE_IMAGES: bool = False
    USE_IMAGES_GT: bool = True  # the frames' images are already 2D features: no ENet
    ONLY_IMAGES: bool = False
    NUM_IMAGE_CHANNELS: int = 128
    IMAGE_SHAPE: tuple = (328, 256)  # (W, H)
    DEPTH_SHAPE: tuple = (41, 32)  # (W, H) of the depth maps and the 2D features
    INTRINSIC: tuple = _DEFAULT_INTRINSIC  # 4x4, at DEPTH_SHAPE
    VOXEL_SIZE: float = 0.09375
    PROJ_DEPTH_MIN: float = 0.1
    PROJ_DEPTH_MAX: float = 4.0
    COLOR_MEAN: tuple = (0.47083, 0.44685, 0.40733)
    COLOR_STD: tuple = (0.27861, 0.27409, 0.28844)
    NUM_2D_CLASSES: int = 41
    TPU_MAX_TILE_VIEWS: int = 16
    TPU_SCENE_COLOR_RESIDENT: str = "auto"  # "auto", "never" or "always"
    TPU_COLOR_VOLUME_MAX_MB: int = 2048

    def __post_init__(self):
        # the combinations the JAX package cannot run: its mask FCN's color
        # branch reads the color volume, which only USE_IMAGES makes (its
        # trainstep.py:310-314 hands the branch None), and MASK_ONLY_IMAGES
        # without that branch returns its input unchanged; its ScanNet
        # backbone under ONLY_IMAGES without USE_IMAGES ends geometry1 at 0
        # channels and geometry2 reads 128 (backbones.py:112-142)
        if self.MASK_USE_IMAGES and not self.USE_IMAGES:
            raise ValueError("MASK_USE_IMAGES needs USE_IMAGES: the mask FCN's color branch reads the color volume")
        if self.MASK_ONLY_IMAGES and not self.MASK_USE_IMAGES:
            raise ValueError("MASK_ONLY_IMAGES needs MASK_USE_IMAGES: it runs the mask FCN's color branch alone")
        if self.ONLY_IMAGES and not self.USE_IMAGES and self.NET == "ScanNet_Backbone":
            raise ValueError("ONLY_IMAGES on the ScanNet backbone needs USE_IMAGES: without the color stream "
                             "its level 1 has no channels")
        if self.TPU_SCENE_COLOR_RESIDENT not in ("auto", "never", "always"):
            raise ValueError(f"TPU_SCENE_COLOR_RESIDENT must be auto, never or always, "
                             f"not {self.TPU_SCENE_COLOR_RESIDENT!r}")

    @classmethod
    def from_cfg(cls, cfg) -> "DetectorConfig":
        """Read the detector's, the scene path's and the color stream's keys
        from a ``Config``."""
        test = cfg.TEST
        return cls(
            NUM_CLASSES=int(cfg.NUM_CLASSES),
            NET=str(cfg.NET),
            NUM_ANCHORS_LEVEL1=int(cfg.NUM_ANCHORS_LEVEL1),
            NUM_ANCHORS_LEVEL2=int(cfg.NUM_ANCHORS_LEVEL2),
            NUM_ANCHORS_LEVEL3=int(cfg.NUM_ANCHORS_LEVEL3),
            ANCHORS_TYPE_LEVEL1=str(cfg.ANCHORS_TYPE_LEVEL1),
            ANCHORS_TYPE_LEVEL2=str(cfg.ANCHORS_TYPE_LEVEL2),
            ANCHORS_TYPE_LEVEL3=str(cfg.ANCHORS_TYPE_LEVEL3),
            CLASS_POOLING_SIZE=int(cfg.CLASS_POOLING_SIZE),
            RPN_CHANNELS=int(cfg.RPN_CHANNELS),
            TEST=ProposalConfig(
                RPN_PRE_NMS_TOP_N=int(test.RPN_PRE_NMS_TOP_N),
                RPN_POST_NMS_TOP_N=int(test.RPN_POST_NMS_TOP_N),
                RPN_NMS_THRESH=float(test.RPN_NMS_THRESH),
            ),
            TPU_COMPUTE_DTYPE=str(cfg.TPU_COMPUTE_DTYPE),
            USE_RPN=bool(cfg.USE_RPN),
            USE_CLASS=bool(cfg.USE_CLASS),
            USE_MASK=bool(cfg.USE_MASK),
            MASK_USE_IMAGES=bool(cfg.MASK_USE_IMAGES),
            MASK_ONLY_IMAGES=bool(cfg.MASK_ONLY_IMAGES),
            CLASS_THRESH=float(cfg.CLASS_THRESH),
            MASK_THRESH=float(cfg.MASK_THRESH),
            TPU_TILE_SIZE=_ints(cfg.TPU_TILE_SIZE),
            TPU_TILE_STRIDE=_ints(cfg.TPU_TILE_STRIDE),
            TPU_MASK_INFER_CANVAS=_ints(cfg.TPU_MASK_INFER_CANVAS),
            TPU_MASK_INFER_CANVAS_SMALL=_ints(cfg.TPU_MASK_INFER_CANVAS_SMALL),
            TPU_STITCH_NMS_THRESH=float(cfg.TPU_STITCH_NMS_THRESH),
            TPU_FUSED_PRE_NMS=int(cfg.TPU_FUSED_PRE_NMS),
            TPU_FUSED_MAX_DETECTIONS=int(cfg.TPU_FUSED_MAX_DETECTIONS),
            TPU_FUSED_LARGE_WINDOWS=int(cfg.TPU_FUSED_LARGE_WINDOWS),
            USE_IMAGES=bool(cfg.USE_IMAGES),
            USE_IMAGES_GT=bool(cfg.USE_IMAGES_GT),
            ONLY_IMAGES=bool(cfg.ONLY_IMAGES),
            NUM_IMAGE_CHANNELS=int(cfg.NUM_IMAGE_CHANNELS),
            IMAGE_SHAPE=_ints(cfg.IMAGE_SHAPE),
            DEPTH_SHAPE=_ints(cfg.DEPTH_SHAPE),
            INTRINSIC=tuple(_floats(row) for row in cfg.INTRINSIC),
            VOXEL_SIZE=float(cfg.VOXEL_SIZE),
            PROJ_DEPTH_MIN=float(cfg.PROJ_DEPTH_MIN),
            PROJ_DEPTH_MAX=float(cfg.PROJ_DEPTH_MAX),
            COLOR_MEAN=_floats(cfg.COLOR_MEAN),
            COLOR_STD=_floats(cfg.COLOR_STD),
            NUM_2D_CLASSES=int(cfg.NUM_2D_CLASSES),
            TPU_MAX_TILE_VIEWS=int(cfg.TPU_MAX_TILE_VIEWS),
            TPU_SCENE_COLOR_RESIDENT=str(cfg.TPU_SCENE_COLOR_RESIDENT).lower(),
            TPU_COLOR_VOLUME_MAX_MB=int(cfg.TPU_COLOR_VOLUME_MAX_MB),
        )

    def replace(self, **changes) -> "DetectorConfig":
        return dataclasses.replace(self, **changes)


def scannet_chunk_config() -> DetectorConfig:
    """ScanNet geometry-only chunk detection: the values of
    ``__graft_entry__._scannet_cfg()`` that the detector reads, without the
    mask head, which chunk detection never runs (so the geometry-only
    fixture ``tests/fixtures/tiling_parity_params.npz`` loads strictly)."""
    return DetectorConfig(
        NUM_CLASSES=19,
        NET="ScanNet_Backbone",
        NUM_ANCHORS_LEVEL1=3,
        NUM_ANCHORS_LEVEL2=11,
        NUM_ANCHORS_LEVEL3=0,
        ANCHORS_TYPE_LEVEL1="scannet14_3.txt",
        ANCHORS_TYPE_LEVEL2="scannet14_11.txt",
        ANCHORS_TYPE_LEVEL3="suncg",
        CLASS_POOLING_SIZE=4,
        RPN_CHANNELS=256,
        TEST=ProposalConfig(
            RPN_PRE_NMS_TOP_N=400, RPN_POST_NMS_TOP_N=200, RPN_NMS_THRESH=0.1
        ),
        TPU_COMPUTE_DTYPE="float32",
        USE_RPN=True,
        USE_CLASS=True,
    )


def scannet_scene_config() -> DetectorConfig:
    """ScanNet whole-scene inference with instance masks, as
    ``bench.py::bench_masked_scene`` configures it: the values of
    ``tools/tiling_parity_check.py::build_cfg`` on
    ``experiments/cfgs/ScanNet/benchmark.yml`` that this path reads (proposals
    256 -> 32 per tile, CLASS_THRESH 0.3), with ``USE_MASK=True``; tiles,
    mask canvases and queue capacities at their defaults; benchmark.yml's
    color keys, which the geometry-only path does not read."""
    return scannet_chunk_config().replace(
        ANCHORS_TYPE_LEVEL3="",
        TEST=ProposalConfig(RPN_PRE_NMS_TOP_N=256, RPN_POST_NMS_TOP_N=32, RPN_NMS_THRESH=0.1),
        USE_MASK=True,
        CLASS_THRESH=0.3,
        USE_IMAGES_GT=False,
        INTRINSIC=((37.01983, 0.0, 20.0, 0.0), (0.0, 38.5247, 15.5, 0.0), (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0)),
        VOXEL_SIZE=0.046875,
        COLOR_MEAN=(0.496342, 0.466664, 0.440796),
        COLOR_STD=(0.277856, 0.28623, 0.291129),
    )


def scannet_color_scene_config() -> DetectorConfig:
    """ScanNet whole-scene color inference with instance masks, as
    ``bench.py::bench_color_scene`` configures it: the values of
    ``tools/color_loop_check.py::build_cfg`` on
    ``experiments/cfgs/ScanNet/benchmark.yml`` that this path reads. Over
    ``scannet_scene_config()``: the color stream with ENet (``USE_IMAGES``),
    bfloat16, and the 60-degree pinhole of ``build_cfg`` at the 41x32 depth
    maps (``scaled_intrinsic(intrinsic_from_fov(328, 256), ...)``); the mask
    FCN stays geometry-only (``MASK_USE_IMAGES`` False)."""
    f = 27.71281292110204  # (256 / 2) / tan(30 deg) / 8
    return scannet_scene_config().replace(
        TPU_COMPUTE_DTYPE="bfloat16",
        USE_IMAGES=True,
        INTRINSIC=((f, 0.0, 20.5, 0.0), (0.0, f, 16.0, 0.0), (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0)),
    )


def scannet_train_config(color: bool = False) -> Config:
    """The training configs of ``bench.py::bench_train``: every key of
    ``default_config()`` with ``__graft_entry__._scannet_cfg()``'s values (19
    classes, 3 + 11 anchors, 256 RPN channels, pool 4^3, RPN_BATCHSIZE 64,
    CLASS_BATCH_SIZE 16, proposals 1000 -> 500 at NMS 0.5, USE_MASK with 8
    mask rois), bfloat16 and the 64x48x64 mask canvas; with ``color`` the
    color stream of the shipped configs (USE_IMAGES with the ENet, frozen:
    FIX_ENET, 5 views a chunk)."""
    c = default_config()
    c.NUM_CLASSES = 19
    c.NORMALIZE_WEIGHTS = [0.328] + [1.0] * 18
    c.LABEL_MAP = ""
    c.NET = "ScanNet_Backbone"
    c.MASK_BACKBONE = "MaskBackbone"
    c.NUM_ANCHORS_LEVEL1 = 3
    c.NUM_ANCHORS_LEVEL2 = 11
    c.NUM_ANCHORS_LEVEL3 = 0
    c.ANCHORS_TYPE_LEVEL1 = "scannet14_3.txt"
    c.ANCHORS_TYPE_LEVEL2 = "scannet14_11.txt"
    c.CLASS_POOLING_SIZE = 4
    c.USE_BACKBONE = True
    c.USE_RPN = True
    c.USE_CLASS = True
    c.USE_MASK = True
    c.USE_IMAGES = False
    c.RPN_BATCHSIZE = 64
    c.RPN_POSITIVE_OVERLAP = 0.35
    c.RPN_NEGATIVE_OVERLAP = 0.15
    c.CLASS_BATCH_SIZE = 16
    c.FG_FRACTION = 0.5
    c.FG_THRESH = 0.5
    c.BG_THRESH = 0.2
    c.BG_THRESH_LO = 0.0
    c.TRAIN.RPN_NMS_THRESH = 0.5
    c.TRAIN.RPN_PRE_NMS_TOP_N = 1000
    c.TRAIN.RPN_POST_NMS_TOP_N = 500
    c.TEST.RPN_PRE_NMS_TOP_N = 400
    c.TEST.RPN_POST_NMS_TOP_N = 200
    c.TEST.RPN_NMS_THRESH = 0.1
    c.TPU_MAX_MASK_ROIS = 8
    c.TPU_COMPUTE_DTYPE = "bfloat16"
    c.TPU_MASK_CANVAS = [64, 48, 64]
    if color:
        c.USE_IMAGES = True
        c.USE_IMAGES_GT = False
        c.NUM_IMAGES = 5
    return c


SUNCG_CFG = "experiments/cfgs/SUNCG/rpn_class_mask_5.yml"


def suncg_train_config() -> Config:
    """The shipped SUNCG training config: ``experiments/cfgs/SUNCG/rpn_class_mask_5.yml``
    over ``default_config()`` as this module reads it, finalized (26 classes
    from its label map), at ``bench.py::bench_train``'s training shape:
    bfloat16, 96x48x96 chunks, the 64x48x64 mask canvas and 8 mask rois.
    Its keys as shipped: ``SUNCG_Backbone`` with the color stream (the
    ENet, frozen: ``FIX_ENET``, 5 views a chunk), 3 + 6 SUNCG anchors, every
    head trained. Read from the repository root, as the config's own paths
    (label map, file lists) are."""
    c = finalize_config(cfg_from_file(SUNCG_CFG, default_config()))
    c.TPU_COMPUTE_DTYPE = "bfloat16"
    c.TPU_TILE_SIZE = [96, 48, 96]
    c.TPU_MASK_CANVAS = [64, 48, 64]
    c.TPU_MAX_MASK_ROIS = 8
    return c
