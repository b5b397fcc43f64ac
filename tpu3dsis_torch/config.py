"""The settings the detector and the whole-scene path read, as a frozen dataclass.

The JAX package's ``tpu3dsis.config`` parses YAML and holds every key of
every flow; this module holds only the keys the port's detection and scene
paths read, under the same names, and imports no YAML. The scene keys
default to the JAX package's defaults (``tpu3dsis/config/config.py``).
``DetectorConfig.from_cfg`` reads them from a ``tpu3dsis`` ``Config`` (or
anything with the same attributes).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _ints(values) -> tuple:
    return tuple(int(v) for v in values)


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

    def __post_init__(self):
        if self.MASK_USE_IMAGES:
            raise NotImplementedError("the port has no color stream yet (MASK_USE_IMAGES)")

    @classmethod
    def from_cfg(cls, cfg) -> "DetectorConfig":
        """Read the detector's and the scene path's keys from a ``tpu3dsis`` ``Config``."""
        if getattr(cfg, "USE_IMAGES", False):
            raise NotImplementedError("the port has no color stream yet")
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
    mask canvases and queue capacities at their defaults."""
    return scannet_chunk_config().replace(
        ANCHORS_TYPE_LEVEL3="",
        TEST=ProposalConfig(RPN_PRE_NMS_TOP_N=256, RPN_POST_NMS_TOP_N=32, RPN_NMS_THRESH=0.1),
        USE_MASK=True,
        CLASS_THRESH=0.3,
    )
