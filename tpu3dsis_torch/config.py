"""The settings the geometry chunk detector reads, as a frozen dataclass.

The JAX package's ``tpu3dsis.config`` parses YAML and holds every key of
every flow; this module holds only the keys the port's detection path reads,
under the same names, and imports no YAML. ``DetectorConfig.from_cfg`` reads
them from a ``tpu3dsis`` ``Config`` (or anything with the same attributes).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


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

    @classmethod
    def from_cfg(cls, cfg) -> "DetectorConfig":
        """Read the detector's keys from a ``tpu3dsis`` ``Config``."""
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
        )

    def replace(self, **changes) -> "DetectorConfig":
        return dataclasses.replace(self, **changes)


def scannet_chunk_config() -> DetectorConfig:
    """ScanNet geometry-only chunk detection: the values of
    ``__graft_entry__._scannet_cfg()`` that the detector reads."""
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
