"""ScanNet geometry backbone and classifier MLP (``tpu3dsis/models/backbones.py``).

Geometry-only: the color stream, ``SUNCGBackbone`` and ``MaskBackboneArch``
come with later slices. ``ScanNetBackbone`` is a mixin for the detector
module, which builds these layers on itself so that its ``state_dict`` keys
are the JAX package's flat param names (``geometry1.0.weight``, ...).
"""

from __future__ import annotations

import torch
from torch import nn

from tpu3dsis_torch.models.nn import Bottleneck, Conv, Linear, MaxPool, Relu

FEAT_STRIDE = (4, 4, 4)  # reference backbones.py:46
NET_CONV_CHANNELS = 128  # channels of every RPN level input
FC7_CHANNELS = 128  # classifier MLP output


class ScanNetBackbone:
    """Reference ``backbones.py:171-231``, geometry stream only."""

    def build_backbone(self, pooling_size: int) -> None:
        self.geometry1 = nn.Sequential(
            Conv(2, 32, 2, stride=2, bias=False),
            Relu(),
            Bottleneck(32, 32),
            Bottleneck(32, 32),
            Conv(32, 128, 2, stride=2, bias=False),
            Relu(),
            Bottleneck(128, 32),
            Bottleneck(128, 32),
        )
        self.geometry2 = nn.Sequential(
            Conv(128, 128, 3, pad=1, bias=False),
            Relu(),
            Bottleneck(128, 64),
            Bottleneck(128, 64),
            MaxPool(3, 1, 1),
        )
        self.classifier = nn.Sequential(
            Linear(NET_CONV_CHANNELS * pooling_size**3, 256),
            Relu(),
            Linear(256, 256),
            Relu(),
            Linear(256, FC7_CHANNELS),
            Relu(),
        )

    def backbone(self, scene: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """scene (N, 2, X, Y, Z) -> level maps (N, 128, X/4, Y/4, Z/4) x 2."""
        lvl1 = self.geometry1(scene)
        return lvl1, self.geometry2(lvl1)

    def classify(self, pool5: torch.Tensor) -> torch.Tensor:
        """pool5 (R, C, P, P, P) -> fc7 (R, 128).

        The pool is already channel-major, the order torch's
        ``pool5.view(R, -1)`` flattens and the converted weights expect, so
        unlike the JAX version no transpose comes first.
        """
        return self.classifier(pool5.reshape(pool5.shape[0], -1))
