"""ScanNet geometry backbone, classifier MLP and mask FCN (``tpu3dsis/models/backbones.py``).

Geometry-only: the color stream and ``SUNCGBackbone`` come with later
slices. ``ScanNetBackbone`` is a mixin for the detector module, which builds
these layers on itself so that its ``state_dict`` keys are the JAX package's
flat param names (``geometry1.0.weight``, ...); the detector holds a
``MaskBackbone`` as its ``mask_backbone`` (``mask_backbone.geometry.0.weight``,
...).
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


class MaskBackbone(nn.Module):
    """The mask FCN, ``MaskBackboneArch`` (``backbones.py:194-292``), geometry
    branch only: five 3x3x3 convs of 64 channels and a 1x1x1 conv to the
    classes, no bias, ReLU between.

    Lives on ``device``, the CUDA card unless the caller passes
    ``device="cpu"``; without a CUDA device the default raises. cuDNN runs the
    convs; the detector keeps the weights in ``torch.channels_last_3d``.
    """

    def __init__(self, num_classes: int, device: torch.device | str = "cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MaskBackbone runs on a CUDA device, and none is present; pass device='cpu' for the CPU")
        layers = [Conv(2, 64, 3, pad=1, bias=False), Relu()]
        for _ in range(4):
            layers += [Conv(64, 64, 3, pad=1, bias=False), Relu()]
        layers.append(Conv(64, num_classes, 1, bias=False))
        self.geometry = nn.Sequential(*layers).to(device)

    def forward(self, scene: torch.Tensor, region_mask: torch.Tensor | None = None,
                training: bool = False) -> torch.Tensor:
        """scene (N, X, Y, Z, 2) crop canvas -> (N, X, Y, Z, NUM_CLASSES).

        ``region_mask`` (N, X, Y, Z, 1) is applied again after every conv,
        before its ReLU (``backbones.py:278-279``), which makes a zero-padded
        canvas compute what the reference's exact-size crop does. The
        sigmoid runs only when not training. Everything stays in the
        weights' dtype, as the JAX package computes in its compute dtype.
        """
        w = self.geometry[0].weight
        x = scene.to(w.device, w.dtype).permute(0, 4, 1, 2, 3)
        region = None if region_mask is None else region_mask.to(w.device, w.dtype).permute(0, 4, 1, 2, 3)
        for layer in self.geometry:
            x = layer(x)
            if region is not None and isinstance(layer, Conv):
                x = x * region
        if not training:
            x = torch.sigmoid(x)
        return x.permute(0, 2, 3, 4, 1)
