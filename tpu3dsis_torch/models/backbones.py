"""ScanNet and SUNCG backbones (geometry and color streams, or the color
stream alone under ``ONLY_IMAGES``), classifier MLP and mask FCN
(``tpu3dsis/models/backbones.py``).

``ScanNetBackbone`` is a mixin for the detector module, which builds these
layers on itself so that its ``state_dict`` keys are the JAX package's flat
param names (``geometry1.0.weight``, ``color.0.weight``, ...);
``SUNCGBackbone`` builds other layers under the same scheme, and
``BACKBONES`` maps the config's ``NET`` to the one to build. The detector
holds a ``MaskBackbone`` as its ``mask_backbone``
(``mask_backbone.geometry.0.weight``, ``mask_backbone.color.0.weight``,
``mask_backbone.combine.0.weight``, ...).
"""

from __future__ import annotations

import torch
from torch import nn

from tpu3dsis_torch.models.nn import Bottleneck, Conv, Linear, MaxPool, Relu

FEAT_STRIDE = (4, 4, 4)  # reference backbones.py:46
NET_CONV_CHANNELS = 128  # channels of every RPN level input
FC7_CHANNELS = 128  # classifier MLP output


def _classifier(pooling_size: int) -> nn.Sequential:
    """The classifier MLP over a flattened (128, P, P, P) pool (reference
    ``backbones.py:163-169 / 225-231``)."""
    return nn.Sequential(
        Linear(NET_CONV_CHANNELS * pooling_size**3, 256),
        Relu(),
        Linear(256, 256),
        Relu(),
        Linear(256, FC7_CHANNELS),
        Relu(),
    )


class ScanNetBackbone:
    """Reference ``backbones.py:171-231``. With ``use_images`` the geometry
    stream ends at 64 channels and a color stream over the projected 2D
    features gives the other 64; ``geometry2`` reads them concatenated,
    color first (``backbones.py:90``). With ``only_images`` as well there is
    no geometry stream, and the color stream ends at 128 channels
    (``tpu3dsis/models/backbones.py:108-148``); the config refuses
    ``ONLY_IMAGES`` without ``USE_IMAGES`` here, where the JAX package's
    level 1 would have 0 channels."""

    def build_backbone(self, pooling_size: int, use_images: bool = False, num_image_channels: int = 128,
                       only_images: bool = False) -> None:
        only_images = only_images and use_images
        geo_ch = 64 if use_images else 128
        self.geometry1 = None
        if not only_images:
            self.geometry1 = nn.Sequential(
                Conv(2, 32, 2, stride=2, bias=False),
                Relu(),
                Bottleneck(32, 32),
                Bottleneck(32, 32),
                Conv(32, geo_ch, 2, stride=2, bias=False),
                Relu(),
                Bottleneck(geo_ch, 32),
                Bottleneck(geo_ch, 32),
            )
        self.color = None
        if use_images:
            col_ch = 128 if only_images else 64
            self.color = nn.Sequential(
                Conv(num_image_channels, 64, 2, stride=2, bias=False),
                Relu(),
                Bottleneck(64, 32),
                MaxPool(3, 1, 1),
                Conv(64, col_ch, 2, stride=2, bias=False),
                Relu(),
                Bottleneck(col_ch, 32),
                MaxPool(3, 1, 1),
            )
        self.geometry2 = nn.Sequential(
            Conv(128, 128, 3, pad=1, bias=False),
            Relu(),
            Bottleneck(128, 64),
            Bottleneck(128, 64),
            MaxPool(3, 1, 1),
        )
        self.classifier = _classifier(pooling_size)

    def backbone(self, scene: torch.Tensor, imageft: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """scene (N, 2, X, Y, Z) and, with the color stream, imageft
        (N, C2d, X, Y, Z) -> level maps (N, 128, X/4, Y/4, Z/4) x 2. Without
        a geometry stream (``ONLY_IMAGES``) level 1 is the color stream's."""
        if self.geometry1 is None:
            lvl1 = self.color(imageft)
        elif self.color is not None:
            lvl1 = torch.cat([self.color(imageft), self.geometry1(scene)], dim=1)
        else:
            lvl1 = self.geometry1(scene)
        return lvl1, self.geometry2(lvl1)

    def classify(self, pool5: torch.Tensor) -> torch.Tensor:
        """pool5 (R, C, P, P, P) -> fc7 (R, 128).

        The pool is already channel-major, the order torch's
        ``pool5.view(R, -1)`` flattens and the converted weights expect, so
        unlike the JAX version no transpose comes first.
        """
        return self.classifier(pool5.reshape(pool5.shape[0], -1))


class SUNCGBackbone(ScanNetBackbone):
    """Reference ``backbones.py:118-169`` (``tpu3dsis/models/backbones.py:151-187``):
    two stride-2 convs of 64 channels and one bottleneck after each, for the
    geometry stream and, with ``use_images``, the color stream; ``geometry2``
    reads them concatenated, color first (128 channels, 64 without images),
    and ends at its bottleneck. No max-pools. With ``only_images`` and
    ``use_images`` there is no geometry stream and ``geometry2`` reads the
    color stream's 64 channels; ``only_images`` without ``use_images`` builds
    the geometry stream alone, as the JAX package does. The forward and the
    classifier are ``ScanNetBackbone``'s."""

    def build_backbone(self, pooling_size: int, use_images: bool = False, num_image_channels: int = 128,
                       only_images: bool = False) -> None:
        only_images = only_images and use_images
        self.geometry1 = None
        if not only_images:
            self.geometry1 = nn.Sequential(
                Conv(2, 64, 2, stride=2, bias=False),
                Relu(),
                Bottleneck(64, 32),
                Conv(64, 64, 2, stride=2, bias=False),
                Relu(),
                Bottleneck(64, 32),
            )
        self.color = None
        if use_images:
            self.color = nn.Sequential(
                Conv(num_image_channels, 64, 2, stride=2, bias=False),
                Relu(),
                Bottleneck(64, 32),
                Conv(64, 64, 2, stride=2, bias=False),
                Relu(),
                Bottleneck(64, 32),
            )
        self.geometry2 = nn.Sequential(
            Conv(128 if use_images and not only_images else 64, 128, 3, pad=1, bias=False),
            Relu(),
            Bottleneck(128, 64),
        )
        self.classifier = _classifier(pooling_size)


BACKBONES = {"ScanNet_Backbone": ScanNetBackbone, "SUNCG_Backbone": SUNCGBackbone}


def _mask_branch(cin: int, cout: int) -> nn.Sequential:
    """Five 3x3x3 convs of 64 channels and a 1x1x1 conv to ``cout``, no
    bias, ReLU between (a branch of ``MaskBackboneArch``)."""
    layers = [Conv(cin, 64, 3, pad=1, bias=False), Relu()]
    for _ in range(4):
        layers += [Conv(64, 64, 3, pad=1, bias=False), Relu()]
    layers.append(Conv(64, cout, 1, bias=False))
    return nn.Sequential(*layers)


class MaskBackbone(nn.Module):
    """The mask FCN, ``MaskBackboneArch`` (``backbones.py:194-292``): the
    geometry branch over the TSDF crop (``geometry``: five 3x3x3 convs of 64
    channels and a 1x1x1 conv to the classes, no bias, ReLU between) and,
    with ``use_images`` (``MASK_USE_IMAGES``), a color branch of the same
    shape over the 128-channel color crop (``color``), both ending at 64
    channels, concatenated geometry first and read by ``combine`` (a 3x3x3
    conv of 128 and a 1x1x1 conv to the classes). With ``only_images``
    (``MASK_ONLY_IMAGES``) the color branch ends at the classes and runs
    alone; the geometry and combine weights exist all the same, as in the
    JAX package.

    Lives on ``device``, the CUDA card unless the caller passes
    ``device="cpu"``; without a CUDA device the default raises. cuDNN runs the
    convs; the detector keeps the weights in ``torch.channels_last_3d``. It
    computes in ``compute_dtype``, or in its weights' dtype when that is None.
    """

    def __init__(self, num_classes: int, device: torch.device | str = "cuda",
                 compute_dtype: torch.dtype | None = None, use_images: bool = False, only_images: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.only_images = only_images and use_images
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MaskBackbone runs on a CUDA device, and none is present; pass device='cpu' for the CPU")
        self.geometry = _mask_branch(2, 64 if use_images else num_classes).to(device)
        self.color = self.combine = None
        if use_images:
            self.color = _mask_branch(128, num_classes if self.only_images else 64).to(device)
            self.combine = nn.Sequential(Conv(128, 128, 3, pad=1, bias=False), Relu(),
                                         Conv(128, num_classes, 1, bias=False)).to(device)

    def forward(self, scene: torch.Tensor, region_mask: torch.Tensor | None = None,
                training: bool = False, imageft: torch.Tensor | None = None) -> torch.Tensor:
        """scene (N, X, Y, Z, 2) crop canvas and, with the color branch,
        imageft (N, X, Y, Z, 128) -> (N, X, Y, Z, NUM_CLASSES).

        ``region_mask`` (N, X, Y, Z, 1) is applied again after every conv of
        every branch, before its ReLU (``backbones.py:278-279``), which makes
        a zero-padded canvas compute what the reference's exact-size crop
        does. The sigmoid runs only when not training. Everything runs in
        the compute dtype, as in the JAX package.
        """
        w = self.geometry[0].weight
        dt = self.compute_dtype or w.dtype
        region = None if region_mask is None else region_mask.to(w.device, dt).permute(0, 4, 1, 2, 3)

        def run(layers, x):
            for layer in layers:
                x = layer(x)
                if region is not None and isinstance(layer, Conv):
                    x = x * region
            return x

        def channels_first(t):
            return t.to(w.device, dt).permute(0, 4, 1, 2, 3)

        if self.color is not None and imageft is None:
            raise ValueError("the mask FCN's color branch (MASK_USE_IMAGES) needs the color crop (imageft)")
        if self.only_images:
            x = run(self.color, channels_first(imageft))
        else:
            x = run(self.geometry, channels_first(scene))
            if self.color is not None:
                x = run(self.combine, torch.cat([x, run(self.color, channels_first(imageft))], dim=1))
        if not training:
            x = torch.sigmoid(x)
        return x.permute(0, 2, 3, 4, 1)
