"""ENet 2D encoder, the color stream's feature extractor (``tpu3dsis/models/enet2d.py``).

The reference's Torch7-converted graph (``lib/nets/enet.py:130-694``): the
initial block (3x3 stride-2 conv to 13 channels beside a 2x2 max-pool,
concatenated conv first, BatchNorm, PReLU), a 16 -> 64 downsampling
bottleneck and 4 regular ones, a 64 -> 128 downsampling bottleneck, two
sections of 8 bottlenecks (dilations 1, 2, asymmetric 5, 4, 1, 8,
asymmetric 5, 16) and a 1x1 classifier. In eval mode always, as the JAX
package runs it, training included: BatchNorm uses its running statistics
with eps 1e-3, and the converted Dropout2d's (1 - p) scaling is applied as
the checkpoint expects.

Trained (``FIX_ENET: False``) it learns what the JAX package's step learns:
that step differentiates and SGD-updates every entry of its param dict, so
the BatchNorm running statistics are ``nn.Parameter``s here (they need no
gradient until a trainer asks for one), and PReLU is computed in the JAX
package's form, whose gradient at an exact 0 differs from ``nn.PReLU``'s.

The module names reproduce the torch ``state_dict`` paths, so the params of
``tests/fixtures/color_loop_params.npz`` load under ``enet.*`` as they are
(``enet.4.0.0.3.weight``: module 4, its ConcatTable's main branch, layer 3).
The classifier (module 26) is loaded but ``features_for_3d`` never runs it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

N_MODULES = 27  # the reference's top-level Sequential
BN_EPS = 1e-3  # enet2d.py:50


def enet_blocks():
    """The JAX package's block table (``enet2d.py:75-95``): ("down", idx,
    cin, mid, cout, drop), ("reg", idx, cin, mid, drop, dilation), ("asym",
    idx, cin, mid, drop)."""
    blocks = [("down", 4, 16, 16, 64, 0.01)]
    blocks += [("reg", i, 64, 16, 0.01, 1) for i in range(5, 9)]
    blocks.append(("down", 9, 64, 32, 128, 0.1))
    for base in (10, 18):
        blocks += [
            ("reg", base + 0, 128, 32, 0.1, 1),
            ("reg", base + 1, 128, 32, 0.1, 2),
            ("asym", base + 2, 128, 32, 0.1),
            ("reg", base + 3, 128, 32, 0.1, 4),
            ("reg", base + 4, 128, 32, 0.1, 1),
            ("reg", base + 5, 128, 32, 0.1, 8),
            ("asym", base + 6, 128, 32, 0.1),
            ("reg", base + 7, 128, 32, 0.1, 16),
        ]
    return blocks


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over NCHW with the JAX package's arithmetic
    (``enet2d.py:49-51``): x * scale + (bias - mean * scale), scale =
    weight / sqrt(var + eps). The statistics are parameters under their
    ``state_dict`` names, created without ``requires_grad``: the JAX
    package trains them with the rest (``train/solver.py``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.running_mean = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.running_var = nn.Parameter(torch.ones(channels), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.running_var + BN_EPS)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


class PReLU(nn.PReLU):
    """``nn.PReLU`` with one slope a channel, over NCHW. Where autograd
    records, it computes the JAX package's max(x, 0) + a * min(x, 0)
    (``enet2d.py:55-56``), whose gradient at x == 0 is (1 + a) / 2 (each
    of the max and the min splits the tie); ``nn.PReLU``'s is a. Elsewhere
    it is the fused ``prelu``: the values are the same."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_grad_enabled() or not (x.requires_grad or self.weight.requires_grad):
            return super().forward(x)
        zero = x.new_zeros(())
        return torch.maximum(x, zero) + self.weight[:, None, None] * torch.minimum(x, zero)


class Scale(nn.Module):
    """The converted Dropout2d in eval: a multiply by (1 - p)."""

    def __init__(self, drop: float):
        super().__init__()
        self.keep = 1.0 - drop

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.keep


def _main_branch(kind: str, cin: int, mid: int, cout: int, drop: float, dilation: int) -> nn.Sequential:
    if kind == "down":
        first = nn.Conv2d(cin, mid, 2, stride=2, bias=False)
    else:
        first = nn.Conv2d(cin, mid, 1, bias=False)
    layers = [first, BatchNorm(mid), PReLU(mid)]
    if kind == "asym":
        layers += [nn.Conv2d(mid, mid, (1, 5), padding=(0, 2), bias=False),
                   nn.Conv2d(mid, mid, (5, 1), padding=(2, 0))]
    else:
        layers.append(nn.Conv2d(mid, mid, 3, padding=dilation, dilation=dilation))
    layers += [BatchNorm(mid), PReLU(mid), nn.Conv2d(mid, cout, 1, bias=False), BatchNorm(cout), Scale(drop)]
    return nn.Sequential(*layers)


class Bottleneck2d(nn.Module):
    """One ENet bottleneck: PReLU(main(x) + skip(x)). Its child ``0`` is the
    reference's ConcatTable, of which only the main branch (``0.0``) has
    params; the downsampling skip is a 2x2 max-pool padded with zero
    channels (``enet2d.py:175-178``)."""

    def __init__(self, kind: str, cin: int, mid: int, cout: int, drop: float, dilation: int = 1):
        super().__init__()
        self.add_module("0", nn.Sequential(_main_branch(kind, cin, mid, cout, drop, dilation)))
        self.add_module("2", PReLU(cout))
        self.downsample = kind == "down"
        self.pad_channels = cout - cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._modules["0"][0](x)
        skip = x
        if self.downsample:
            skip = F.pad(F.max_pool2d(x, 2), (0, 0, 0, 0, 0, self.pad_channels))
        return self._modules["2"](y + skip)


class ENet2D(nn.Module):
    """ENet under the reference's module names; ``features_for_3d`` is the
    128-channel map at 1/8 resolution that the 3D color stream reads."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.add_module("0", nn.Sequential(nn.Conv2d(3, 13, 3, stride=2, padding=1)))  # ConcatTable(conv, pool)
        self.add_module("2", BatchNorm(16))
        self.add_module("3", PReLU(16))
        self.bottlenecks = []
        for blk in enet_blocks():
            kind, idx = blk[0], blk[1]
            if kind == "down":
                m = Bottleneck2d(kind, blk[2], blk[3], blk[4], blk[5])
            elif kind == "reg":
                m = Bottleneck2d(kind, blk[2], blk[3], blk[2], blk[4], blk[5])
            else:
                m = Bottleneck2d(kind, blk[2], blk[3], blk[2], blk[4])
            self.add_module(str(idx), m)
            self.bottlenecks.append(m)
        self.add_module(str(N_MODULES - 1), nn.Sequential(nn.Conv2d(128, num_classes, 1, bias=False)))

    def features_for_3d(self, images: torch.Tensor) -> torch.Tensor:
        """(V, H, W, 3) normalised RGB -> (V, H/8, W/8, 128), modules 0-25
        (``enet2d.py:268-272``), in the weights' dtype."""
        w = self._modules["0"][0].weight
        x = images.to(w.device, w.dtype).permute(0, 3, 1, 2)
        y = torch.cat([self._modules["0"][0](x), F.max_pool2d(x, 2)], dim=1)
        y = self._modules["3"](self._modules["2"](y))
        for m in self.bottlenecks:
            y = m(y)
        return y.permute(0, 2, 3, 1)

    forward = features_for_3d

    def first_params(self) -> list:
        """The parameters of ``features_for_3d``'s first op: every later op
        reads its output, so a backward pass takes their gradients last."""
        return list(self._modules["0"].parameters())
