"""Layer types of the detector (``tpu3dsis/models/nn.py``) as torch modules.

The JAX package describes its nets as lists of specs named like the torch
``state_dict`` keys; here the same specs are ``nn.Module``s, so a
``nn.Sequential`` of them has exactly those keys. Convs are NCDHW modules;
the detector runs them in ``torch.channels_last_3d``, so in memory the
volumes stay channels-last as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

Relu = nn.ReLU
Linear = nn.Linear


class Conv(nn.Conv3d):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 pad: int = 0, bias: bool = True):
        super().__init__(cin, cout, k, stride=stride, padding=pad, bias=bias)


class MaxPool(nn.MaxPool3d):
    def __init__(self, window: int = 3, stride: int = 1, pad: int = 1):
        super().__init__(window, stride, pad)


class Bottleneck(nn.Module):
    """1-3-1 residual block without BN (reference ``backbones.py:17-40``)."""

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 1)
        self.conv2 = Conv(planes, planes, 3, pad=1)
        self.conv3 = Conv(planes, inplanes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.conv1(x))
        y = torch.relu(self.conv2(y))
        return torch.relu(self.conv3(y) + x)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Torch's default Conv/Linear init (kaiming-uniform, a=sqrt(5), which
    makes weight and bias both U(+-1/sqrt(fan_in))), drawn from `generator`
    on the CPU so a seed gives the same weights on every device."""
    for m in module.modules():
        if isinstance(m, (nn.Conv3d, nn.Linear)):
            bound = m.weight[0].numel() ** -0.5
            for p in (m.weight, m.bias):
                if p is not None:
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
