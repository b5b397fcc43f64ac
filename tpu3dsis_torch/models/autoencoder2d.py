"""2D convolutional autoencoder over frames (``tpu3dsis/models/autoencoder2d.py``;
the reference's standalone experiment ``lib/nets/autoencoder.py:19-148``).

A 3-level stride-2 conv encoder (3 -> 16 -> 32 -> 64) and a mirrored
transposed-conv decoder, trained with an L2 reconstruction objective. The
pipeline does not use it, in either package.

Images are (N, H, W, C) as in the JAX package; the convs run on their NCHW
view, which is channels-last in memory. Two of JAX's conventions are
reproduced exactly:

  - a stride-2 ``"SAME"`` conv pads a 3-wide kernel (0, 1) on an even size
    and (1, 1) on an odd one, so each encoder conv pads explicitly and runs
    with ``padding=0`` (``F.conv2d(padding=1)`` would pad (1, 1) always);
  - ``jax.lax.conv_transpose(..., (2, 2), "SAME")`` does not flip its
    kernel: it is ``F.conv_transpose2d`` of the spatially flipped kernel,
    with ``padding=0``, cropped to twice its input.

:func:`params_to_state_dict` turns the JAX package's parameters (HWIO) into
this module's ``state_dict``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_ENC = [("enc0", 3, 16), ("enc1", 16, 32), ("enc2", 32, 64)]
_DEC = [("dec0", 64, 32), ("dec1", 32, 16), ("dec2", 16, 3)]


def _same_pad(n: int) -> tuple[int, int]:
    """JAX's "SAME" padding of a stride-2, 3-wide window over n."""
    total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


class Autoencoder2d(nn.Module):
    def __init__(self, device: torch.device | str = "cuda"):
        super().__init__()
        for name, cin, cout in _ENC:
            self.add_module(name, nn.Conv2d(cin, cout, 3, stride=2, device=device))
        for name, cin, cout in _DEC:
            self.add_module(name, nn.ConvTranspose2d(cin, cout, 3, stride=2, device=device))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """The JAX package's init: weights normal / sqrt(9 cin), biases zero;
        drawn on the CPU from `generator`, so a seed gives the same weights on
        every device."""
        for name, cin, _ in _ENC + _DEC:
            m = getattr(self, name)
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / np.sqrt(cin * 9))
            m.bias.zero_()

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, ceil(H / 8), ceil(W / 8), 64)."""
        y = x.permute(0, 3, 1, 2)
        for name, _, _ in _ENC:
            m = getattr(self, name)
            (top, bottom), (left, right) = _same_pad(y.shape[2]), _same_pad(y.shape[3])
            y = torch.relu(F.conv2d(F.pad(y, (left, right, top, bottom)), m.weight, m.bias, stride=2))
        return y.permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(N, h, w, 64) -> (N, 8h, 8w, 3)."""
        y = z.permute(0, 3, 1, 2)
        for i, (name, _, _) in enumerate(_DEC):
            m = getattr(self, name)
            h, w = y.shape[2], y.shape[3]
            y = F.conv_transpose2d(y, m.weight.flip(2, 3), m.bias, stride=2)[:, :, :2 * h, :2 * w]
            if i < len(_DEC) - 1:
                y = torch.relu(y)
        return y.permute(0, 2, 3, 1)

    def reconstruction_loss(self, x: torch.Tensor) -> torch.Tensor:
        return torch.mean((self.decode(self.encode(x)) - x) ** 2)

    def train_step(self, x: torch.Tensor, lr: float = 1e-3) -> torch.Tensor:
        """One SGD step on the reconstruction loss; returns the loss (before
        the step)."""
        params = list(self.parameters())
        loss = self.reconstruction_loss(x)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * g)
        return loss.detach()


def params_to_state_dict(params: dict) -> dict:
    """The JAX package's parameters (numpy; conv weights (kh, kw, in, out))
    -> this module's ``state_dict``: (out, in, kh, kw) for the encoder's
    convs, (in, out, kh, kw) for the decoder's transposed convs."""
    out = {}
    for name, _, _ in _ENC + _DEC:
        w = np.asarray(params[name + ".weight"], np.float32)
        perm = (3, 2, 0, 1) if name.startswith("enc") else (2, 3, 0, 1)
        out[name + ".weight"] = torch.from_numpy(np.ascontiguousarray(w.transpose(perm)))
        out[name + ".bias"] = torch.from_numpy(np.asarray(params[name + ".bias"], np.float32).copy())
    return out
