"""CoordConv3d: a 3D convolution over its input with three normalised
coordinate channels put first (``tpu3dsis/models/coord_conv3d.py``; the
reference's ``lib/layer_utils/coord_conv3d.py`` and its random-window
variant).

The shipped nets import it but never use it (``lib/nets/backbones.py:12``).
Volumes are NCDHW as in the port's other convs, with X, Y, Z the three
spatial dims; the JAX package's are channels-last. The coordinate channels
come first (the reference cats ``(coords, grid)``, ``coord_conv3d.py:67``),
so converted CoordConv3d weights line up.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def add_coordinates_3d(x: torch.Tensor, window=None) -> torch.Tensor:
    """x: (N, C, X, Y, Z) -> (N, 3 + C, X, Y, Z), channels 0-2 the x, y, z
    coordinates, each spanning [-1, 1] over its axis (0 on an axis of one).

    window: optional ((x0, x1), (y0, y1), (z0, z1)) normalised sub-range:
    the 'random window' variant feeds a shifted coordinate frame
    (``coord_conv3d_random.py``) for crop-equivariant training.
    """
    n, _, sx, sy, sz = x.shape
    if window is None:
        window = ((-1, 1), (-1, 1), (-1, 1))

    def axis(num, lo, hi):
        if num == 1:
            return torch.zeros(1, dtype=torch.float32, device=x.device)
        return torch.linspace(lo, hi, num, dtype=torch.float32, device=x.device)

    grids = torch.meshgrid(axis(sx, *window[0]), axis(sy, *window[1]), axis(sz, *window[2]), indexing="ij")
    coords = torch.stack(grids).to(x.dtype).expand(n, 3, sx, sy, sz)
    return torch.cat([coords, x], dim=1)


def coord_conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, stride=1, padding=0,
                 window=None) -> torch.Tensor:
    """Conv over the coordinate-augmented input in x's dtype; w is
    (out, in + 3, kx, ky, kz)."""
    w = w.to(x.dtype)
    b = None if b is None else b.to(x.dtype)
    return F.conv3d(add_coordinates_3d(x, window), w, b, stride=stride, padding=padding)
