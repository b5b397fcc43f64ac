"""Weights from the JAX package into the port (``tpu3dsis/train/checkpoint.py``).

The JAX param dict is flat and keyed by the torch names, so loading is a
numpy-only layout conversion (DHWIO -> OIDHW 3D conv weights, HWIO -> OIHW
2D conv weights of the ENet, (in, out) -> (out, in) linear weights) and a
strict ``load_state_dict``; BatchNorm running statistics load as the
modules' buffers. The conversion is the port's own copy of the JAX package's
``params_to_torch_state_dict``, so the port never imports that package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def params_to_torch_state_dict(params: dict) -> dict:
    """Flat JAX param dict -> {name: float32 numpy array in torch layout}."""
    out = {}
    for name, value in params.items():
        arr = np.asarray(value, dtype=np.float32)
        if name.endswith(".weight") and arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)  # (kx, ky, kz, in, out) -> (out, in, kx, ky, kz)
        elif name.endswith(".weight") and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # (kh, kw, in, out) -> (out, in, kh, kw)
        elif name.endswith(".weight") and arr.ndim == 2:
            arr = arr.transpose(1, 0)  # (in, out) -> (out, in)
        out[name] = arr
    return out


def load_jax_params(module: nn.Module, params) -> nn.Module:
    """Load JAX params into `module` with ``strict=True``.

    params: a {name: array} dict (numpy or anything ``np.asarray`` takes) or
    the path of an ``.npz`` of them, such as
    ``tests/fixtures/tiling_parity_params.npz``. Values are cast to the
    module's dtype and device as they load.
    """
    if isinstance(params, str):
        with np.load(params) as data:
            params = {k: data[k] for k in data.files}
    state = {k: torch.tensor(v) for k, v in params_to_torch_state_dict(params).items()}
    module.load_state_dict(state, strict=True)
    return module
