"""Weights from the JAX package into the port (``tpu3dsis/train/checkpoint.py``).

The JAX param dict is flat and keyed by the torch names, so loading is the
JAX package's own numpy-only layout conversion (DHWIO -> OIDHW conv weights,
(in, out) -> (out, in) linear weights) and a strict ``load_state_dict``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpu3dsis.train.checkpoint import params_to_torch_state_dict


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
