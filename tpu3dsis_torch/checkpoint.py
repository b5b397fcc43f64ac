"""Weights from the JAX package into the port (``tpu3dsis/train/checkpoint.py``).

The JAX param dict is flat and keyed by the torch names, so loading is a
numpy-only layout conversion (DHWIO -> OIDHW 3D conv weights, HWIO -> OIHW
2D conv weights of the ENet, (in, out) -> (out, in) linear weights) and a
strict ``load_state_dict``; the ENet's BatchNorm running statistics load
as its parameters of those names. The conversions are the port's own
copies of the JAX package's, so the port never imports that package.

The loading half of the JAX package's checkpoints is copied too, so that
``--step`` reads what the JAX ``main.py`` reads: a released torch ``.pth``
(``load_pth``) or a native ``.npz`` snapshot (``load_snapshot``), merged
into the detector's parameters by the name-partitioned ``partial_update``.
``module_params`` gives a module's parameters under the JAX names and
layouts, which ``partial_update`` takes and ``load_jax_params`` loads back.

The snapshot half (``save_snapshot``, ``find_previous``,
``prune_snapshots``, ``snapshot_step``) writes and finds the same
``step_<N>.npz`` files as the JAX package (``param:`` and ``momentum:``
arrays in the JAX layouts, ``opt_step``), so a snapshot written by either
package loads in the other.
"""

from __future__ import annotations

import glob
import os
import re

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


def torch_state_dict_to_params(state_dict) -> dict:
    """A torch state_dict (tensors or numpy) -> the flat JAX param dict:
    OIDHW -> DHWIO 3D conv weights, (out, in) -> (in, out) linear weights;
    other arrays (2D conv weights included) keep their layout, as in the
    JAX package."""
    params = {}
    for name, value in state_dict.items():
        arr = np.asarray(value.detach().cpu().numpy() if hasattr(value, "detach") else value, dtype=np.float32)
        if name.endswith(".weight") and arr.ndim == 5:
            arr = arr.transpose(2, 3, 4, 1, 0)  # OIDHW -> DHWIO
        elif name.endswith(".weight") and arr.ndim == 2:
            arr = arr.transpose(1, 0)  # (out,in) -> (in,out)
        params[name] = arr
    return params


def module_params(module: nn.Module) -> dict:
    """A module's parameters and buffers under the JAX names and layouts,
    as float32 numpy: the inverse of ``params_to_torch_state_dict``, so
    that ``load_jax_params(module, module_params(module))`` changes
    nothing."""
    return tensors_to_params(module.state_dict())


def tensors_to_params(tensors: dict) -> dict:
    """{torch name: tensor in torch layout} (a state_dict, or momentum
    buffers keyed like one) -> the JAX names' layouts, float32 numpy."""
    out = {}
    for name, value in tensors.items():
        arr = value.detach().to("cpu", torch.float32).numpy()
        if name.endswith(".weight") and arr.ndim == 5:
            arr = arr.transpose(2, 3, 4, 1, 0)  # (out, in, kx, ky, kz) -> (kx, ky, kz, in, out)
        elif name.endswith(".weight") and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)  # (out, in, kh, kw) -> (kh, kw, in, out)
        elif name.endswith(".weight") and arr.ndim == 2:
            arr = arr.transpose(1, 0)  # (out, in) -> (in, out)
        out[name] = np.ascontiguousarray(arr)
    return out


def load_pth(path: str) -> dict:
    """A torch .pth checkpoint -> the flat JAX param dict."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return torch_state_dict_to_params(sd)


def partial_update(model_params: dict, pretrained: dict, cfg) -> dict:
    """Name-substring partitioned partial load (reference
    ``trainval.py:140-158``): backbone = "geometry" or "combine", rpn,
    classifier (without its cls and bbox heads under NYUV2_FINETUNE), and
    "color" with USE_IMAGES. As in the JAX package, "geometry" also takes
    ``mask_backbone.geometry.*``, and no partition takes ``enet.*``, so a
    checkpoint leaves the ENet at its initialisation."""
    out = dict(model_params)

    def take(pred):
        for k, v in pretrained.items():
            if pred(k) and k in out:
                if out[k].shape != v.shape:
                    raise ValueError(f"shape mismatch for {k}: {out[k].shape} vs {v.shape}")
                out[k] = v

    if cfg.LOAD_BACKBONE:
        take(lambda k: "geometry" in k or "combine" in k)
    if cfg.LOAD_RPN:
        take(lambda k: "rpn" in k)
    if cfg.LOAD_CLASS:
        if cfg.NYUV2_FINETUNE:
            take(lambda k: "classifier" in k and "classifier_cls" not in k and "classifier_bbox" not in k)
        else:
            take(lambda k: "classifier" in k)
    if cfg.USE_IMAGES:
        take(lambda k: "color" in k)
    return out


def load_snapshot(path: str):
    """A native ``.npz`` snapshot (``param:``, ``momentum:`` and
    ``opt_step`` entries) -> (params, momentum, opt_step)."""
    with np.load(path) as data:
        params = {k[len("param:"):]: data[k] for k in data.files if k.startswith("param:")}
        momentum = {k[len("momentum:"):]: data[k] for k in data.files if k.startswith("momentum:")}
        opt_step = int(data["opt_step"]) if "opt_step" in data.files else 0
    return params, momentum, opt_step


# --- native snapshots ---------------------------------------------------------


def save_snapshot(checkpoint_dir: str, step: int, params: dict, momentum: dict | None = None,
                  opt_step: int | None = None) -> str:
    """Write ``<checkpoint_dir>/step_<step>.npz``: params (and momentum) in
    the JAX layouts, as ``module_params`` and ``tensors_to_params`` give
    them, and the solver's update count ``opt_step`` (an int32, as the JAX
    package stores it)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, f"step_{step}.npz")
    arrays = {f"param:{k}": np.asarray(v) for k, v in params.items()}
    if momentum is not None:
        arrays.update({f"momentum:{k}": np.asarray(v) for k, v in momentum.items()})
        arrays["opt_step"] = np.asarray(opt_step or 0, dtype=np.int32)
    np.savez(path, **arrays)
    return path


def find_previous(checkpoint_dir: str, stepsizes=()) -> list:
    """Snapshots oldest first, without the stepsize+1 files
    (``trainval.py:194-214``)."""
    files = glob.glob(os.path.join(checkpoint_dir, "step_*.npz"))
    red = {os.path.join(checkpoint_dir, f"step_{s + 1}.npz") for s in stepsizes}
    files = [f for f in files if f not in red]
    files.sort(key=os.path.getmtime)
    return files


def prune_snapshots(checkpoint_dir: str, keep: int) -> None:
    """Delete the oldest snapshots beyond SNAPSHOT_KEPT (``trainval.py:247-258``)."""
    if keep <= 0:
        return
    files = find_previous(checkpoint_dir)
    for f in files[:-keep]:
        os.remove(f)


def snapshot_step(path: str) -> int:
    m = re.search(r"step_(\d+)\.npz$", path)
    return int(m.group(1)) if m else -1
