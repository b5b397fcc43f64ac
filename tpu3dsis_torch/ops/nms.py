"""Greedy 3D NMS keep mask (``tpu3dsis/ops/nms.py::nms_mask``), batched.

``nms_mask`` dispatches on where the boxes lie: CUDA tensors go to kernel K2
(``csrc/nms3d.cu``), CPU tensors to ``nms_mask_plain``, a direct port of the
JAX package's oracle ``nms_mask_scan``. With ``classes`` (the class-aware
mode of the whole-scene stitch, ``tpu3dsis/ops/nms.py:101-104``) a box
suppresses only boxes of its own class, with IoU on the raw boxes.
"""

from __future__ import annotations

import math

import torch

from tpu3dsis_torch import _build
from tpu3dsis_torch.geometry.boxes import nms_overlap

_MAX_BOXES = 64 * 32  # K2's walk keeps one 64-bit word per lane of a warp


def nms_mask_plain(boxes: torch.Tensor, thresh: float, valid: torch.Tensor | None = None,
                   classes: torch.Tensor | None = None):
    """(..., N, 6) boxes sorted by descending score -> (..., N) bool keep.

    An earlier kept box suppresses a later one when IoU > thresh and, given
    (..., N) ``classes``, both have the same class; invalid boxes are never
    kept and never suppress. N sequential steps.
    """
    n = boxes.shape[-2]
    sup = nms_overlap(boxes, boxes) > thresh
    if valid is not None:
        sup = sup & valid[..., :, None] & valid[..., None, :]
    if classes is not None:
        sup = sup & (classes[..., :, None] == classes[..., None, :])
    sup = sup & torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    keep = torch.zeros(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    for j in range(n):
        keep[..., j] = ~(keep & sup[..., :, j]).any(-1)
    if valid is not None:
        keep = keep & valid
    return keep


def nms3d_cuda(boxes: torch.Tensor, thresh: float, valid: torch.Tensor | None = None,
               classes: torch.Tensor | None = None):
    """Kernel K2 on (..., N, 6) float32 CUDA boxes -> (..., N) bool keep;
    class-aware given (..., N) integer ``classes`` (taken as int32)."""
    if not boxes.is_cuda:
        raise ValueError("nms3d_cuda takes CUDA tensors")
    if boxes.dtype != torch.float32 or boxes.shape[-1] != 6:
        raise ValueError(f"boxes must be (..., N, 6) float32, got {tuple(boxes.shape)} {boxes.dtype}")
    lead, n = boxes.shape[:-2], boxes.shape[-2]
    if valid is None:
        valid = torch.ones(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    if valid.shape != boxes.shape[:-1] or valid.dtype != torch.bool or valid.device != boxes.device:
        raise ValueError("valid must be a bool tensor of boxes.shape[:-1] on the same device")
    if classes is not None and (classes.shape != boxes.shape[:-1] or classes.device != boxes.device
                                or classes.is_floating_point() or classes.dtype == torch.bool):
        raise ValueError("classes must be an integer tensor of boxes.shape[:-1] on the same device")
    lib = _build.load_library()
    if n > _MAX_BOXES or lib.tpu3dsis_nms3d_smem(n, classes is not None) > torch.cuda.get_device_properties(
            boxes.device).shared_memory_per_block_optin:
        raise ValueError(f"nms3d_cuda: N={n} boxes and their bitmask do not fit one block's shared memory")
    b = math.prod(lead)
    boxes = boxes.reshape(b, n, 6).contiguous()
    valid = valid.reshape(b, n).contiguous()
    if classes is not None:
        classes = classes.reshape(b, n).to(torch.int32).contiguous()
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b * n == 0:
        return keep.reshape(*lead, n)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpu3dsis_nms3d(
            boxes.data_ptr(), valid.data_ptr(), None if classes is None else classes.data_ptr(),
            b, n, float(thresh), keep.data_ptr(), stream,
        )
    _build.check(err, "nms3d_cuda")
    nms3d_cuda.launches += 1
    if classes is not None:
        nms3d_cuda.class_aware_launches += 1
    return keep.reshape(*lead, n)


nms3d_cuda.launches = 0  # every launch
nms3d_cuda.class_aware_launches = 0  # the launches with classes


def nms_mask(boxes: torch.Tensor, thresh: float, valid: torch.Tensor | None = None,
             classes: torch.Tensor | None = None):
    """Greedy NMS keep mask: kernel K2 for CUDA tensors, the plain version for
    CPU tensors."""
    if boxes.device.type == "cpu":
        return nms_mask_plain(boxes, thresh, valid, classes)
    return nms3d_cuda(boxes, thresh, valid, classes)
