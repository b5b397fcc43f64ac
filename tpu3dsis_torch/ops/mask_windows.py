"""Halo-window decomposition of the mask FCN over rois of any size
(``tpu3dsis/ops/mask_windows.py``).

The mask FCN (``models/backbones.py::MaskBackbone``) is local: each output
voxel depends only on inputs within 6 voxels (five 3x3x3 convs plus the
combine conv of the color variant). Run on a fixed canvas with the roi
re-masked after every conv, it is exact for a roi that fits the canvas; a
larger roi is cut, per axis, into ``ceil(b / s)`` windows of interior stride
``s = canvas - 2 * HALO``, each of which owns the output segment
``[r0 + k*s, min(r0 + (k+1)*s, r1))`` and starts ``HALO`` voxels before it
(clamped to the scene), so every owned voxel is exact.

``plan_windows`` is the fixed-capacity planner on tensors (the fused scene
path), its host constants made once per device (``device_ints``);
``windows_per_axis`` and ``plan_windows_np`` are the port's own copies
of the JAX package's numpy helpers (the host-planned path), so that nothing
here imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

HALO = 6  # receptive-field radius of the mask FCN (5 conv3 + combine)

_DEVICE_INTS = {}  # (device, values) -> their int32 tensor there (device_ints)


def windows_per_axis(scene: int, canvas: int, halo: int = HALO) -> int:
    """Static upper bound on per-axis window count for any roi in `scene`."""
    if scene <= canvas:
        return 1
    s = canvas - 2 * halo
    if s <= 0:
        raise ValueError(f"mask canvas {canvas} too small for halo {halo} windowing")
    return -(-scene // s)


def device_ints(values, device) -> torch.Tensor:
    """``values`` as an int32 tensor on ``device``, made on the first call
    for (device, values) and kept: a copy from the host costs a launch on
    every call, and cannot sit in a captured CUDA graph at all (the fused
    scene program's chain, ``infer/tiling.py``, whose eager runs before a
    capture make its constants). Made outside inference mode, so that the
    training step may take the same tensor."""
    key = (torch.device(device), tuple(int(v) for v in values))
    t = _DEVICE_INTS.get(key)
    if t is None:
        # up without a sync (a blocking copy would stall the host behind the
        # device in the middle of the fused scene program)
        with torch.inference_mode(False):
            t = torch.tensor(key[1], dtype=torch.int32).to(key[0], non_blocking=True)
        t = _DEVICE_INTS.setdefault(key, t)
    return t


def plan_windows(rois: torch.Tensor, roi_valid: torch.Tensor, scene_shape, canvas, capacity: int,
                 halo: int = HALO, allow_drop: bool = False, single_window: bool = False) -> dict:
    """(M, 6) float rois -> a capacity-C window work queue, on the rois' device.

    Returns per work item: ``starts`` (C, 3) int32 window origins (the window
    lies inside the scene); ``locals6`` (C, 6) the whole roi in window coords
    (the region mask, may exceed the window); ``own6`` (C, 6) the owned
    output segment in window coords; ``roi_idx`` (C,) int32; ``valid`` (C,)
    bool; and ``dropped``, a 0-d count of real windows the capacity left out.
    Primary (first) windows come first, so with capacity >= M no roi is
    dropped whole. ``allow_drop`` lets the capacity be below M (the dropped
    primaries are counted); ``single_window`` promises that every valid roi
    fits the canvas, so each roi gets one window and no halo planning.
    """
    m = rois.shape[0]
    if capacity < m and not allow_drop:
        raise ValueError(f"capacity {capacity} < num rois {m}")
    scene_t = tuple(int(x) for x in scene_shape)
    canvas_t = tuple(int(x) for x in canvas)
    ks = (1, 1, 1) if single_window else tuple(
        windows_per_axis(sc, ca, halo) for sc, ca in zip(scene_t, canvas_t))
    k_total = ks[0] * ks[1] * ks[2]
    capacity = min(capacity, m * k_total)

    dev = rois.device
    s_dev, c_dev = device_ints(scene_t, dev), device_ints(canvas_t, dev)
    stride = torch.clamp(c_dev - 2 * halo, min=1)

    r = torch.round(rois).to(torch.int32)  # half to even, as jnp.round
    r0 = torch.minimum(torch.clamp(r[:, :3], min=0), s_dev - 1)
    r1 = torch.minimum(torch.maximum(r[:, 3:6], r0 + 1), s_dev)
    bsz = r1 - r0
    ceil_div = -torch.div(-bsz, stride, rounding_mode="floor")
    n_ax = torch.where(bsz <= c_dev, torch.ones_like(bsz), ceil_div)  # (M, 3)

    # single-window placement: the roi lies whole inside the window
    st1 = torch.minimum(torch.clamp(r0, min=0), s_dev - c_dev)
    st1 = torch.minimum(st1, torch.clamp(r1 - c_dev, min=0))

    # window k of every roi at once, (K, M, 3), k-major as the JAX planner
    # concatenates them: k = (kx, ky, kz)
    k = torch.arange(k_total, device=dev, dtype=torch.int32)
    k3 = torch.stack([k // (ks[1] * ks[2]), (k // ks[2]) % ks[1], k % ks[2]], dim=1)[:, None]  # (K, 1, 3)
    one = (n_ax == 1)[None]
    stk = torch.minimum(torch.clamp(r0 + k3 * stride - halo, min=0), s_dev - c_dev)
    starts = torch.where(one, st1[None], stk).reshape(-1, 3)
    own_lo = torch.where(one, r0[None], r0 + k3 * stride).reshape(-1, 3)
    own_hi = torch.where(one, r1[None], torch.minimum(r0 + (k3 + 1) * stride, r1)).reshape(-1, 3)
    valid = (roi_valid[None] & (k3 < n_ax).all(dim=-1)).reshape(-1)
    primary = (k == 0)[:, None].expand(k_total, m).reshape(-1)
    roi_idx = torch.arange(m, dtype=torch.int32, device=dev).repeat(k_total)
    box0 = r0.repeat(k_total, 1)
    box1 = r1.repeat(k_total, 1)

    if k_total > 1 or capacity < m:
        # compaction: valid primaries, then valid extras, then padding
        key = (~valid).to(torch.int32) * 2 + (~primary).to(torch.int32)
        order = torch.argsort(key, stable=True)[:capacity]
    else:
        order = torch.arange(capacity, device=dev)
    starts, own_lo, own_hi = starts[order], own_lo[order], own_hi[order]
    box0, box1, roi_idx, v_sel = box0[order], box1[order], roi_idx[order], valid[order]
    return {
        "starts": starts,
        "locals6": torch.cat([box0 - starts, box1 - starts], dim=1),
        "own6": torch.cat([own_lo - starts, own_hi - starts], dim=1),
        "roi_idx": roi_idx,
        "valid": v_sel,
        "dropped": valid.sum() - v_sel.sum(),
    }


def plan_windows_np(box, scene_shape, canvas, halo: int = HALO):
    """Host planner for one box: list of (start, local_box6, own_abs6).

    start: (3,) window origin; local_box6: the full box in window coords
    (compute-time region mask); own_abs6: the owned segment in ABSOLUTE
    scene coords. Variable length — whole-scene inference pastes each
    window's owned segment into the output mask.
    """
    box = np.asarray(np.round(box), np.int64)
    r0 = np.clip(box[:3], 0, np.asarray(scene_shape) - 1)
    r1 = np.clip(box[3:6], r0 + 1, scene_shape)
    per_axis = []
    for ax in range(3):
        c, s_ext = int(canvas[ax]), int(scene_shape[ax])
        b = int(r1[ax] - r0[ax])
        if b <= c:
            st = min(max(int(r0[ax]), 0), s_ext - c)
            st = min(st, max(int(r1[ax]) - c, 0))
            per_axis.append([(st, int(r0[ax]), int(r1[ax]))])
        else:
            s = c - 2 * halo
            if s <= 0:
                raise ValueError(f"mask canvas {c} too small for halo {halo} windowing")
            n = -(-b // s)
            axis_items = []
            for k in range(n):
                st = min(max(int(r0[ax]) + k * s - halo, 0), s_ext - c)
                lo = int(r0[ax]) + k * s
                hi = min(int(r0[ax]) + (k + 1) * s, int(r1[ax]))
                axis_items.append((st, lo, hi))
            per_axis.append(axis_items)

    items = []
    for sx, lx, hx in per_axis[0]:
        for sy, ly, hy in per_axis[1]:
            for sz, lz, hz in per_axis[2]:
                start = np.array([sx, sy, sz], np.int32)
                local = np.concatenate([r0 - start, r1 - start]).astype(np.int32)
                own = np.array([lx, ly, lz, hx, hy, hz], np.int32)
                items.append((start, local, own))
    return items
