"""The least bytes a kernel's call has to move: each input byte it needs
read once and each output byte written once, whatever implements it
(``chip_smoke.py``'s ``k1_bound``, ``k1b_bound`` and ``k3_bound``, frozen;
K3's bound here is its bytes alone, which bound it on every call the
benchmark makes). A call is the dict the harness records of it: shapes,
dtypes' sizes and, for the RoI pools, the rois."""

from __future__ import annotations

import numpy as np

from portbench.counts import PEAKS


def seconds(nbytes: float) -> float:
    return nbytes / PEAKS["hbm_bytes_per_s"]


def k1_bytes(call: dict) -> int:
    """K1: the level maps' voxels the rois' bins cover (a union over the
    batch), the rois and indices, the (M, C, P^3) output."""
    r = np.asarray(call["rois"], np.float32)
    lv, bi = np.asarray(call["level_idx"]), np.asarray(call["batch_idx"])
    c, itemsize, pooled = call["channels"], call["itemsize"], call["pooled"]
    covered = 0
    for level, (shape, s) in enumerate(zip(call["map_shapes"], call["scales"])):
        ext = np.asarray(shape[1:4])
        lo = np.floor(r[:, :3] * np.float32(s)).astype(np.int64)
        hi = np.ceil(r[:, 3:] * np.float32(s)).astype(np.int64)
        a = np.clip(lo, 0, ext)
        e = np.clip(lo + np.maximum(hi - lo, 1), 0, ext)
        grid = np.zeros((shape[0], *ext), bool)
        for i in np.flatnonzero((lv == level) & (bi >= 0) & (bi < shape[0])):
            grid[bi[i], a[i, 0]:e[i, 0], a[i, 1]:e[i, 1], a[i, 2]:e[i, 2]] = True
        covered += int(grid.sum())
    m = len(r)
    return covered * c * itemsize + m * (6 * 4 + 2 * 4) + m * c * pooled**3 * itemsize


def k1b_bytes(call: dict) -> int:
    """K1b: what K1 reads and writes, read (the cotangent in the output's
    place), and every level map's gradient written once."""
    grads = sum(int(np.prod(s)) for s in call["map_shapes"]) * call["itemsize"]
    return k1_bytes(call) + grads


def k3_bytes(call: dict) -> int:
    """K3: the (X, Y, Z, C) volume written once; the (V, H, W, C) features,
    the depths, the view matrices and flags read once."""
    v, h, w, c = call["feats_shape"]
    n = int(np.prod(call["volume_dims"]))
    return n * c * call["itemsize"] + v * h * w * c * call["itemsize"] + v * h * w * 4 + v * (12 * 4 + 1)
