"""3D RoI max-pool, forward (``tpu3dsis/ops/roi_pool3d.py``,
``tpu3dsis/ops/roi_pool3d_pallas.py``).

``roi_pool3d`` dispatches on where the features lie: CUDA tensors go to
kernel K1 (``csrc/roi_pool3d.cu``), CPU tensors to ``roi_pool3d_plain``.
Both take every level stacked, ``(Lv, B, W, H, L, C)`` channels-last, and a
batch and a level index per roi, so a batch of chunks is one launch and each
roi is pooled on its own level only (the JAX version pools every roi on every
level, then selects: the output is the same). The output is channel-major,
``(M, C, P, P, P)``, which the classifier flattens as it is.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tpu3dsis_torch import _build


def _bin_bounds(lo: torch.Tensor, hi: torch.Tensor, pooled: int, extent: int):
    """(M,) int corners -> (M, P) clamped bin [start, end), in float32 as in
    ``roi_pool3d.py:_axis_bins`` and the Pallas ``_bin_bounds``."""
    size = torch.clamp(hi - lo, min=1)
    bin_size = size.to(torch.float32)[:, None] / pooled
    p = torch.arange(pooled, dtype=torch.float32, device=lo.device)
    start = torch.floor(p * bin_size).to(torch.int32) + lo[:, None]
    end = torch.ceil((p + 1) * bin_size).to(torch.int32) + lo[:, None]
    return start.clamp(0, extent), end.clamp(0, extent)


def roi_pool3d_plain(feats, rois, batch_idx, level_idx, scales: Sequence[float], pooled: int):
    """Plain version of K1: a loop over rois and bins, each bin one ``amax``.

    feats (Lv, B, W, H, L, C); rois (M, 6) float32 scene coords; batch_idx,
    level_idx (M,) int (level 0-based); scales[lv] = 1 / stride of level lv.
    Returns (M, C, P, P, P) in feats' dtype; an empty bin gives 0.
    """
    _, _, w, h, l, c = feats.shape
    m = rois.shape[0]
    level = level_idx.long().cpu()
    scale = torch.tensor(list(scales), dtype=torch.float32)[level][:, None]
    level, batch = level.tolist(), batch_idx.long().tolist()
    r = rois.detach().to("cpu", torch.float32)
    lo = torch.floor(r[:, :3] * scale).to(torch.int32)
    hi = torch.ceil(r[:, 3:] * scale).to(torch.int32)
    bx, by, bz = (
        [t.tolist() for t in _bin_bounds(lo[:, d], hi[:, d], pooled, e)]
        for d, e in enumerate((w, h, l))
    )
    zero = feats.new_zeros(c)
    out = feats.new_empty((m, c, pooled, pooled, pooled))
    for i in range(m):
        f = feats[level[i], batch[i]]
        (sx, ex), (sy, ey), (sz, ez) = (
            (b[0][i], b[1][i]) for b in (bx, by, bz)
        )
        cells = []
        for px in range(pooled):
            for py in range(pooled):
                for pz in range(pooled):
                    if ex[px] > sx[px] and ey[py] > sy[py] and ez[pz] > sz[pz]:
                        box = f[sx[px]:ex[px], sy[py]:ey[py], sz[pz]:ez[pz]]
                        cells.append(box.amax(dim=(0, 1, 2)))
                    else:
                        cells.append(zero)
        out[i] = torch.stack(cells, dim=-1).reshape(c, pooled, pooled, pooled)
    return out


def roi_pool3d_cuda(feats, rois, batch_idx, level_idx, scales: Sequence[float], pooled: int):
    """Kernel K1; same arguments and result as ``roi_pool3d_plain``."""
    if not feats.is_cuda:
        raise ValueError("roi_pool3d_cuda takes CUDA tensors")
    if feats.dim() != 6 or not feats.is_contiguous():
        raise ValueError("feats must be a contiguous (Lv, B, W, H, L, C) tensor")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feats must be float32 or bfloat16, got {feats.dtype}")
    lv, b, w, h, l, c = feats.shape
    m = rois.shape[0]
    if not 1 <= lv <= 3 or len(scales) != lv:
        raise ValueError("roi_pool3d_cuda takes 1 to 3 levels, one scale each")
    if rois.shape != (m, 6) or rois.dtype != torch.float32 or not rois.is_contiguous():
        raise ValueError("rois must be a contiguous (M, 6) float32 tensor")
    for name, t in (("batch_idx", batch_idx), ("level_idx", level_idx)):
        if t.shape != (m,) or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (M,) int32 tensor")
    for t in (rois, batch_idx, level_idx):
        if t.device != feats.device:
            raise ValueError("all tensors must be on the features' device")
    if m * pooled**3 >= 2**31:
        raise ValueError("too many rois for one launch")
    s = [float(x) for x in scales] + [0.0] * (3 - lv)
    out = torch.empty((m, c, pooled, pooled, pooled), dtype=feats.dtype, device=feats.device)
    lib = _build.load_library()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpu3dsis_roi_pool3d(
            feats.data_ptr(), int(feats.dtype == torch.bfloat16), lv, b, w, h, l, c,
            rois.data_ptr(), batch_idx.data_ptr(), level_idx.data_ptr(), m,
            s[0], s[1], s[2], pooled, out.data_ptr(), stream,
        )
    _build.check(err, "roi_pool3d_cuda")
    roi_pool3d_cuda.launches += 1
    return out


roi_pool3d_cuda.launches = 0


def roi_pool3d(feats, rois, batch_idx, level_idx, scales: Sequence[float], pooled: int):
    """K1 for CUDA tensors, the plain version for CPU tensors."""
    if feats.device.type == "cpu":
        return roi_pool3d_plain(feats, rois, batch_idx, level_idx, scales, pooled)
    return roi_pool3d_cuda(feats, rois, batch_idx, level_idx, scales, pooled)


def roi_pool3d_multilevel(feats: Sequence[torch.Tensor], rois, level_inds, pooled: int,
                          spatial_scales: Sequence[float]):
    """Multi-level pool for a batch (reference ``network.py:503-534``).

    feats: one (B, W, H, L, C) map per level, level 1 first; rois (B, R, 6);
    level_inds (B, R), 1-based, any dtype (the proposal layer gives floats).
    Returns (B, R, C, P, P, P). Stacking the levels is one copy of the maps.
    """
    stacked = torch.stack(list(feats))
    b, r = rois.shape[:2]
    batch_idx = torch.arange(b, dtype=torch.int32, device=rois.device).repeat_interleave(r)
    level_idx = level_inds.reshape(-1).to(torch.int32) - 1
    out = roi_pool3d(
        stacked, rois.reshape(-1, 6).to(torch.float32).contiguous(),
        batch_idx, level_idx, spatial_scales, pooled,
    )
    return out.reshape(b, r, *out.shape[1:])
