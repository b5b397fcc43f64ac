"""3D RoI max-pool, forward (``tpu3dsis/ops/roi_pool3d.py``,
``tpu3dsis/ops/roi_pool3d_pallas.py``).

``roi_pool3d`` dispatches on where the features lie: CUDA tensors go to
kernel K1 (``csrc/roi_pool3d.cu``), CPU tensors to ``roi_pool3d_plain``.
Both take one ``(B, W, H, L, C)`` channels-last map per level, each with its
own spatial shape, and a batch and a level index per roi, so a batch of
chunks is one launch and each roi is pooled on its own level only (the JAX
version pools every roi on every level, then selects: the output is the
same). The output is channel-major, ``(M, C, P, P, P)``, which the classifier
flattens as it is. A NaN voxel in a bin gives NaN, as ``jnp.max`` does.
"""

from __future__ import annotations

import ctypes
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


def roi_pool3d_plain(feats: Sequence[torch.Tensor], rois, batch_idx, level_idx,
                     scales: Sequence[float], pooled: int):
    """Plain version of K1: a loop over rois and bins, each bin one ``amax``.

    feats: one (B, W, H, L, C) map per level; rois (M, 6) float32 scene
    coords; batch_idx, level_idx (M,) int (level 0-based); scales[lv] =
    1 / stride of level lv. Returns (M, C, P, P, P) in the maps' dtype; an
    empty bin gives 0, a roi with an out-of-range batch or level index NaN.
    """
    batch, c = feats[0].shape[0], feats[0].shape[-1]
    m = rois.shape[0]
    level, bidx = level_idx.long().tolist(), batch_idx.long().tolist()
    r = rois.detach().to("cpu", torch.float32)
    out = feats[0].new_full((m, c, pooled, pooled, pooled), float("nan"))
    for lv, (f, s) in enumerate(zip(feats, scales)):
        rows = [i for i in range(m) if level[i] == lv and 0 <= bidx[i] < batch]
        if not rows:
            continue
        s = torch.tensor(s, dtype=torch.float32)
        lo = torch.floor(r[rows, :3] * s).to(torch.int32)
        hi = torch.ceil(r[rows, 3:] * s).to(torch.int32)
        bx, by, bz = (
            [t.tolist() for t in _bin_bounds(lo[:, d], hi[:, d], pooled, e)]
            for d, e in enumerate(f.shape[1:4])
        )
        zero = f.new_zeros(c)
        for k, i in enumerate(rows):
            (sx, ex), (sy, ey), (sz, ez) = ((a[0][k], a[1][k]) for a in (bx, by, bz))
            fb = f[bidx[i]]
            cells = []
            for px in range(pooled):
                for py in range(pooled):
                    for pz in range(pooled):
                        if ex[px] > sx[px] and ey[py] > sy[py] and ez[pz] > sz[pz]:
                            box = fb[sx[px]:ex[px], sy[py]:ey[py], sz[pz]:ez[pz]]
                            cells.append(box.amax(dim=(0, 1, 2)))
                        else:
                            cells.append(zero)
            out[i] = torch.stack(cells, dim=-1).reshape(c, pooled, pooled, pooled)
    return out


def roi_pool3d_cuda(feats: Sequence[torch.Tensor], rois, batch_idx, level_idx,
                    scales: Sequence[float], pooled: int):
    """Kernel K1; same arguments and result as ``roi_pool3d_plain``.

    Each level map must be a contiguous (B, W, H, L, C) CUDA tensor (the
    channels-last view of a ``channels_last_3d`` volume is one), 16-byte
    aligned, with C a multiple of 16 bytes of channels; it is never copied.
    """
    feats = list(feats)
    f0 = feats[0]
    if not f0.is_cuda:
        raise ValueError("roi_pool3d_cuda takes CUDA tensors")
    if not 1 <= len(feats) <= 3 or len(scales) != len(feats):
        raise ValueError("roi_pool3d_cuda takes 1 to 3 levels, one scale each")
    if f0.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feats must be float32 or bfloat16, got {f0.dtype}")
    b, c = f0.shape[0], f0.shape[-1]
    vec = 16 // f0.element_size()
    for f in feats:
        if f.dim() != 5 or (f.shape[0], f.shape[-1]) != (b, c) or f.dtype != f0.dtype or f.device != f0.device:
            raise ValueError("each level must be a (B, W, H, L, C) map of one batch, width, dtype and device")
        if not f.is_contiguous():
            raise ValueError(f"level map of strides {f.stride()} is not contiguous (B, W, H, L, C); K1 does not copy it")
        if f.data_ptr() % 16:
            raise ValueError("each level map must be 16-byte aligned")
        if f[0].numel() >= 2**31:
            raise ValueError("a level map's sample is too large for K1's 32-bit offsets")
    lanes = c // vec
    if c % vec or not (lanes >= 32 and lanes % 32 == 0 or lanes < 32 and 32 % lanes == 0):
        raise ValueError(f"C={c} must be {vec} x (a divisor of 32 or a multiple of 32)")
    if pooled not in (2, 4, 6, 8):
        raise ValueError(f"pooled={pooled}: K1 takes P = 2, 4, 6 or 8")
    m = rois.shape[0]
    if rois.shape != (m, 6) or rois.dtype != torch.float32 or not rois.is_contiguous():
        raise ValueError("rois must be a contiguous (M, 6) float32 tensor")
    for name, t in (("batch_idx", batch_idx), ("level_idx", level_idx)):
        if t.shape != (m,) or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (M,) int32 tensor")
    for t in (rois, batch_idx, level_idx):
        if t.device != f0.device:
            raise ValueError("all tensors must be on the features' device")
    lib = _build.load_library()
    is_bf16 = int(f0.dtype == torch.bfloat16)
    smem = lib.tpu3dsis_roi_pool3d_smem(is_bf16, c, pooled)
    if smem > torch.cuda.get_device_properties(f0.device).shared_memory_per_block_optin:
        raise ValueError(f"roi_pool3d_cuda: a tile of C={c} x {pooled}^3 needs {smem} bytes of shared memory")
    n = len(feats)
    ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in feats])
    whl = (ctypes.c_int * (3 * n))(*[d for f in feats for d in f.shape[1:4]])
    sc = (ctypes.c_float * n)(*[float(s) for s in scales])
    out = torch.empty((m, c, pooled, pooled, pooled), dtype=f0.dtype, device=f0.device)
    if m == 0:
        return out
    with torch.cuda.device(f0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpu3dsis_roi_pool3d(
            is_bf16, n, ptrs, whl, sc, b, c, rois.data_ptr(), batch_idx.data_ptr(),
            level_idx.data_ptr(), m, pooled, out.data_ptr(), stream,
        )
    _build.check(err, "roi_pool3d_cuda")
    roi_pool3d_cuda.launches += 1
    return out


roi_pool3d_cuda.launches = 0


def roi_pool3d(feats: Sequence[torch.Tensor], rois, batch_idx, level_idx,
               scales: Sequence[float], pooled: int):
    """K1 for CUDA tensors, the plain version for CPU tensors."""
    if feats[0].device.type == "cpu":
        return roi_pool3d_plain(feats, rois, batch_idx, level_idx, scales, pooled)
    return roi_pool3d_cuda(feats, rois, batch_idx, level_idx, scales, pooled)


def roi_pool3d_multilevel(feats: Sequence[torch.Tensor], rois, level_inds, pooled: int,
                          spatial_scales: Sequence[float]):
    """Multi-level pool for a batch (reference ``network.py:503-534``).

    feats: one (B, W, H, L, C) map per level, level 1 first, passed to the
    pool as they are; rois (B, R, 6); level_inds (B, R), 1-based, any dtype
    (the proposal layer gives floats). Returns (B, R, C, P, P, P).
    """
    b, r = rois.shape[:2]
    batch_idx = torch.arange(b, dtype=torch.int32, device=rois.device).repeat_interleave(r)
    level_idx = level_inds.reshape(-1).to(torch.int32) - 1
    out = roi_pool3d(
        list(feats), rois.reshape(-1, 6).to(torch.float32).contiguous(),
        batch_idx, level_idx, spatial_scales, pooled,
    )
    return out.reshape(b, r, *out.shape[1:])
