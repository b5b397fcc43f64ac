"""3D RoI max-pool, forward and backward (``tpu3dsis/ops/roi_pool3d.py``,
``tpu3dsis/ops/roi_pool3d_pallas.py``).

``roi_pool3d`` dispatches on where the features lie: CUDA tensors go to
kernel K1 (``csrc/roi_pool3d.cu``), CPU tensors to ``roi_pool3d_plain``.
Both take one ``(B, W, H, L, C)`` channels-last map per level, each with its
own spatial shape, and a batch and a level index per roi, so a batch of
chunks is one launch and each roi is pooled on its own level only (the JAX
version pools every roi on every level, then selects: the output is the
same). The output is channel-major, ``(M, C, P, P, P)``, which the classifier
flattens as it is. A NaN voxel in a bin gives NaN, as ``jnp.max`` does.

Where a level map needs a gradient, the pool is differentiable. On the card
``_RoIPool3d`` pairs K1 with kernel K1b (``csrc/roi_pool3d_bwd.cu``), the
gradient of the JAX package's masked, staged formulation (``_pool_one``,
whose VJP ``_roi_pool3d_prod`` uses): the max is taken over x, then over y,
then over z, and at each stage the cotangent is split evenly among the tied
maxima, so a voxel's share of a bin's cotangent g is g / n_z / n_y / n_x
over the stages where it ties. Overlapping bins and rois add up, an empty
bin passes nothing and the rois get no gradient. K1b writes each gradient
voxel once, in the maps' dtype, summing its shares in a fixed order. On the
CPU autograd runs through ``roi_pool3d_staged_plain``, the same three
masked ``amax`` stages (``torch.amax`` splits ties evenly, as JAX's max VJP
does); its forward equals ``roi_pool3d_plain`` bit for bit.
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


_NEG = -3.0e38  # the masked value of the JAX package's stages (roi_pool3d.py:28)


def roi_pool3d_staged_plain(feats: Sequence[torch.Tensor], rois, batch_idx, level_idx,
                            scales: Sequence[float], pooled: int):
    """The JAX package's ``_pool_one`` (``tpu3dsis/ops/roi_pool3d.py:51``)
    on the arguments of ``roi_pool3d_plain``: per roi, three masked ``amax``
    stages, over x, then y, then z, on the union of the roi's bins. It
    computes in float32 (a max is exact in any dtype) and returns the maps'
    dtype, so the forward equals ``roi_pool3d_plain`` and, differentiated
    by autograd, the gradient is K1b's: tie splits per stage, float32
    sums, one cast at the end.
    """
    batch, c = feats[0].shape[0], feats[0].shape[-1]
    m = rois.shape[0]
    level, bidx = level_idx.long().tolist(), batch_idx.long().tolist()
    r = rois.detach().to("cpu", torch.float32)
    dev = feats[0].device
    nan = torch.full((c, pooled, pooled, pooled), float("nan"), dtype=torch.float32, device=dev)
    zero = torch.zeros((c, pooled, pooled, pooled), dtype=torch.float32, device=dev)
    cells = [nan] * m
    for lv, (f, s) in enumerate(zip(feats, scales)):
        rows = [i for i in range(m) if level[i] == lv and 0 <= bidx[i] < batch]
        if not rows:
            continue
        f = f.float()  # one cast of the map: its gradient sums in float32 and is cast once
        s = torch.tensor(s, dtype=torch.float32)
        lo = torch.floor(r[rows, :3] * s).to(torch.int32)
        hi = torch.ceil(r[rows, 3:] * s).to(torch.int32)
        bounds = [_bin_bounds(lo[:, d], hi[:, d], pooled, e) for d, e in enumerate(f.shape[1:4])]
        for k, i in enumerate(rows):
            axes = []  # per axis: (lo, hi) of the bins' union, (P, hi - lo) masks, (P,) non-empty
            for start, end in bounds:
                st, en = start[k].to(dev), end[k].to(dev)
                a, b = int(start[k, 0]), int(end[k, -1])
                ax = torch.arange(a, max(b, a), device=dev)
                axes.append((a, b, (ax >= st[:, None]) & (ax < en[:, None]), en > st))
            if any(b <= a for a, b, _, _ in axes):
                cells[i] = zero  # every bin of the roi is empty
                continue
            (x0, x1, mx, okx), (y0, y1, my, oky), (z0, z1, mz, okz) = axes
            fb = f[bidx[i], x0:x1, y0:y1, z0:z1]
            fx = torch.where(mx[:, :, None, None, None], fb[None], _NEG).amax(dim=1)  # (P, H', L', C)
            fy = torch.where(my[None, :, :, None, None], fx[:, None], _NEG).amax(dim=2)  # (P, P, L', C)
            fz = torch.where(mz[None, None, :, :, None], fy[:, :, None], _NEG).amax(dim=3)  # (P, P, P, C)
            ok = okx[:, None, None] & oky[None, :, None] & okz[None, None, :]
            cells[i] = torch.where(ok[..., None], fz, 0.0).permute(3, 0, 1, 2)
    return torch.stack(cells).to(feats[0].dtype)


def roi_pool3d_backward_plain(feats: Sequence[torch.Tensor], rois, batch_idx, level_idx,
                              scales: Sequence[float], pooled: int, grad_out):
    """Plain version of K1b: the gradient of ``roi_pool3d_staged_plain``
    for the cotangent grad_out (M, C, P, P, P), one map per level, each
    like its level map."""
    with torch.enable_grad():
        leaves = [f.detach().requires_grad_(True) for f in feats]
        out = roi_pool3d_staged_plain(leaves, rois, batch_idx, level_idx, scales, pooled)
        grads = torch.autograd.grad(out, leaves, grad_out, allow_unused=True)
    return [torch.zeros_like(f) if g is None else g for f, g in zip(feats, grads)]


def roi_pool3d_backward_cuda(feats: Sequence[torch.Tensor], rois, batch_idx, level_idx,
                             scales: Sequence[float], pooled: int, grad_out):
    """Kernel K1b; same arguments and result as ``roi_pool3d_backward_plain``.

    The maps and the rois are K1's (``roi_pool3d_cuda`` checks them the
    same way: contiguous, 16-byte aligned, C a multiple of 16 bytes of
    channels); grad_out is a contiguous (M, C, P, P, P) tensor of the maps'
    dtype. The gradient maps come from ``torch.empty`` in the maps' dtype:
    the kernels write every element once, zeros included, and sum each
    voxel's shares in float32 in the order in which autograd sums the plain
    version's, so two calls on the same inputs give the same bits. The
    column pass writes each column's planes (the plane's max and ct / n_y)
    to an (M, P, P, L, C) scratch allocated here, L the deepest level's;
    only the planes the rois hold are touched. The scratch takes
    M * P^2 * L * C * (itemsize + 4) bytes: 37.7 MB on a training step's
    call (128 rois, P = 4, L = 24, C = 128, bf16), 1.9 GB on 6,400 such
    rois. A call whose scratch would exceed a quarter of the card's memory
    raises.
    """
    feats = list(feats)
    f0 = feats[0]
    if not f0.is_cuda:
        raise ValueError("roi_pool3d_backward_cuda takes CUDA tensors")
    if not 1 <= len(feats) <= 3 or len(scales) != len(feats):
        raise ValueError("roi_pool3d_backward_cuda takes 1 to 3 levels, one scale each")
    if f0.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feats must be float32 or bfloat16, got {f0.dtype}")
    b, c = f0.shape[0], f0.shape[-1]
    for f in feats:
        if f.dim() != 5 or (f.shape[0], f.shape[-1]) != (b, c) or f.dtype != f0.dtype or f.device != f0.device:
            raise ValueError("each level must be a (B, W, H, L, C) map of one batch, width, dtype and device")
        if not f.is_contiguous():
            raise ValueError(f"level map of strides {f.stride()} is not contiguous (B, W, H, L, C)")
        if f.data_ptr() % 16:
            raise ValueError("each level map must be 16-byte aligned")
        if f.numel() >= 2**31:
            raise ValueError("a level map is too large for K1b's 32-bit offsets")
    if c % (16 // f0.element_size()):
        raise ValueError(f"C={c} must be a multiple of 16 bytes of channels")
    if not 1 <= pooled <= 8:
        raise ValueError(f"pooled={pooled}: K1b takes P = 1 to 8")
    m = rois.shape[0]
    if rois.shape != (m, 6) or rois.dtype != torch.float32 or not rois.is_contiguous():
        raise ValueError("rois must be a contiguous (M, 6) float32 tensor")
    for name, t in (("batch_idx", batch_idx), ("level_idx", level_idx)):
        if t.shape != (m,) or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (M,) int32 tensor")
    if grad_out.shape != (m, c, pooled, pooled, pooled) or grad_out.dtype != f0.dtype or not grad_out.is_contiguous():
        raise ValueError(f"grad_out must be a contiguous (M, C, P, P, P) tensor of the maps' dtype, "
                         f"got {tuple(grad_out.shape)} {grad_out.dtype}")
    for t in (rois, batch_idx, level_idx, grad_out):
        if t.device != f0.device:
            raise ValueError("all tensors must be on the features' device")
    lib = _build.load_library()
    is_bf16 = int(f0.dtype == torch.bfloat16)
    threads = lib.tpu3dsis_roi_pool3d_bwd_threads(is_bf16, c)
    if threads > 512:
        raise ValueError(f"roi_pool3d_backward_cuda: C={c} needs {threads} threads a block, more than 512")
    smem = lib.tpu3dsis_roi_pool3d_bwd_smem(is_bf16, c)
    if smem > torch.cuda.get_device_properties(f0.device).shared_memory_per_block_optin:
        raise ValueError(f"roi_pool3d_backward_cuda: C={c} needs {smem} bytes of shared memory a block")
    if m * pooled**2 * c >= 2**31:
        raise ValueError("roi_pool3d_backward_cuda: too many rois for K1b's 32-bit column index")
    zcap = max(f.shape[3] for f in feats)
    scratch = m * pooled**2 * zcap * c * (f0.element_size() + 4)
    if scratch > torch.cuda.get_device_properties(f0.device).total_memory // 4:
        raise ValueError(f"roi_pool3d_backward_cuda: {m} rois at P={pooled} need a {scratch:,} B column scratch, "
                         "more than a quarter of the card's memory")
    grads = [torch.empty_like(f) for f in feats]
    plane_max = torch.empty((m, pooled, pooled, zcap, c), dtype=f0.dtype, device=f0.device)
    plane_grad = torch.empty((m, pooled, pooled, zcap, c), dtype=torch.float32, device=f0.device)
    n = len(feats)
    with torch.cuda.device(f0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpu3dsis_roi_pool3d_bwd(
            is_bf16, n, (ctypes.c_void_p * n)(*[f.data_ptr() for f in feats]),
            (ctypes.c_void_p * n)(*[g.data_ptr() for g in grads]),
            (ctypes.c_int * (3 * n))(*[d for f in feats for d in f.shape[1:4]]),
            (ctypes.c_float * n)(*[float(s) for s in scales]), b, c, rois.data_ptr(), batch_idx.data_ptr(),
            level_idx.data_ptr(), m, pooled, grad_out.data_ptr(), plane_max.data_ptr(), plane_grad.data_ptr(), zcap,
            stream,
        )
    _build.check(err, "roi_pool3d_backward_cuda")
    roi_pool3d_backward_cuda.launches += 1
    return grads


roi_pool3d_backward_cuda.launches = 0


class _RoIPool3d(torch.autograd.Function):
    """K1 forward, K1b backward, on CUDA tensors; the rois and indices get
    no gradient."""

    @staticmethod
    def forward(ctx, rois, batch_idx, level_idx, scales, pooled, *feats):
        ctx.save_for_backward(rois, batch_idx, level_idx, *feats)
        ctx.scales, ctx.pooled = scales, pooled
        return roi_pool3d_cuda(feats, rois, batch_idx, level_idx, scales, pooled)

    @staticmethod
    def backward(ctx, grad_out):
        rois, batch_idx, level_idx, *feats = ctx.saved_tensors
        grads = roi_pool3d_backward_cuda(feats, rois, batch_idx, level_idx, ctx.scales, ctx.pooled,
                                         grad_out.contiguous())
        return (None, None, None, None, None,
                *(g if need else None for g, need in zip(grads, ctx.needs_input_grad[5:])))


def roi_pool3d(feats: Sequence[torch.Tensor], rois, batch_idx, level_idx,
               scales: Sequence[float], pooled: int):
    """K1 for CUDA tensors, the plain version for CPU tensors; where a map
    needs a gradient, K1 with K1b as its backward on the card, the staged
    plain version on the CPU."""
    needs_grad = torch.is_grad_enabled() and any(f.requires_grad for f in feats)
    if feats[0].device.type == "cpu":
        fn = roi_pool3d_staged_plain if needs_grad else roi_pool3d_plain
        return fn(feats, rois, batch_idx, level_idx, scales, pooled)
    if needs_grad:
        return _RoIPool3d.apply(rois, batch_idx, level_idx, tuple(float(s) for s in scales), pooled, *feats)
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
