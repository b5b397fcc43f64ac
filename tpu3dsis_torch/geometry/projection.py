"""2D -> 3D back-projection and multi-view fusion (``tpu3dsis/geometry/projection.py``).

Every voxel centre of a (X, Y, Z) grid is projected into each view's depth
map; a voxel accepts a view when its rounded pixel lies in the image, the
depth there is in [depth_min, depth_max] and within voxel_size of the
voxel's camera depth (the reference's predicate, ``projection.py:90-110``),
and then takes that pixel's feature row. Views fuse by an elementwise max
(``fuse_views``, the reference's view max-pool).

``fuse_views`` dispatches on where the features lie: CUDA tensors go to
kernel K3 (``csrc/fuse_views.cu``), CPU tensors to ``fuse_views_plain``.
Both read the per-view matrices of ``view_matrices``, computed once per call
on the host in float32, and decide the predicate with the same float32
operations in the same order, so they agree bit for bit.

K3 first rules out, per brick of ``BRICK`` voxels, the views that can accept
no voxel of it; ``brick_view_candidates_plain`` is that cull's plain version
(the same corners, arithmetic and margins), for the tests and the card's
smoke run. The fused result does not depend on it: a culled view rejects
every voxel of its brick.

The gradient. When the features require a gradient (the ENet trains,
``FIX_ENET: False``), the fusion runs ``_FuseViewsBatch`` over the batch's
samples (``fuse_views_batch``; ``fuse_views`` is a batch of one): K3 per
sample forward and one launch of kernel K3b (``csrc/fuse_views_bwd.cu``)
for the batch backward on the card, on the matrices, valid flags and rank
the forward made (``batch_operands``), and on the CPU ``fuse_views_plain``
with ``fuse_views_backward_plain`` per sample, which is autograd of the
plain version. That is the JAX package's rule (its ``_onehot_row_gather``
VJP under autodiff of the view scan's max): the cotangent of a fused voxel
goes to the views whose value equals the max, split 0.5 / 0.5 at each tied
step of the scan, and only where the view accepted the voxel. It takes
float32 features and ``zero_floor=None`` (tiles fuse with ``zero_floor``
under ``no_grad`` only).
"""

from __future__ import annotations

import torch

from tpu3dsis_torch import _build


def view_matrices(poses, world_to_grid) -> torch.Tensor:
    """(..., V, 4, 4) camera-to-world poses and the (..., 4, 4) world-to-grid
    matrices -> (..., V, 3, 4) float32 grid-to-camera rows on the CPU: rows
    0-2 of inv(pose) @ inv(world_to_grid), each entry summed over k = 0..3 in
    order. A batch of samples (B, V, 4, 4) and (B, 4, 4) is one call.

    The one place the matrices are made, so that K3 and its plain version
    read the same floats.
    """
    c2w = torch.as_tensor(poses, dtype=torch.float32).cpu()
    w2g = torch.as_tensor(world_to_grid, dtype=torch.float32).cpu()
    w2c = torch.linalg.inv(c2w)
    g2w = torch.linalg.inv(w2g).unsqueeze(-3)
    m = w2c[..., 0, None] * g2w[..., 0:1, :]
    for k in range(1, 4):
        m = m + w2c[..., k, None] * g2w[..., k:k + 1, :]
    return m[..., :3, :].contiguous()


def margin_scales(mats) -> torch.Tensor:
    """(..., V, 3, 4) view matrices -> (..., V) float32 factors for K3b
    pass 1's margin on the map from camera to grid coordinates: the square
    of each 3x3's condition number (largest over smallest singular value of
    its float32 entries, taken in float64), at least 1. The margin is sized
    for a rotation times a uniform scale (condition number 1); the float
    error of the adjugate and the determinant of any other 3x3 grows with
    at most the square of its condition number, so with this factor every
    invertible pose keeps each accepting voxel in its pixel's slab box. A
    singular 3x3 gives inf, and the kernel then searches the whole grid, as
    it does for a non-finite inverse."""
    s = torch.linalg.svdvals(torch.as_tensor(mats)[..., :3].double())
    return torch.clamp((s[..., 0] / s[..., 2]) ** 2, min=1.0).float()


def _intrinsics(intrinsic) -> tuple:
    k = torch.as_tensor(intrinsic, dtype=torch.float32).cpu()
    return k[0, 0], k[1, 1], k[0, 2], k[1, 2]


def _intrinsic_floats(intrinsic) -> tuple:
    """(fx, fy, cx, cy) as the Python floats of their float32 values, for a
    kernel's arguments."""
    k = torch.as_tensor(intrinsic, dtype=torch.float32).cpu().tolist()
    return k[0][0], k[1][1], k[0][2], k[1][2]


def _project(mat, depth, fx, fy, cx, cy, coords, depth_min, depth_max, voxel_size):
    """One view: (N,) accept mask and (N,) flat pixel index (0 where the
    pixel is not in the image). The float32 operations of K3, in its order;
    a voxel whose camera depth is not positive and finite never accepts."""
    h, w = depth.shape
    x, y, z = coords
    cam = [((mat[r, 0] * x + mat[r, 1] * y) + mat[r, 2] * z) + mat[r, 3] for r in range(3)]
    zc = cam[2]
    px = torch.round(cam[0] * fx / zc + cx)  # half to even, as jnp.round and K3's rintf
    py = torch.round(cam[1] * fy / zc + cy)
    inside = (zc > 0) & torch.isfinite(zc) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    pix = (torch.where(inside, py, 0).long() * w + torch.where(inside, px, 0).long())
    d = depth.reshape(-1)[pix]
    accept = inside & (d >= depth_min) & (d <= depth_max) & (torch.abs(d - zc) <= voxel_size)
    return accept, pix


# K3's brick (X, Y, Z voxels), its camera-depth margin in metres and the
# least camera depth of the cut for its pixel-box cull (csrc/fuse_views.cu's
# kBX, kBY, kBZ, kEps, kFootprintZ)
BRICK = (8, 4, 8)
CULL_EPS = 1e-3
FOOTPRINT_Z = 0.05
# a brick's 12 edges as pairs of corners, corner i at (x, y, z) = bits (4, 2, 1) of i
_EDGES = [(i, i | bit) for bit in (1, 2, 4) for i in range(8) if not i & bit]


def brick_bounds(volume_dims, device="cpu"):
    """(n_bricks, 3) int64 first and last voxel of each brick of the
    (X, Y, Z) grid, in K3's block order (z fastest); edge bricks are
    ragged."""
    dims = [int(n) for n in volume_dims]
    idx = torch.meshgrid(*(torch.arange(-(-n // b), device=device) for n, b in zip(dims, BRICK)), indexing="ij")
    lo = torch.stack([i.reshape(-1) * b for i, b in zip(idx, BRICK)], -1)
    hi = torch.minimum(lo + torch.tensor(BRICK, device=device), torch.tensor(dims, device=device)) - 1
    return lo, hi


def brick_view_candidates_plain(depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max,
                                voxel_size, view_valid=None) -> torch.Tensor:
    """Plain version of K3's cull: (n_bricks, V) bool, True where the brick
    (in ``brick_bounds`` order) keeps the view as a candidate.

    A valid view is kept when a corner of the brick projects to a value that
    is not finite, or when some depth of its footprint lies in the band
    [max(depth_min, zlo - voxel_size - CULL_EPS), min(depth_max, zhi +
    voxel_size + CULL_EPS)], [zlo, zhi] the corners' camera depths. The
    brick is cut at zcut = max(zlo, depth_min - voxel_size - CULL_EPS), the
    nearest camera depth at which a voxel can accept; when zcut >
    FOOTPRINT_Z the footprint is the box of the rounded pixels of the cut
    brick's vertices (its corners beyond the cut and the points where its
    edges cross it) widened by 1 and clamped to the image, else the whole
    image. An invalid view is never a candidate. The float32 operations are
    the kernel's, the corners' those of the predicate (``_project``).
    """
    dev = depths.device
    v, h, w = depths.shape
    mats = view_matrices(poses, world_to_grid).to(dev)
    fx, fy, cx, cy = (t.to(dev) for t in _intrinsics(intrinsic))
    dmin, dmax, vs, eps = (torch.tensor(float(s), dtype=torch.float32, device=dev)
                           for s in (depth_min, depth_max, voxel_size, CULL_EPS))
    zfloor = (dmin - vs) - eps  # no voxel nearer than this can accept
    lo, hi = brick_bounds(volume_dims, dev)
    sel = torch.tensor([[(i >> s) & 1 for s in (2, 1, 0)] for i in range(8)], dtype=torch.bool, device=dev)
    x, y, z = torch.where(sel, hi[:, None], lo[:, None]).float().unbind(-1)  # (n_bricks, 8) corners
    valid = torch.ones(v, dtype=torch.bool) if view_valid is None else torch.as_tensor(view_valid).bool().cpu()
    cols, rows = torch.arange(w, device=dev), torch.arange(h, device=dev)
    keep = torch.zeros((lo.shape[0], v), dtype=torch.bool, device=dev)
    for i in torch.nonzero(valid).flatten().tolist():
        m = mats[i]
        cam = [((m[r, 0] * x + m[r, 1] * y) + m[r, 2] * z) + m[r, 3] for r in range(3)]
        finite = torch.isfinite(torch.stack(cam)).all(0).all(1)
        zlo, zhi = cam[2].amin(1), cam[2].amax(1)
        band_lo, band_hi = torch.maximum(dmin, (zlo - vs) - eps), torch.minimum(dmax, (zhi + vs) + eps)
        # the brick cut at zcut: its corners beyond the cut, and where its
        # edges cross it, nearer endpoint first
        zcut = torch.maximum(zlo, zfloor)[:, None]
        beyond = cam[2] >= zcut
        ends = [cam[r][:, _EDGES] for r in range(3)]  # (n_bricks, 12, 2)
        near = ends[2][..., 0] < zcut
        crosses = near != (ends[2][..., 1] < zcut)
        a = [torch.where(near, e[..., 0], e[..., 1]) for e in ends]
        b = [torch.where(near, e[..., 1], e[..., 0]) for e in ends]
        t = (zcut - a[2]) / (b[2] - a[2])
        vx = torch.cat([cam[0], a[0] + t * (b[0] - a[0])], 1)
        vy = torch.cat([cam[1], a[1] + t * (b[1] - a[1])], 1)
        vz = torch.cat([cam[2], zcut.expand_as(t)], 1)
        vertex = torch.cat([beyond, crosses], 1)
        px, py = torch.round(vx * fx / vz + cx), torch.round(vy * fy / vz + cy)
        inf = torch.tensor(torch.inf, device=dev)
        front = zcut[:, 0] > FOOTPRINT_Z
        x0 = torch.where(front, torch.clamp(torch.where(vertex, px, inf).amin(1) - 1, min=0), 0.0)
        x1 = torch.where(front, torch.clamp(torch.where(vertex, px, -inf).amax(1) + 1, max=w - 1), w - 1.0)
        y0 = torch.where(front, torch.clamp(torch.where(vertex, py, inf).amin(1) - 1, min=0), 0.0)
        y1 = torch.where(front, torch.clamp(torch.where(vertex, py, -inf).amax(1) + 1, max=h - 1), h - 1.0)
        in_box = (((rows >= y0[:, None]) & (rows <= y1[:, None]))[:, :, None]
                  & ((cols >= x0[:, None]) & (cols <= x1[:, None]))[:, None, :])
        d = depths[i].float()
        hit = (in_box & (d >= band_lo[:, None, None]) & (d <= band_hi[:, None, None])).flatten(1).any(1)
        keep[:, i] = ~finite | ((band_lo <= band_hi) & hit)
    return keep


def _check_args(feats2d, depths, volume_dims, view_valid):
    v, h, w, c = feats2d.shape
    if depths.shape != (v, h, w):
        raise ValueError(f"depths {tuple(depths.shape)} do not match feats2d {tuple(feats2d.shape)}")
    if view_valid is not None and tuple(view_valid.shape) != (v,):
        raise ValueError(f"view_valid must be ({v},), got {tuple(view_valid.shape)}")
    if len(volume_dims) != 3 or min(volume_dims) < 1:
        raise ValueError(f"volume_dims must be three positive sizes, got {volume_dims}")


def _fuse_rows_plain(feats2d, depths, mats, intr, coords, bounds, view_valid):
    """The plain fusion of the voxels at ``coords`` (three (N,) float32
    tensors): (N, C) in feats2d's dtype, -inf where no view was valid."""
    v, h, w, c = feats2d.shape
    dev, dt = feats2d.device, feats2d.dtype
    flat = feats2d.reshape(v, h * w, c)
    out = torch.full((coords[0].numel(), c), -torch.inf, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for i in range(v):
        accept, pix = _project(mats[i], depths[i], *intr, coords, *bounds)
        vol = torch.where(accept[:, None], flat[i][pix], zero)
        out = torch.where(view_valid[i], torch.maximum(out, vol), out)
    return out


def _plain_setup(feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max, voxel_size,
                 view_valid):
    """The plain versions' inputs on feats2d's device: the view matrices,
    intrinsics, predicate bounds, the grid's (N,) coordinates, float32
    depths and a (V,) bool view_valid."""
    dev = feats2d.device
    v = feats2d.shape[0]
    mats = view_matrices(poses, world_to_grid).to(dev)
    intr = tuple(t.to(dev) for t in _intrinsics(intrinsic))
    bounds = tuple(torch.tensor(float(s), dtype=torch.float32, device=dev) for s in (depth_min, depth_max, voxel_size))
    gx, gy, gz = (torch.arange(int(n), dtype=torch.float32, device=dev) for n in volume_dims)
    coords = tuple(t.reshape(-1) for t in torch.meshgrid(gx, gy, gz, indexing="ij"))
    if view_valid is None:
        view_valid = torch.ones(v, dtype=torch.bool, device=dev)
    view_valid = torch.as_tensor(view_valid, dtype=torch.bool).to(dev)
    return mats, intr, bounds, coords, depths.to(dev, torch.float32), view_valid


def fuse_views_plain(feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max,
                     voxel_size, view_valid=None, zero_floor=None):
    """Plain version of K3: a loop over views, each a projection of the whole
    grid and a gather of its accepted rows.

    feats2d (V, H, W, C) float32 or bfloat16; depths (V, H, W) float32;
    poses (V, 4, 4) camera-to-world; world_to_grid (4, 4); intrinsic (4, 4)
    at the depth maps' resolution; view_valid (V,) bool or None (all valid);
    zero_floor a bool (or bool tensor) or None. Returns (X, Y, Z, C) in
    feats2d's dtype on its device.

    Semantics of ``tpu3dsis/geometry/projection.py:452-504``: a valid view
    contributes its feature where it accepts the voxel and 0 where it does
    not; the running max starts at -inf, which becomes 0 where no view was
    valid; a NaN feature propagates through the max; with ``zero_floor`` the
    result is floored at 0. Invalid views are skipped whole.
    """
    _check_args(feats2d, depths, volume_dims, view_valid)
    mats, intr, bounds, coords, depths, view_valid = _plain_setup(
        feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max, voxel_size, view_valid)
    out = _fuse_rows_plain(feats2d, depths, mats, intr, coords, bounds, view_valid)
    zero = torch.zeros((), dtype=feats2d.dtype, device=feats2d.device)
    out = torch.where(torch.isneginf(out), zero, out)
    if zero_floor is not None:
        zf = torch.as_tensor(zero_floor, dtype=torch.bool, device=feats2d.device)
        out = torch.where(zf, torch.maximum(out, zero), out)
    return out.reshape(*(int(n) for n in volume_dims), feats2d.shape[-1])


# elements of the (voxels, C) volumes that one chunk of the plain backward
# keeps for all its views: its autograd graph holds a few such volumes, a
# few GB in float32
_PLAIN_BWD_ELEMENTS = 2**28


def fuse_views_backward_plain(grad_out, feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min,
                              depth_max, voxel_size, view_valid=None):
    """Plain version of K3b: the gradient of ``fuse_views_plain`` (with
    ``zero_floor=None``) with respect to feats2d, by autograd, for the
    cotangent grad_out (X, Y, Z, C). Returns (V, H, W, C) in feats2d's dtype.

    ``torch.maximum`` splits a tie 0.5 / 0.5 at each step of the view loop,
    as ``jnp.maximum`` does in the JAX package's scan, and the -inf -> 0
    fill passes no gradient, so this is the JAX package's gradient. The
    voxels are taken in chunks of 2^28 / (V * C), each its own autograd
    graph, so that memory stays bounded at any view count; the chunks'
    gradients are summed.
    """
    _check_args(feats2d, depths, volume_dims, view_valid)
    v, _, _, c = feats2d.shape
    if tuple(grad_out.shape) != (*(int(n) for n in volume_dims), c):
        raise ValueError(f"grad_out {tuple(grad_out.shape)} does not match the volume {volume_dims} x {c}")
    mats, intr, bounds, coords, depths, view_valid = _plain_setup(
        feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max, voxel_size, view_valid)
    feats = feats2d.detach().requires_grad_(True)
    g = grad_out.reshape(-1, c).to(feats2d.dtype)
    out = torch.zeros_like(feats2d)
    n = coords[0].numel()
    rows = max(1, _PLAIN_BWD_ELEMENTS // (max(v, 1) * c))
    with torch.enable_grad():
        for s in range(0, n, rows):
            fused = _fuse_rows_plain(feats, depths, mats, intr, tuple(t[s:s + rows] for t in coords), bounds,
                                     view_valid)
            fused = torch.where(torch.isneginf(fused), torch.zeros((), dtype=fused.dtype, device=fused.device), fused)
            (d,) = torch.autograd.grad(fused, feats, g[s:s + rows], allow_unused=True)
            if d is not None:
                out += d
    return out




def fuse_views_backward_batch_plain(grad_out, feats2d, depths, poses, world_to_grid, intrinsic, volume_dims,
                                    depth_min, depth_max, voxel_size, view_valid=None):
    """Plain version of K3b for a batch: ``fuse_views_backward_plain`` of
    each sample, stacked. grad_out (B, X, Y, Z, C), feats2d (B, V, H, W, C),
    depths (B, V, H, W), poses (B, V, 4, 4), world_to_grid (B, 4, 4),
    view_valid (B, V) or None; returns (B, V, H, W, C)."""
    return torch.stack([
        fuse_views_backward_plain(grad_out[i], feats2d[i], depths[i], poses[i], world_to_grid[i], intrinsic,
                                  volume_dims, depth_min, depth_max, voxel_size,
                                  None if view_valid is None else view_valid[i])
        for i in range(feats2d.shape[0])])


def _check_maps(name, feats2d, depths, dtypes):
    """The operand checks that K3 and K3b share, on the trailing (V, H, W,
    C) of feats2d and (V, H, W) of depths."""
    if not feats2d.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors")
    if feats2d.dtype not in dtypes:
        raise ValueError(f"{name}: feats2d must be one of {dtypes}, got {feats2d.dtype}")
    if not feats2d.is_contiguous() or feats2d.data_ptr() % 16:
        raise ValueError("feats2d must be contiguous and 16-byte aligned")
    v, h, w, c = feats2d.shape[-4:]
    if c not in (32, 64, 128):
        raise ValueError(f"{name} takes C = 32, 64 or 128 channels, not {c}")
    if max(h, w) >= 2**15:
        raise ValueError(f"{name} takes depth maps under 32768 pixels a side, not {h}x{w}")
    if (not depths.is_cuda or depths.device != feats2d.device or depths.dtype != torch.float32
            or not depths.is_contiguous()):
        raise ValueError("depths must be a contiguous float32 tensor on feats2d's card")


def _check_operand(name, t, shape, dtype, dev):
    if not torch.is_tensor(t) or tuple(t.shape) != shape or t.dtype != dtype or t.device != dev \
            or not t.is_contiguous():
        got = (tuple(t.shape), t.dtype, t.device) if torch.is_tensor(t) else type(t)
        raise ValueError(f"{name} must be a contiguous {shape} {dtype} tensor on {dev}, not {got}")


def _valid_flags(view_valid, shape, dev) -> torch.Tensor:
    """view_valid (or None: every view) as the kernels' uint8 flags on the
    card, without a wait for the stream."""
    if view_valid is None:
        return torch.ones(shape, dtype=torch.uint8, device=dev)
    valid = torch.as_tensor(view_valid).to(dev, non_blocking=True)
    return valid if valid.dtype == torch.uint8 else valid.bool().to(torch.uint8)


def _device_matrices(poses, world_to_grid, shape, dev) -> torch.Tensor:
    """``view_matrices`` copied up to the card from pinned memory, so no
    call waits for the stream."""
    mats = view_matrices(poses, world_to_grid)
    if tuple(mats.shape) != shape:
        raise ValueError(f"poses and world_to_grid give matrices {tuple(mats.shape)}, not {shape}")
    return mats.pin_memory().to(dev, non_blocking=True)


def _device_matrices_and_margins(poses, world_to_grid, shape, dev):
    """``view_matrices`` and their ``margin_scales``, made on the host and
    copied up to the card in one copy from pinned memory: (*shape) and
    (*shape[:-2]) float32 tensors there."""
    mats = view_matrices(poses, world_to_grid)
    if tuple(mats.shape) != shape:
        raise ValueError(f"poses and world_to_grid give matrices {tuple(mats.shape)}, not {shape}")
    host = torch.cat([mats.reshape(-1), margin_scales(mats).reshape(-1)]).pin_memory()
    both = host.to(dev, non_blocking=True)
    return both[:mats.numel()].view(shape), both[mats.numel():].view(shape[:-2])


def batch_operands(poses, world_to_grid, view_valid, batch, views, dev):
    """The kernels' operands of a batch of samples, made once: (B, V, 3, 4)
    float32 matrices (``view_matrices``, one host op) with K3b's (B, V)
    float32 ``margin_scales``, both copied up once from pinned memory, so no
    call waits for the stream, the (B, V) uint8 valid flags and the (B, V +
    1) int32 valid rank (the valid views before each view, their total
    last), both made on the card. Returns (mats, valid, rank, margins)."""
    mats, margins = _device_matrices_and_margins(poses, world_to_grid, (batch, views, 3, 4), dev)
    valid = _valid_flags(view_valid, (batch, views), dev)
    rank = torch.nn.functional.pad(torch.cumsum(valid, 1, dtype=torch.int32), (1, 0))
    return mats, valid, rank, margins


def fuse_views_cuda(feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max,
                    voxel_size, view_valid=None, zero_floor=None, mats=None, out=None):
    """Kernel K3; the arguments and result of ``fuse_views_plain``.

    feats2d must be a contiguous (V, H, W, C) CUDA tensor, float32 or
    bfloat16, 16-byte aligned, with C = 32, 64 or 128 and H, W < 32768;
    depths a (V, H, W) float32 tensor on the same card. Its shared memory
    grows by 68 bytes a view. A ``zero_floor`` tensor is read on the
    host (one sync). ``mats``, the (V, 3, 4) float32 matrices already on the
    card (``batch_operands``), stand in for poses and world_to_grid; ``out``,
    a contiguous (X, Y, Z, C) tensor of feats2d's dtype there, takes the
    result.
    """
    name = "fuse_views_cuda"
    _check_maps(name, feats2d, depths, (torch.float32, torch.bfloat16))
    _check_args(feats2d, depths, volume_dims, view_valid)
    v, h, w, c = feats2d.shape
    x, y, z = (int(n) for n in volume_dims)
    dev = feats2d.device
    if x * y * z * c >= 2**62:
        raise ValueError("the volume is too large")
    lib = _build.load_library()
    nbytes = lib.tpu3dsis_fuse_views_smem(v)
    if nbytes > torch.cuda.get_device_properties(dev).shared_memory_per_block_optin:
        raise ValueError(f"{name}: {nbytes} bytes of shared memory do not fit a block")
    if mats is None:
        mats = _device_matrices(poses, world_to_grid, (v, 3, 4), dev)
    _check_operand("mats", mats, (v, 3, 4), torch.float32, dev)
    valid = _valid_flags(view_valid, (v,), dev)
    if out is None:
        out = torch.empty((x, y, z, c), dtype=feats2d.dtype, device=dev)
    _check_operand("out", out, (x, y, z, c), feats2d.dtype, dev)
    fx, fy, cx, cy = _intrinsic_floats(intrinsic)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpu3dsis_fuse_views(
            int(feats2d.dtype == torch.bfloat16), feats2d.data_ptr(), depths.data_ptr(), mats.data_ptr(),
            valid.data_ptr(), v, h, w, c, x, y, z, fx, fy, cx, cy, float(depth_min), float(depth_max),
            float(voxel_size), int(bool(zero_floor)) if zero_floor is not None else 0, out.data_ptr(), stream,
        )
    _build.check(err, name)
    fuse_views_cuda.launches += 1
    return out


fuse_views_cuda.launches = 0


def fuse_views_backward_cuda(grad_out, feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min,
                             depth_max, voxel_size, view_valid=None, mats=None, rank=None, margins=None):
    """Kernel K3b for a batch of samples, one launch (two kernels); the
    arguments and result of ``fuse_views_backward_batch_plain``.

    feats2d and grad_out must be contiguous float32 CUDA tensors on one
    card, 16-byte aligned: (B, V, H, W, C) with C = 32, 64 or 128 and H, W <
    32768, and (B, X, Y, Z, C); depths a (B, V, H, W) float32 tensor there.
    ``mats`` (B, V, 3, 4) float32, ``margins`` (B, V) float32 and ``rank``
    (B, V + 1) int32, made on the card by ``batch_operands`` (the
    forward's), stand in for poses and world_to_grid and the rank; with
    them, and view_valid a (B, V) uint8 tensor on the card, the call does no
    host work but its checks and allocations, and does not wait for the
    stream. ``mats`` and ``margins`` come together. The kernel zeroes the
    gradient and adds each share with a float32 atomic, so a pixel's sum is
    taken in an order that can change from call to call. Its work list and
    bitmap take 4 bytes and a bit a voxel of the batch.
    """
    name = "fuse_views_backward_cuda"
    _check_maps(name, feats2d, depths, (torch.float32,))
    if feats2d.dim() != 5:
        raise ValueError(f"{name} takes (B, V, H, W, C) features, not {tuple(feats2d.shape)}")
    b, v, h, w, c = feats2d.shape
    x, y, z = (int(n) for n in volume_dims)
    if tuple(depths.shape) != (b, v, h, w) or min(x, y, z) < 1:
        raise ValueError(f"depths {tuple(depths.shape)} or the volume {volume_dims} do not match feats2d "
                         f"{tuple(feats2d.shape)}")
    dev = feats2d.device
    if (not grad_out.is_cuda or grad_out.device != dev or grad_out.dtype != torch.float32
            or not grad_out.is_contiguous() or grad_out.data_ptr() % 16 or tuple(grad_out.shape) != (b, x, y, z, c)):
        raise ValueError(f"grad_out must be a contiguous, 16-byte aligned ({b}, {x}, {y}, {z}, {c}) float32 tensor "
                         f"on feats2d's card, not {tuple(grad_out.shape)} {grad_out.dtype}")
    voxels = b * x * y * z
    if voxels >= 2**31 or b * v * h * w >= 2**31:
        raise ValueError(f"{name} takes under 2^31 voxels and pixels in a batch")
    props = torch.cuda.get_device_properties(dev)
    if voxels * 4 + voxels // 8 > props.total_memory // 4:
        raise ValueError(f"{name}: the work list of {voxels} voxels passes a quarter of the card's memory")
    lib = _build.load_library()
    nbytes = lib.tpu3dsis_fuse_views_bwd_smem(v, c)
    if nbytes > props.shared_memory_per_block_optin:
        raise ValueError(f"{name}: {nbytes} bytes of shared memory do not fit a block")
    valid = _valid_flags(view_valid, (b, v), dev)
    if (mats is None) != (margins is None):
        raise ValueError(f"{name}: pass mats and margins together (batch_operands makes both)")
    if mats is None:
        mats, margins = _device_matrices_and_margins(poses, world_to_grid, (b, v, 3, 4), dev)
    if rank is None:
        rank = torch.nn.functional.pad(torch.cumsum(valid, 1, dtype=torch.int32), (1, 0))
    _check_operand("mats", mats, (b, v, 3, 4), torch.float32, dev)
    _check_operand("margins", margins, (b, v), torch.float32, dev)
    _check_operand("view_valid", valid, (b, v), torch.uint8, dev)
    _check_operand("rank", rank, (b, v + 1), torch.int32, dev)
    out = torch.empty_like(feats2d)
    work = torch.empty(voxels, dtype=torch.int32, device=dev)
    scratch = torch.empty(1 + (voxels + 31) // 32, dtype=torch.int32, device=dev)  # its length, a bit a voxel
    fx, fy, cx, cy = _intrinsic_floats(intrinsic)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpu3dsis_fuse_views_bwd(
            b, grad_out.data_ptr(), feats2d.data_ptr(), depths.data_ptr(), mats.data_ptr(), margins.data_ptr(),
            valid.data_ptr(), rank.data_ptr(), v, h, w, c, x, y, z, fx, fy, cx, cy, float(depth_min), float(depth_max),
            float(voxel_size), work.data_ptr(), scratch.data_ptr(), out.data_ptr(), stream,
        )
    _build.check(err, name)
    fuse_views_backward_cuda.launches += 1
    return out


fuse_views_backward_cuda.launches = 0


class _FuseViewsBatch(torch.autograd.Function):
    """The view fusion of a batch of samples with its gradient: K3 per sample
    and one K3b for the batch on the card, the plain pair per sample on the
    CPU. The forward makes the batch's matrices, K3b's margin scales, valid
    flags and rank once and keeps them for the backward. No gradient reaches the depths or
    views."""

    @staticmethod
    def forward(ctx, feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max, voxel_size,
                view_valid):
        ctx.args = (depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max, voxel_size)
        ctx.save_for_backward(feats2d)
        ctx.view_valid, ctx.mats, ctx.rank, ctx.margins = view_valid, None, None, None
        if not feats2d.is_cuda:
            return _fuse_batch_plain(feats2d, *ctx.args, view_valid)
        ctx.mats, ctx.view_valid, ctx.rank, ctx.margins = batch_operands(poses, world_to_grid, view_valid,
                                                                         *feats2d.shape[:2], feats2d.device)
        return _fuse_batch_cuda(feats2d, *ctx.args, ctx.view_valid, ctx.mats)

    @staticmethod
    def backward(ctx, grad):
        (feats2d,) = ctx.saved_tensors
        if feats2d.is_cuda:
            d = fuse_views_backward_cuda(grad.contiguous(), feats2d, *ctx.args, view_valid=ctx.view_valid,
                                         mats=ctx.mats, rank=ctx.rank, margins=ctx.margins)
        else:
            d = fuse_views_backward_batch_plain(grad, feats2d, *ctx.args, view_valid=ctx.view_valid)
        return (d,) + (None,) * 9


def _fuse_batch_plain(feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max,
                      voxel_size, view_valid):
    return torch.stack([
        fuse_views_plain(feats2d[i], depths[i], poses[i], world_to_grid[i], intrinsic, volume_dims, depth_min,
                         depth_max, voxel_size, None if view_valid is None else view_valid[i])
        for i in range(feats2d.shape[0])])


def _fuse_batch_cuda(feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max, voxel_size,
                     valid, mats):
    """K3 per sample on the batch's matrices and flags, each into its slice
    of one (B, X, Y, Z, C) result."""
    out = torch.empty((feats2d.shape[0], *(int(n) for n in volume_dims), feats2d.shape[-1]), dtype=feats2d.dtype,
                      device=feats2d.device)
    for i in range(feats2d.shape[0]):
        fuse_views_cuda(feats2d[i], depths[i], poses[i], world_to_grid[i], intrinsic, volume_dims, depth_min,
                        depth_max, voxel_size, view_valid=valid[i], mats=mats[i], out=out[i])
    return out


def fuse_views_batch(feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max,
                     voxel_size, view_valid=None):
    """Max-fuse each sample's V views into its own volume: feats2d (B, V, H,
    W, C), depths (B, V, H, W), poses (B, V, 4, 4), world_to_grid (B, 4, 4),
    view_valid (B, V) or None -> (B, X, Y, Z, C) in feats2d's dtype.

    On the card the batch's matrices are made in one host op and K3 runs per
    sample on them; on the CPU the plain version runs per sample. Where
    autograd would differentiate the features (float32 only), the gradient
    is one K3b launch for the batch on the forward's operands
    (``_FuseViewsBatch``), on the CPU the plain backward per sample."""
    dims = tuple(int(n) for n in volume_dims)
    if torch.is_grad_enabled() and feats2d.requires_grad:
        if feats2d.dtype != torch.float32:
            raise ValueError(f"the view fusion's gradient (K3b) takes float32 features, not {feats2d.dtype}: "
                             "fuse before casting to the compute dtype")
        return _FuseViewsBatch.apply(feats2d, depths, poses, world_to_grid, intrinsic, dims, depth_min, depth_max,
                                     voxel_size, view_valid)
    if feats2d.device.type == "cpu":
        return _fuse_batch_plain(feats2d, depths, poses, world_to_grid, intrinsic, dims, depth_min, depth_max,
                                 voxel_size, view_valid)
    mats, valid, _, _ = batch_operands(poses, world_to_grid, view_valid, *feats2d.shape[:2], feats2d.device)
    return _fuse_batch_cuda(feats2d, depths, poses, world_to_grid, intrinsic, dims, depth_min, depth_max, voxel_size,
                            valid, mats)


def fuse_views(feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max, voxel_size,
               view_valid=None, zero_floor=None):
    """Max-fuse V views into one (X, Y, Z, C) volume: K3 for CUDA features,
    the plain version for CPU features (same arguments as
    ``fuse_views_plain``). Where autograd would differentiate the features,
    the fusion has a gradient: ``fuse_views_batch`` on a batch of one (K3b
    on the card); it takes float32 features and no ``zero_floor``."""
    if torch.is_grad_enabled() and feats2d.requires_grad:
        if zero_floor is not None:
            raise ValueError("the view fusion's gradient takes zero_floor=None: fuse a tile's views under no_grad")
        return fuse_views_batch(feats2d[None], depths[None], torch.as_tensor(poses)[None],
                                torch.as_tensor(world_to_grid)[None], intrinsic, volume_dims, depth_min, depth_max,
                                voxel_size, None if view_valid is None else torch.as_tensor(view_valid)[None])[0]
    if feats2d.device.type == "cpu":
        return fuse_views_plain(feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min,
                                depth_max, voxel_size, view_valid, zero_floor)
    return fuse_views_cuda(feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max,
                           voxel_size, view_valid, zero_floor)
