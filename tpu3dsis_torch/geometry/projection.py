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
"""

from __future__ import annotations

import torch

from tpu3dsis_torch import _build


def view_matrices(poses, world_to_grid) -> torch.Tensor:
    """(V, 4, 4) camera-to-world poses and the (4, 4) world-to-grid matrix ->
    (V, 3, 4) float32 grid-to-camera rows on the CPU: rows 0-2 of
    inv(pose) @ inv(world_to_grid), each entry summed over k = 0..3 in order.

    The one place the matrices are made, so that K3 and its plain version
    read the same floats.
    """
    c2w = torch.as_tensor(poses, dtype=torch.float32).cpu()
    w2g = torch.as_tensor(world_to_grid, dtype=torch.float32).cpu()
    w2c = torch.linalg.inv(c2w)
    g2w = torch.linalg.inv(w2g)
    m = w2c[:, :, 0, None] * g2w[0]
    for k in range(1, 4):
        m = m + w2c[:, :, k, None] * g2w[k]
    return m[:, :3].contiguous()


def _intrinsics(intrinsic) -> tuple:
    k = torch.as_tensor(intrinsic, dtype=torch.float32).cpu()
    return k[0, 0], k[1, 1], k[0, 2], k[1, 2]


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
    dev, dt = feats2d.device, feats2d.dtype
    v, h, w, c = feats2d.shape
    mats = view_matrices(poses, world_to_grid).to(dev)
    fx, fy, cx, cy = (t.to(dev) for t in _intrinsics(intrinsic))
    dmin, dmax, vs = (torch.tensor(float(s), dtype=torch.float32, device=dev)
                      for s in (depth_min, depth_max, voxel_size))
    gx, gy, gz = (torch.arange(int(n), dtype=torch.float32, device=dev) for n in volume_dims)
    coords = torch.meshgrid(gx, gy, gz, indexing="ij")
    coords = tuple(t.reshape(-1) for t in coords)
    if view_valid is None:
        view_valid = torch.ones(v, dtype=torch.bool, device=dev)
    view_valid = torch.as_tensor(view_valid, dtype=torch.bool).to(dev)
    depths = depths.to(dev, torch.float32)
    flat = feats2d.reshape(v, h * w, c)
    out = torch.full((coords[0].numel(), c), -torch.inf, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for i in range(v):
        accept, pix = _project(mats[i], depths[i], fx, fy, cx, cy, coords, dmin, dmax, vs)
        vol = torch.where(accept[:, None], flat[i][pix], zero)
        out = torch.where(view_valid[i], torch.maximum(out, vol), out)
    out = torch.where(torch.isneginf(out), zero, out)
    if zero_floor is not None:
        out = torch.where(torch.as_tensor(zero_floor, dtype=torch.bool, device=dev), torch.maximum(out, zero), out)
    return out.reshape(*(int(n) for n in volume_dims), c)


def fuse_views_cuda(feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max,
                    voxel_size, view_valid=None, zero_floor=None):
    """Kernel K3; the arguments and result of ``fuse_views_plain``.

    feats2d must be a contiguous (V, H, W, C) CUDA tensor, float32 or
    bfloat16, 16-byte aligned, with C = 32, 64 or 128 and H, W < 32768;
    depths a (V, H, W) float32 tensor on the same card. Its shared memory
    grows by 68 bytes a view. A ``zero_floor`` tensor is read on the
    host (one sync).
    """
    if not feats2d.is_cuda:
        raise ValueError("fuse_views_cuda takes CUDA tensors")
    _check_args(feats2d, depths, volume_dims, view_valid)
    if feats2d.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feats2d must be float32 or bfloat16, got {feats2d.dtype}")
    if not feats2d.is_contiguous() or feats2d.data_ptr() % 16:
        raise ValueError("feats2d must be contiguous and 16-byte aligned")
    v, h, w, c = feats2d.shape
    if c not in (32, 64, 128):
        raise ValueError(f"K3 takes C = 32, 64 or 128 channels, not {c}")
    if max(h, w) >= 2**15:
        raise ValueError(f"K3 takes depth maps under 32768 pixels a side, not {h}x{w}")
    dev = feats2d.device
    if not depths.is_cuda or depths.device != dev or depths.dtype != torch.float32 or not depths.is_contiguous():
        raise ValueError("depths must be a contiguous float32 tensor on feats2d's card")
    x, y, z = (int(n) for n in volume_dims)
    if x * y * z * c >= 2**62:
        raise ValueError("the volume is too large")
    lib = _build.load_library()
    is_bf16 = int(feats2d.dtype == torch.bfloat16)
    smem = lib.tpu3dsis_fuse_views_smem(v)
    if smem > torch.cuda.get_device_properties(dev).shared_memory_per_block_optin:
        raise ValueError(f"fuse_views_cuda: {smem} bytes of shared memory do not fit a block")
    mats = view_matrices(poses, world_to_grid).pin_memory().to(dev, non_blocking=True)  # no wait for the stream
    if view_valid is None:
        valid = torch.ones(v, dtype=torch.uint8, device=dev)
    else:
        valid = torch.as_tensor(view_valid, dtype=torch.bool).to(dev, non_blocking=True).to(torch.uint8)
    fx, fy, cx, cy = (float(t) for t in _intrinsics(intrinsic))
    out = torch.empty((x, y, z, c), dtype=feats2d.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpu3dsis_fuse_views(
            is_bf16, feats2d.data_ptr(), depths.data_ptr(), mats.data_ptr(), valid.data_ptr(), v, h, w, c, x, y, z,
            fx, fy, cx, cy, float(depth_min), float(depth_max), float(voxel_size),
            int(bool(zero_floor)) if zero_floor is not None else 0, out.data_ptr(), stream,
        )
    _build.check(err, "fuse_views_cuda")
    fuse_views_cuda.launches += 1
    return out


fuse_views_cuda.launches = 0


def fuse_views(feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max, voxel_size,
               view_valid=None, zero_floor=None):
    """Max-fuse V views into one (X, Y, Z, C) volume: K3 for CUDA features,
    the plain version for CPU features (same arguments as
    ``fuse_views_plain``)."""
    if feats2d.device.type == "cpu":
        return fuse_views_plain(feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min,
                                depth_max, voxel_size, view_valid, zero_floor)
    return fuse_views_cuda(feats2d, depths, poses, world_to_grid, intrinsic, volume_dims, depth_min, depth_max,
                           voxel_size, view_valid, zero_floor)
