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
    bfloat16, 16-byte aligned, with C = 32, 64 or 128; depths a (V, H, W)
    float32 tensor on the same card. A ``zero_floor`` tensor is read on the
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
    dev = feats2d.device
    if not depths.is_cuda or depths.device != dev or depths.dtype != torch.float32 or not depths.is_contiguous():
        raise ValueError("depths must be a contiguous float32 tensor on feats2d's card")
    x, y, z = (int(n) for n in volume_dims)
    if x * y * z * c >= 2**62:
        raise ValueError("the volume is too large")
    lib = _build.load_library()
    is_bf16 = int(feats2d.dtype == torch.bfloat16)
    smem = lib.tpu3dsis_fuse_views_smem(is_bf16, c)
    if smem > torch.cuda.get_device_properties(dev).shared_memory_per_block_optin:
        raise ValueError(f"fuse_views_cuda: {smem} bytes of shared memory do not fit a block")
    mats = view_matrices(poses, world_to_grid).to(dev, non_blocking=True)
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
