"""K3's brick cull on the CPU.

``brick_view_candidates_plain`` (the plain version of the cull kernel K3
runs per brick of voxels before it projects any voxel) never culls a (brick,
view) pair in which some voxel accepts the view, by the port's predicate
(``projection._project``) and by the JAX package's ``compute_projection``;
it culls most pairs of a room; and K3's brick algorithm, emulated here (fuse
the kept views only, then floor at 0 every voxel of a brick that culled a
valid view), equals ``fuse_views_plain``. Inputs come from numpy seeds.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu3dsis.geometry.projection import compute_projection
from tpu3dsis_torch import scannet_color_scene_config
from tpu3dsis_torch.geometry import projection as P

CFG = scannet_color_scene_config()
K = np.asarray(CFG.INTRINSIC, np.float32)  # the 60-degree pinhole at 41x32
W, H = CFG.DEPTH_SHAPE
DMIN, DMAX = CFG.PROJ_DEPTH_MIN, CFG.PROJ_DEPTH_MAX
VOX = 0.1
GRID = (40, 20, 40)  # 4 x 2 x 4 m
RAGGED = (37, 21, 45)  # no side a multiple of the brick's


def _w2g(vox=VOX):
    return np.diag([1 / vox, 1 / vox, 1 / vox, 1.0]).astype(np.float32)


def _cameras(rng, v, dims, inside=True, vox=VOX):
    """Cameras standing inside the grid's world box at random yaw and pitch,
    or outside it (2 m past its -z face) looking away from it."""
    ext = np.asarray(dims) * vox
    poses = []
    for _ in range(v):
        if inside:
            eye = rng.uniform(0.15, 0.85, 3) * ext
            yaw, pitch = rng.uniform(0, 360), rng.uniform(-30, 30)
        else:
            eye = np.array([rng.uniform(0, ext[0]), rng.uniform(0, ext[1]), -2.0])
            yaw, pitch = 180.0 + rng.uniform(-20, 20), rng.uniform(-10, 10)
        poses.append(chip_smoke.camera_pose(eye, yaw, pitch))
    return np.asarray(poses, np.float32)


def _coords(dims):
    g = torch.meshgrid(*(torch.arange(n, dtype=torch.float32) for n in dims), indexing="ij")
    return tuple(t.reshape(-1) for t in g)


def _brick_ids(dims):
    """(N,) brick of each voxel, in ``brick_bounds`` order."""
    nb = [-(-n // b) for n, b in zip(dims, P.BRICK)]
    x, y, z = (c.long() // b for c, b in zip(_coords(dims), P.BRICK))
    return (x * nb[1] + y) * nb[2] + z


def _accepts(depths, poses, w2g, dims, vox):
    """(V, N) twice: the port's predicate and the JAX package's
    ``compute_projection`` for every voxel and view."""
    mats = P.view_matrices(poses, w2g)
    fx, fy, cx, cy = P._intrinsics(K)
    t = torch.tensor
    port = torch.stack([P._project(mats[i], torch.from_numpy(depths[i]), fx, fy, cx, cy, _coords(dims), t(DMIN),
                                   t(DMAX), t(vox))[0] for i in range(len(poses))])
    jax_acc = torch.from_numpy(np.stack([np.asarray(compute_projection(
        jnp.asarray(depths[i]), jnp.asarray(poses[i]), jnp.asarray(w2g), jnp.asarray(K), tuple(dims), (W, H),
        DMIN, DMAX, vox)[1]).reshape(-1) for i in range(len(poses))]))
    return port, jax_acc


def _exact_depths(rng, poses, dims):
    """Depth maps whose every pixel hit by a voxel holds exactly that voxel's
    float32 camera depth plus or minus voxel_size, the predicate's edge."""
    mats = P.view_matrices(poses, _w2g())
    fx, fy, cx, cy = P._intrinsics(K)
    x, y, z = _coords(dims)
    depths = np.zeros((len(poses), H, W), np.float32)
    for i, m in enumerate(mats):
        cam = [((m[r, 0] * x + m[r, 1] * y) + m[r, 2] * z) + m[r, 3] for r in range(3)]
        px = torch.round(cam[0] * fx / cam[2] + cx)
        py = torch.round(cam[1] * fy / cam[2] + cy)
        ok = ((cam[2] > DMIN + VOX) & (cam[2] < DMAX - VOX) & (px >= 0) & (px < W) & (py >= 0) & (py < H)).numpy()
        order = rng.permutation(np.flatnonzero(ok))  # a random voxel wins each pixel
        pix = (py.numpy()[order] * W + px.numpy()[order]).astype(np.int64)
        zc = cam[2].numpy()[order]
        sign = np.where(rng.rand(len(order)) < 0.5, -1.0, 1.0).astype(np.float32)
        depths[i].reshape(-1)[pix] = zc + sign * np.float32(VOX)
    return depths


@functools.cache
def _room():
    """A 96x48x96 room of 8 objects seen by 24 cameras standing in it, made
    as ``chip_smoke.py`` phase 7 makes its rooms: (depths, poses,
    world_to_grid, dims, voxel size)."""
    _, _, frames = chip_smoke.make_color_scene(np.random.RandomState(5), 24, extent=(96, 48, 96), n_objects=8)
    return frames["depths"], frames["poses"], frames["world_to_grid"], (96, 48, 96), chip_smoke.VOXEL


def _case(name):
    """(depths, poses, world_to_grid, dims, voxel size) of one
    conservativeness case."""
    if name == "room":
        return _room()
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "straddle":  # the scene config's voxels, depths near depth_min: voxels near the cut accept
        dims, vox, v = (48, 32, 48), chip_smoke.VOXEL, 64
        depths = rng.uniform(DMIN, rng.uniform(0.15, 0.6, (v, 1, 1)), (v, H, W)).astype(np.float32)
        return depths, _cameras(rng, v, dims, vox=vox), _w2g(vox), dims, vox
    dims = RAGGED if name == "ragged" else GRID
    poses = _cameras(rng, 6, dims, inside=name != "away")
    depths = rng.uniform(0.3, 3.5, (6, H, W)).astype(np.float32)
    if name == "zeros":
        depths[:] = 0.0
    elif name == "nan":
        depths[:] = np.nan
    elif name == "exact":
        depths = _exact_depths(rng, poses, dims)
    return depths, poses, _w2g(), dims, VOX


@pytest.mark.parametrize("name", ["inside", "straddle", "away", "ragged", "zeros", "nan", "exact", "room"])
def test_cull_keeps_every_pair_in_which_a_voxel_accepts(name):
    """Cameras inside the grid; bricks the camera plane crosses, with depths
    near the camera; views facing away from the grid; ragged dims; all-zero
    and NaN depth maps; depths exactly at zc +- voxel_size; a room."""
    depths, poses, w2g, dims, vox = _case(name)
    keep = P.brick_view_candidates_plain(torch.from_numpy(depths), poses, w2g, K, dims, DMIN, DMAX, vox)
    lo, hi = P.brick_bounds(dims)
    assert keep.shape == (len(lo), len(poses))
    bid = _brick_ids(dims)
    port, jax_acc = _accepts(depths, poses, w2g, dims, vox)
    for label, acc in (("port", port), ("jax", jax_acc)):
        hit = torch.zeros((len(lo), len(poses)), dtype=torch.bool)
        for i in range(len(poses)):
            hit[bid[acc[i]], i] = True
        assert not bool((hit & ~keep).any()), f"{label}: {int((hit & ~keep).sum())} culled pairs accept"
    if name in ("away", "zeros", "nan"):
        assert not bool(port.any()) and not bool(keep.any())
    else:
        assert int(port.sum()) > 100
    if name == "straddle":  # some accepting pair lies in a brick the camera plane crosses or nearly meets
        mats = P.view_matrices(poses, w2g)
        near = []
        for i, m in enumerate(mats):
            corners = torch.stack([torch.where(torch.tensor(s, dtype=torch.bool), hi, lo) for s in
                                   np.ndindex(2, 2, 2)], 1).float()
            zc = corners @ m[2, :3] + m[2, 3]
            near.append(zc.amin(1) <= P.FOOTPRINT_Z)
        near = torch.stack(near, 1)
        hit = torch.zeros_like(keep)
        for i in range(len(poses)):
            hit[bid[port[i]], i] = True
        assert bool((hit & near).any())


def test_cull_drops_most_pairs_of_a_room():
    """Not vacuous: in a room seen by 24 cameras standing in it, most
    (brick, view) pairs are culled."""
    depths, poses, w2g, dims, vox = _room()
    keep = P.brick_view_candidates_plain(torch.from_numpy(depths), poses, w2g, K, dims, DMIN, DMAX, vox)
    share = float(keep.float().mean())
    assert 0.0 < share < 0.35, share


def _emulated(feats, depths, poses, w2g, dims, vox, valid, zero_floor):
    """K3's brick algorithm on the CPU: the max over the views each brick
    keeps, floored at 0 in the bricks that culled a valid view."""
    keep = P.brick_view_candidates_plain(depths, poses, w2g, K, dims, DMIN, DMAX, vox, view_valid=valid)
    bid = _brick_ids(dims)
    mats = P.view_matrices(poses, w2g)
    fx, fy, cx, cy = P._intrinsics(K)
    t = torch.tensor
    v, _, _, c = feats.shape
    flat = feats.reshape(v, -1, c)
    out = torch.full((len(bid), c), -torch.inf, dtype=feats.dtype)
    floor = torch.zeros(len(bid), dtype=torch.bool)
    zero = torch.zeros((), dtype=feats.dtype)
    for i in torch.nonzero(valid).flatten().tolist():
        kept = keep[bid, i]
        acc, pix = P._project(mats[i], depths[i], fx, fy, cx, cy, _coords(dims), t(DMIN), t(DMAX), t(vox))
        assert not bool((acc & ~kept).any())
        out = torch.where(kept[:, None], torch.maximum(out, torch.where(acc[:, None], flat[i][pix], zero)), out)
        floor |= ~kept
    out = torch.where(floor[:, None], torch.maximum(out, zero), out)
    out = torch.where(torch.isneginf(out), zero, out)
    if zero_floor:
        out = torch.maximum(out, zero)
    return out.reshape(*dims, c), keep


@pytest.mark.parametrize("case", ["views", "single_view_negative", "every_view_culled_somewhere", "zero_floor",
                                  "ragged_bf16", "nan_rows"])
def test_brick_algorithm_equals_fuse_views_plain(case):
    """The brick algorithm with its floor flag == ``fuse_views_plain``,
    exactly and with NaN at the same places: a single valid view with
    negative features, which only the floor flag turns to 0 in the bricks
    that culled it; bricks from which every view is culled."""
    rng = np.random.RandomState(sum(map(ord, case)))
    dims = RAGGED if case == "ragged_bf16" else GRID
    v = 5
    poses = _cameras(rng, v, dims)
    depths = torch.from_numpy(rng.uniform(0.3, 3.5, (v, H, W)).astype(np.float32))
    feats = torch.from_numpy(rng.randn(v, H, W, 8).astype(np.float32))
    valid = torch.ones(v, dtype=torch.bool)
    zero_floor = case == "zero_floor"
    if case == "single_view_negative":
        valid[:] = False
        valid[2] = True
        feats = -feats.abs() - 0.25
    elif case == "ragged_bf16":
        feats = feats.bfloat16()
        valid[1] = False
    elif case == "nan_rows":
        feats[0, ::4, ::3] = float("nan")
    args = (feats, depths, poses, _w2g(), K, dims, DMIN, DMAX, VOX)
    want = P.fuse_views_plain(*args, view_valid=valid, zero_floor=zero_floor or None)
    got, keep = _emulated(feats, depths, poses, _w2g(), dims, VOX, valid, zero_floor)
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    assert torch.equal(nan_got, nan_want)
    assert torch.equal(got.masked_fill(nan_got, 0), want.masked_fill(nan_want, 0))
    assert bool((want != 0).any())
    culled = ~keep[:, valid]
    assert bool(culled.any())
    if case == "single_view_negative":
        assert bool((want < 0).any()) and bool(culled.any())
    if case == "every_view_culled_somewhere":
        assert bool(culled.all(1).any())
    if case == "nan_rows":
        assert bool(nan_want.any())


def test_brick_constants_match_the_kernel():
    """``BRICK``, ``CULL_EPS`` and ``FOOTPRINT_Z`` are the kernel's."""
    src = (Path(P.__file__).resolve().parents[1] / "csrc" / "fuse_views.cu").read_text()

    def const(name):
        return float(re.search(rf"(?:constexpr \w+|,) {name} = ([0-9.e-]+)f?[,;]", src).group(1))

    bx = int(const("kWarps")) * int(const("kSlices"))
    assert re.search(r"\bkBX = kWarps \* kSlices\b", src)
    assert (bx, int(const("kBY")), int(const("kBZ"))) == P.BRICK
    assert np.float32(const("kEps")) == np.float32(P.CULL_EPS)
    assert np.float32(const("kFootprintZ")) == np.float32(P.FOOTPRINT_Z)
