"""The view fusion's gradient on the CPU.

(a) ``fuse_views_backward_plain`` (the plain version of kernel K3b: autograd
of ``fuse_views_plain``) against ``jax.vjp`` of the JAX package's
``fuse_views``, whose backward is its ``_onehot_row_gather`` VJP under
autodiff of the view scan's max: tie-free features, duplicated views (exact
ties of 2 and 3 views), features exactly 0 where other valid views miss the
voxel, an invalid view among tied ones, voxels no view accepts and negative
features. The cameras are axis-aligned and the grid's scale a power of two,
so both packages' matrices, and with them every accept decision, are exact;
the tolerance, 1e-5 of the largest gradient, covers the order of the float32
sums (JAX contracts a one-hot matrix, the port scatter-adds). (b) K3b's walk
order emulated (two walks per voxel over the brick's candidates from the
shared cull, the valid views the cull drops counted as zeros at their place)
against the plain gradient, on cameras standing inside the grid, where the
cull drops views that tie at 0. (c) What ``fuse_views`` refuses and takes
under autograd. Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu3dsis.geometry.projection import fuse_views as jax_fuse_views
from tpu3dsis_torch.geometry import projection as P

W, H = 10, 8
K = np.array([[6.0, 0, 4.5, 0], [0, 6.0, 3.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
VOX = 0.25
GRID = (24, 12, 24)  # 6 x 3 x 6 m
DMIN, DMAX = 0.4, 7.0
C = 8
W2G = np.diag([1 / VOX, 1 / VOX, 1 / VOX, 1.0]).astype(np.float32)  # exact inverse


def _poses(eyes):
    """Cameras looking along +z (identity rotation) at the given eyes,
    multiples of 0.25 m: every matrix entry and inverse is exact."""
    poses = np.tile(np.eye(4, dtype=np.float32), (len(eyes), 1, 1))
    poses[:, :3, 3] = eyes
    return poses


EYES = [[3.0, 1.5, -1.0], [2.75, 1.25, -1.5], [3.25, 1.75, -0.5], [2.5, 1.5, -2.0], [3.5, 1.0, -1.25],
        [3.0, 2.0, -0.75]]


def _case(name):
    """(feats, depths, poses, view_valid) of one case: 6 views."""
    rng = np.random.RandomState(sum(map(ord, name)))
    v = len(EYES)
    feats = rng.randn(v, H, W, C).astype(np.float32)
    depths = rng.uniform(1.0, 6.5, (v, H, W)).astype(np.float32)
    poses = _poses(EYES)
    valid = np.ones(v, bool)
    if name in ("duplicated_views", "invalid_view_among_ties"):
        for i in (1, 2):  # views 0-2 one camera: ties of 3; views 3-4 another: ties of 2
            feats[i], depths[i], poses[i] = feats[0], depths[0], poses[0]
        feats[4], depths[4], poses[4] = feats[3], depths[3], poses[3]
        if name == "invalid_view_among_ties":
            valid[1] = False
    elif name == "exact_zeros":  # many exact zeros and plateaus: ties at 0 with views that miss the voxel
        feats = np.maximum(np.round(feats * 2) / 2, 0).astype(np.float32)
    elif name == "negative":  # one valid view: its negative features pass through, with their gradient
        feats = -np.abs(feats) - 0.1
        valid[:] = False
        valid[3] = True
    elif name == "no_view_accepts":  # half the views face away from the grid
        poses[::2] = _poses([[3.0, 1.5, 20.0]] * 3)
        depths[::2] = 2.0
    return feats, depths, poses, valid


def _fused_args(depths, poses):
    return (torch.from_numpy(depths), poses, W2G, K, GRID, DMIN, DMAX, VOX)


def jax_vjp(feats, depths, poses, valid, g):
    def f(x):
        return jax_fuse_views(x, jnp.asarray(depths), jnp.asarray(poses), jnp.asarray(W2G), jnp.asarray(K), GRID,
                              (W, H), DMIN, DMAX, VOX, view_valid=jnp.asarray(valid))

    out, vjp = jax.vjp(f, jnp.asarray(feats))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("case", ["tie_free", "duplicated_views", "invalid_view_among_ties", "exact_zeros",
                                  "negative", "no_view_accepts"])
def test_plain_gradient_matches_jax_vjp(case):
    feats, depths, poses, valid = _case(case)
    g = np.random.RandomState(1).randn(*GRID, C).astype(np.float32)
    want_out, want = jax_vjp(feats, depths, poses, valid, g)
    args = _fused_args(depths, poses)
    out = P.fuse_views_plain(torch.from_numpy(feats), *args, view_valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(out.numpy(), want_out)  # the same accept decisions
    got = P.fuse_views_backward_plain(torch.from_numpy(g), torch.from_numpy(feats), *args,
                                      view_valid=torch.from_numpy(valid)).numpy()
    assert got.shape == feats.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    accepted = (want != 0).any(-1).sum()
    assert accepted > 20
    # the copies' shares are equal up to the order of their float32 sums
    tol = 1e-6 * np.abs(got).max()
    if case == "duplicated_views":
        # tied copies of one camera: the staged split 0.25, 0.25, 0.5 and 0.5, 0.5
        np.testing.assert_allclose(got[0], got[1], rtol=0, atol=tol)
        np.testing.assert_allclose(2 * got[1], got[2], rtol=0, atol=tol)
        np.testing.assert_allclose(got[3], got[4], rtol=0, atol=tol)
    if case == "invalid_view_among_ties":
        assert not got[1].any()
        np.testing.assert_allclose(got[0], got[2], rtol=0, atol=tol)
    if case == "exact_zeros":
        assert (out.numpy() == 0).mean() > 0.5 and (feats == 0).mean() > 0.3
    if case == "negative":
        assert not np.delete(got, 3, 0).any() and (out.numpy() < 0).any()
    if case == "no_view_accepts":
        assert not got[::2].any()
        assert (out.numpy() == 0).all(-1).mean() > 0.5  # voxels no view accepts send nothing


def test_autograd_function_is_the_plain_pair_on_the_cpu():
    """``fuse_views`` on features that require a gradient: K3's plain
    forward and the plain backward (up to the order of its float32 sums); a
    bf16 or ``zero_floor`` call that needs a gradient raises."""
    feats, depths, poses, valid = _case("duplicated_views")
    f = torch.from_numpy(feats).requires_grad_(True)
    args = _fused_args(depths, poses)
    vv = torch.from_numpy(valid)
    out = P.fuse_views(f, *args, view_valid=vv)
    assert torch.equal(out, P.fuse_views_plain(f.detach(), *args, view_valid=vv))
    g = torch.from_numpy(np.random.RandomState(2).randn(*GRID, C).astype(np.float32))
    (d,) = torch.autograd.grad(out, f, g)
    want = P.fuse_views_backward_plain(g, f.detach(), *args, view_valid=vv)
    # the CPU's scatter-add sums in parallel, so two calls may differ in the order of their sums
    torch.testing.assert_close(d, want, rtol=0, atol=1e-6 * float(want.abs().max()))
    with pytest.raises(ValueError, match="zero_floor"):
        P.fuse_views(f, *args, view_valid=vv, zero_floor=True)
    with pytest.raises(ValueError, match="float32"):
        P.fuse_views(f.detach().bfloat16().requires_grad_(True), *args)
    with torch.no_grad():  # the tiles' call: no gradient, zero_floor and bf16 taken
        P.fuse_views(f.bfloat16(), *args, zero_floor=True)


# --- K3b's walk order, emulated ------------------------------------------------------

EK = np.asarray(chip_smoke.scannet_color_scene_config().INTRINSIC, np.float32)  # 60-degree pinhole at 41x32
EW, EH = 41, 32
EDIMS = (32, 16, 29)  # ragged in z
EVOX = 0.1


def _brick_ids(dims):
    nb = [-(-n // b) for n, b in zip(dims, P.BRICK)]
    g = torch.meshgrid(*(torch.arange(n) for n in dims), indexing="ij")
    x, y, z = (t.reshape(-1) // b for t, b in zip(g, P.BRICK))
    return (x * nb[1] + y) * nb[2] + z


def k3b_emulated(grad_out, feats, depths, poses, w2g, dims, view_valid, count_culled=True):
    """K3b's algorithm on the CPU: per voxel, the candidates its brick keeps
    (``brick_view_candidates_plain``); a first walk over the accepting ones
    in view order for the largest feature and its count; the valid views
    that do not accept the voxel, culled ones included, give m and t their
    zeros; a second walk gives each accepting candidate equal to m its
    staged share, its place counting the zeros before it (the valid views
    before it less the accepting candidates before it). With
    ``count_culled`` False the culled views are left out of the order (a
    wrong K3b, to show the test can tell)."""
    v, h, w, c = feats.shape
    keep = P.brick_view_candidates_plain(depths, poses, w2g, EK, dims, DMIN, DMAX, EVOX, view_valid=view_valid)
    bid = _brick_ids(dims)
    mats = P.view_matrices(poses, w2g)
    fx, fy, cx, cy = P._intrinsics(EK)
    t32 = torch.tensor
    g = torch.meshgrid(*(torch.arange(n, dtype=torch.float32) for n in dims), indexing="ij")
    coords = tuple(t.reshape(-1) for t in g)
    n = coords[0].numel()
    flat = feats.reshape(v, h * w, c)
    # the views that take part in each voxel's order, and how many come before each
    order = view_valid[None, :] & (keep[bid] if not count_culled else True)
    rank = torch.cumsum(order.long(), 1) - order.long()
    n_valid = order.sum(1)
    acc, rows, pixs = [], [], []
    for i in range(v):
        a, pix = P._project(mats[i], depths[i], fx, fy, cx, cy, coords, t32(DMIN), t32(DMAX), t32(EVOX))
        kept = keep[bid, i]
        if view_valid[i]:  # an invalid view is no candidate anywhere
            assert not bool((a & ~kept).any()), "the cull dropped an accepting pair"
        acc.append(a & kept)
        rows.append(flat[i][pix])
        pixs.append(pix)
    # first walk
    mx = torch.full((n, c), -torch.inf)
    cnt = torch.zeros((n, c), dtype=torch.int64)
    n_acc = torch.zeros(n, dtype=torch.int64)
    for i in range(v):
        a = acc[i][:, None]
        f = rows[i]
        up, eq = a & (f > mx), a & (f == mx)
        cnt = torch.where(up, 1, torch.where(eq, cnt + 1, cnt))
        mx = torch.where(up, f, mx)
        n_acc += acc[i]
    n_zero = (n_valid - n_acc)[:, None]
    m = torch.where((n_zero > 0) & (mx < 0), 0.0, mx)
    t = torch.where((n_zero > 0) & (mx < 0), n_zero, torch.where((n_zero > 0) & (mx == 0), cnt + n_zero, cnt))
    # second walk
    out = torch.zeros((v, h * w, c))
    gr = grad_out.reshape(n, c)
    tied = torch.zeros((n, c), dtype=torch.int64)
    acc_before = torch.zeros(n, dtype=torch.int64)
    for i in range(v):
        a = acc[i]
        hit = a[:, None] & (rows[i] == m)
        zeros_before = (rank[:, i] - acc_before)[:, None]
        place = 1 + tied + torch.where(m == 0, zeros_before, 0)
        e = torch.where(place == 1, t - 1, t - place + 1)
        share = torch.where(hit, torch.ldexp(gr, -e.float()), 0.0)
        out[i].index_add_(0, pixs[i], share)
        tied += hit
        acc_before += a
    return out.reshape(v, h, w, c), keep, (m == 0) & (mx == 0) & (n_zero > 0)


@pytest.mark.parametrize("case", ["plateaus", "negative", "invalid_views"])
def test_k3b_algorithm_matches_plain_gradient(case):
    """The emulated walk == ``fuse_views_backward_plain`` within 1e-5 of the
    largest gradient (the order of the sums), on cameras inside the grid with
    exact-zero and plateau features; it exercises ties at 0 between views that
    accept a voxel with a 0 feature and views the cull drops for its brick,
    and counting those views is what makes it right."""
    rng = np.random.RandomState(sum(map(ord, case)))
    v = 6
    ext = np.asarray(EDIMS) * EVOX
    poses = np.asarray([chip_smoke.camera_pose(rng.uniform(0.2, 0.8, 3) * ext, rng.uniform(0, 360),
                                               rng.uniform(-20, 20)) for _ in range(v)], np.float32)
    w2g = np.diag([1 / EVOX] * 3 + [1.0]).astype(np.float32)
    depths = torch.from_numpy(rng.uniform(0.3, 3.0, (v, EH, EW)).astype(np.float32))
    feats = np.maximum(np.round(rng.randn(v, EH, EW, 4) * 2) / 2, 0)
    valid = torch.ones(v, dtype=torch.bool)
    if case == "negative":
        feats = np.where(rng.rand(*feats.shape) < 0.5, -feats - 0.5, feats)
    elif case == "invalid_views":
        valid[[1, 4]] = False
    feats = torch.from_numpy(feats.astype(np.float32))
    g = torch.from_numpy(rng.randn(*EDIMS, 4).astype(np.float32))
    want = P.fuse_views_backward_plain(g, feats, depths, poses, w2g, EK, EDIMS, DMIN, DMAX, EVOX, view_valid=valid)
    got, keep, zero_ties = k3b_emulated(g, feats, depths, poses, w2g, EDIMS, valid)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    # not vacuous: voxels tie at 0 in bricks that culled a valid view
    culled_somewhere = (~keep[:, valid]).any(1)[_brick_ids(EDIMS)]
    assert int((zero_ties.any(1) & culled_somewhere).sum()) > 10
    # and those culled views matter: leaving them out of the order is wrong
    wrong, _, _ = k3b_emulated(g, feats, depths, poses, w2g, EDIMS, valid, count_culled=False)
    assert float((wrong - want).abs().max()) > 1e-3 * float(want.abs().max())
