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
sums (JAX contracts a one-hot matrix, the port scatter-adds). (b) The
batched fusion the train step runs (``fuse_views_batch``, one K3b call for
the batch on the card): its plain forward is each sample's, its gradient
each sample's ``jax.vjp`` (a sample with no valid view among them). (c)
K3b's two passes emulated (pass 1's pixel slabs, pass 2's held rows, the
valid views that do not accept a voxel counted as zeros at their place)
against the plain gradient, on cameras standing inside the grid, where K3's
cull drops views that tie at 0; pass 1's slabs held against every
accepting (voxel, view) pair. (d) What ``fuse_views`` refuses and takes
under autograd. Inputs come from numpy seeds.
"""

import re
from pathlib import Path

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


# --- the batched fusion ----------------------------------------------------------------

# pairs of samples: different view_valid in each, and a sample with every view invalid
BATCHES = {"ties_and_zeros": [("duplicated_views", [True, True, True, False, True, True]),
                              ("exact_zeros", [True, False, True, True, True, False])],
           "one_sample_without_views": [("invalid_view_among_ties", None), ("tie_free", [False] * 6)]}


def _batch(name):
    """(feats (2, V, H, W, C), depths, poses (2, V, 4, 4), world_to_grid (2, 4, 4), view_valid (2, V))."""
    parts = []
    for case, valid in BATCHES[name]:
        feats, depths, poses, v = _case(case)
        parts.append((feats, depths, poses, v if valid is None else np.asarray(valid)))
    feats, depths, poses, valid = (np.stack(x) for x in zip(*parts))
    return feats, depths, poses, np.tile(W2G, (2, 1, 1)), valid


def test_view_matrices_of_a_batch_are_each_samples():
    """One ``view_matrices`` call on a batch (the forward's one host op)
    gives each sample's matrices bit for bit, so K3 and its plain version
    read the same floats."""
    rng = np.random.RandomState(3)
    poses = np.asarray([[chip_smoke.camera_pose(rng.uniform(0, 5, 3), rng.uniform(0, 360), rng.uniform(-20, 20))
                         for _ in range(5)] for _ in range(3)], np.float32)
    w2g = np.asarray([np.diag([1 / 0.047, 1 / 0.047, 1 / 0.047, 1.0]) for _ in range(3)], np.float32)
    w2g[:, :3, 3] = rng.uniform(-40, 40, (3, 3))
    got = P.view_matrices(poses, w2g)
    assert got.shape == (3, 5, 3, 4)
    for i in range(3):
        assert torch.equal(got[i], P.view_matrices(poses[i], w2g[i]))


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batched_plain_forward_is_each_sample_plain(name):
    """``fuse_views_batch`` on CPU features (no gradient, and with one): each
    sample's ``fuse_views_plain``, bit for bit."""
    feats, depths, poses, w2g, valid = _batch(name)
    f, d, vv = torch.from_numpy(feats), torch.from_numpy(depths), torch.from_numpy(valid)
    want = torch.stack([P.fuse_views_plain(f[i], d[i], poses[i], w2g[i], K, GRID, DMIN, DMAX, VOX, view_valid=vv[i])
                        for i in range(2)])
    assert torch.equal(P.fuse_views_batch(f, d, poses, w2g, K, GRID, DMIN, DMAX, VOX, view_valid=vv), want)
    got = P.fuse_views_batch(f.clone().requires_grad_(True), d, poses, w2g, K, GRID, DMIN, DMAX, VOX, view_valid=vv)
    assert torch.equal(got.detach(), want) and bool((want[0] != 0).any())
    if name == "one_sample_without_views":
        assert not want[1].any()


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batched_plain_gradient_matches_jax_vjp(name):
    """The batched plain gradient, and the batched autograd function's on the
    CPU, against ``jax.vjp`` of the JAX ``fuse_views`` per sample, stacked,
    to 1e-6 of the largest gradient: different view_valid in each sample,
    ties, zeros, and a sample with every view invalid (no gradient)."""
    feats, depths, poses, w2g, valid = _batch(name)
    g = np.random.RandomState(4).randn(2, *GRID, C).astype(np.float32)
    want = np.stack([jax_vjp(feats[i], depths[i], poses[i], valid[i], g[i])[1] for i in range(2)])
    args = (torch.from_numpy(feats), torch.from_numpy(depths), poses, w2g, K, GRID, DMIN, DMAX, VOX)
    vv = torch.from_numpy(valid)
    got = P.fuse_views_backward_batch_plain(torch.from_numpy(g), *args, view_valid=vv).numpy()
    tol = 1e-6 * np.abs(want).max()
    assert np.abs(want[0]).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    f = args[0].clone().requires_grad_(True)
    (d,) = torch.autograd.grad(P.fuse_views_batch(f, *args[1:], view_valid=vv), f, torch.from_numpy(g))
    np.testing.assert_allclose(d.numpy(), want, rtol=0, atol=tol)
    if name == "one_sample_without_views":
        assert not want[1].any() and not got[1].any()


def test_color_projector_batch_is_the_plain_pair_on_the_cpu():
    """``ColorProjector.project_batch`` (the train step's call) on the CPU:
    the plain forward per sample, and its gradient the plain backward per
    sample (up to the order of the CPU's float32 sums); bf16 features that
    need a gradient raise."""
    from tpu3dsis_torch.models.color import ColorProjector

    cfg = chip_smoke.scannet_color_scene_config()
    proj = ColorProjector(cfg, None)
    proj.intrinsic, proj.depth_min, proj.depth_max, proj.voxel_size = K, DMIN, DMAX, VOX
    feats, depths, poses, w2g, valid = _batch("ties_and_zeros")
    f = torch.from_numpy(feats).requires_grad_(True)
    d, vv = torch.from_numpy(depths), torch.from_numpy(valid)
    out = proj.project_batch(f, d, poses, w2g, GRID, view_valid=vv)
    assert torch.equal(out.detach(), P.fuse_views_batch(f.detach(), d, poses, w2g, K, GRID, DMIN, DMAX, VOX,
                                                        view_valid=vv))
    g = torch.from_numpy(np.random.RandomState(5).randn(2, *GRID, C).astype(np.float32))
    (dx,) = torch.autograd.grad(out, f, g)
    want = P.fuse_views_backward_batch_plain(g, f.detach(), d, poses, w2g, K, GRID, DMIN, DMAX, VOX, view_valid=vv)
    torch.testing.assert_close(dx, want, rtol=0, atol=1e-6 * float(want.abs().max()))
    with pytest.raises(ValueError, match="float32"):
        proj.project_batch(f.detach().bfloat16().requires_grad_(True), d, poses, w2g, GRID, view_valid=vv)


# --- K3b's two passes, emulated ----------------------------------------------------

EK = np.asarray(chip_smoke.scannet_color_scene_config().INTRINSIC, np.float32)  # 60-degree pinhole at 41x32
EW, EH = 41, 32
EDIMS = (32, 16, 29)  # ragged in z
EVOX = 0.1


def _brick_ids(dims):
    nb = [-(-n // b) for n, b in zip(dims, P.BRICK)]
    g = torch.meshgrid(*(torch.arange(n) for n in dims), indexing="ij")
    x, y, z = (t.reshape(-1) // b for t, b in zip(g, P.BRICK))
    return (x * nb[1] + y) * nb[2] + z


_K3B_SRC = (Path(P.__file__).resolve().parents[1] / "csrc" / "fuse_views_bwd.cu").read_text()


def _k3b_const(name):
    return float(re.search(rf"constexpr (?:int|float) {name} = ([0-9.e+-]+)f?;", _K3B_SRC).group(1))


KROWS = int(_k3b_const("kRows"))
# pass 1's margins, of the magnitudes they scale with
ULPS = torch.tensor(_k3b_const("kUlps") * float(np.finfo(np.float32).eps), dtype=torch.float32)


def cam_margin(mats, dims):
    """K3b pass 1's margin for a voxel's camera coordinates, per view: kUlps
    FLT_EPSILON of the view's extent over the grid (the largest row of
    |m_r0| (X - 1) + |m_r1| (Y - 1) + |m_r2| (Z - 1) + |m_r3|)."""
    m = mats.reshape(-1, 12)
    ext = torch.zeros(m.shape[0])
    for r in range(3):
        ext = torch.maximum(ext, ((m[:, 4 * r].abs() * float(dims[0] - 1) + m[:, 4 * r + 1].abs() * float(dims[1] - 1))
                                  + m[:, 4 * r + 2].abs() * float(dims[2] - 1)) + m[:, 4 * r + 3].abs())
    return ULPS * ext


def slab_boxes(mats, depths, valid, dims, depth_min, voxel_size, intrinsic=EK, depth_max=DMAX, inverse_error=False):
    """K3b pass 1's box of each (view, pixel), in the kernel's float32
    operations and their order (its margins read from its source): (V, H *
    W, 3) first and last voxel, empty (first > last) where the view is
    invalid or the pixel's depth is out of range. A slab's 8 corners go to
    the grid through the adjugate of the matrix's 3x3 times the reciprocal
    of its determinant, each widened by the camera coordinates' error
    through that inverse and by the inverse's own (times the view's
    ``margin_scales``). With ``inverse_error``
    also the largest ratio, over the live corners, of the float32 corner's
    distance from its float64 image to the inverse's margin."""
    v, h, w = depths.shape
    fx, fy, cx, cy = P._intrinsics(intrinsic)
    m = mats.reshape(v, 12)
    cam_err = cam_margin(mats, dims)[:, None]
    slack = ULPS * (float(max(w, h)) + torch.maximum(cx.abs(), cy.abs()))
    a = torch.stack([m[:, 5] * m[:, 10] - m[:, 6] * m[:, 9], m[:, 2] * m[:, 9] - m[:, 1] * m[:, 10],
                     m[:, 1] * m[:, 6] - m[:, 2] * m[:, 5], m[:, 6] * m[:, 8] - m[:, 4] * m[:, 10],
                     m[:, 0] * m[:, 10] - m[:, 2] * m[:, 8], m[:, 2] * m[:, 4] - m[:, 0] * m[:, 6],
                     m[:, 4] * m[:, 9] - m[:, 5] * m[:, 8], m[:, 1] * m[:, 8] - m[:, 0] * m[:, 9],
                     m[:, 0] * m[:, 5] - m[:, 1] * m[:, 4]], 1)[:, None, :]  # (V, 1, 9)
    rdet = (1 / ((m[:, 0] * a[:, 0, 0] + m[:, 1] * a[:, 0, 3]) + m[:, 2] * a[:, 0, 6]))[:, None]
    amax = a.abs().amax(-1)
    scales = P.margin_scales(mats)[:, None]  # the square of each 3x3's condition number
    d = depths.reshape(v, -1)
    eps = np.float32(P.CULL_EPS)
    z0 = torch.clamp((d - np.float32(voxel_size)) - eps, min=0.0)
    z1 = (d + np.float32(voxel_size)) + eps
    u0, v0 = (torch.arange(h * w) % w).float(), (torch.arange(h * w) // w).float()
    lo, hi = torch.full((v, h * w, 3), torch.inf), torch.full((v, h * w, 3), -torch.inf)
    live = valid[:, None] & (d >= depth_min) & (d <= depth_max)
    inv64 = torch.linalg.inv(mats[:, :, :3].double())[:, None]  # (V, 1, 3, 3)
    worst = 0.0
    for i in range(8):
        zc = z1 if i & 4 else z0
        e = [((u0 + (0.5 + slack if i & 1 else -0.5 - slack)) - cx) * (1 / fx) * zc,
             ((v0 + (0.5 + slack if i & 2 else -0.5 - slack)) - cy) * (1 / fy) * zc, zc]
        c = [e[j] - m[:, 4 * j + 3:4 * j + 4] for j in range(3)]
        size = ((e[0].abs() + m[:, 3:4].abs()) + (e[1].abs() + m[:, 7:8].abs())) + (e[2].abs() + m[:, 11:12].abs())
        inv_err = ULPS * size * amax * rdet.abs() * scales
        if inverse_error:
            c64 = torch.stack([((u0.double() + (0.5 + slack.double() if i & 1 else -0.5 - slack.double()))
                                - cx.double()) / fx.double() * zc.double(),
                               ((v0.double() + (0.5 + slack.double() if i & 2 else -0.5 - slack.double()))
                                - cy.double()) / fy.double() * zc.double(), zc.double()], -1)
            g64 = (inv64 @ (c64 - m[:, None, 3::4].double())[..., None])[..., 0]
        for r in range(3):
            ar = a[..., 3 * r:3 * r + 3]
            g = ((ar[..., 0] * c[0] + ar[..., 1] * c[1]) + ar[..., 2] * c[2]) * rdet
            wr = cam_err * ((ar[..., 0].abs() + ar[..., 1].abs()) + ar[..., 2].abs()) * rdet.abs() + inv_err
            finite = torch.isfinite(g - wr) & torch.isfinite(g + wr)
            if inverse_error:
                worst = max(worst, float(((g.double() - g64[..., r]).abs() / inv_err)[live].max()))
            lo[..., r] = torch.minimum(lo[..., r], torch.where(finite, g - wr, -torch.inf))
            hi[..., r] = torch.maximum(hi[..., r], torch.where(finite, g + wr, torch.inf))
    top = torch.tensor(dims, dtype=torch.float32) - 1
    first = torch.where(torch.isfinite(lo), torch.clamp(torch.ceil(lo), min=0), 0.0)
    last = torch.where(torch.isfinite(hi), torch.minimum(torch.floor(hi), top), top)
    boxes = torch.where(live[..., None], first, 1.0), torch.where(live[..., None], last, 0.0)
    return (*boxes, worst) if inverse_error else boxes


def k3b_emulated(grad_out, feats, depths, poses, w2g, dims, view_valid, count_culled=True, rows_held=KROWS):
    """K3b's two passes on the CPU, for one sample (C a multiple of 4: a
    lane holds 4 channels). Pass 1: a voxel is listed when it accepts a
    valid view at a pixel whose slab box (``slab_boxes``) holds it. Pass 2,
    per listed voxel: the predicate of every valid view; the accepting
    views' rows read ``rows_held`` at a time, in view order, into the
    largest value and its count (a row that meets or raises a lane's running
    max marks itself); the valid views that do not accept the voxel give m
    and t their zeros; then each accepting view equal to m takes its staged
    share, its place counting the zeros before it (the valid views before it
    less the accepting views before it), from the rows still held, or, for
    earlier rounds, from the marked rows read again (the unmarked ones
    skipped). Returns (gradient, K3's cull, voxels tied at 0 in a brick
    whose cull dropped a valid view, row reads, accepting pairs, rows of
    earlier rounds). With ``count_culled`` False the views K3's cull drops
    for the voxel's brick are left out of the zero count (a wrong K3b, to
    show the test can tell)."""
    v, h, w, c = feats.shape
    keep = P.brick_view_candidates_plain(depths, poses, w2g, EK, dims, DMIN, DMAX, EVOX, view_valid=view_valid)
    bid = _brick_ids(dims)
    mats = P.view_matrices(poses, w2g)
    fx, fy, cx, cy = P._intrinsics(EK)
    t32 = torch.tensor
    g = torch.meshgrid(*(torch.arange(n, dtype=torch.float32) for n in dims), indexing="ij")
    coords = tuple(t.reshape(-1) for t in g)
    grid = torch.stack(coords, 1)
    first, last = slab_boxes(mats, depths, view_valid, dims, DMIN, EVOX)
    acc, pixs, listed = [], [], torch.zeros(grid.shape[0], dtype=torch.bool)
    for i in range(v):
        a, pix = P._project(mats[i], depths[i], fx, fy, cx, cy, coords, t32(DMIN), t32(DMAX), t32(EVOX))
        a = a & bool(view_valid[i])
        listed |= a & ((grid >= first[i][pix]) & (grid <= last[i][pix])).all(1)
        acc.append(a)
        pixs.append(pix)
    acc, pixs = torch.stack(acc, 1), torch.stack(pixs, 1)  # (voxels, V): pass 2's predicate
    assert not bool((acc & ~keep[bid]).any()), "K3's cull dropped an accepting pair"
    assert torch.equal(listed, acc.any(1)), "a pixel's slab box missed a voxel that accepts there"
    idx = torch.nonzero(listed).flatten()
    acc, pixs, culled = acc[idx], pixs[idx], ~keep[bid[idx]] & view_valid[None, :]
    n = idx.numel()
    counted = view_valid[None, :].expand(n, v) & (True if count_culled else ~culled)  # the zero count's views
    rank = torch.cumsum(counted.long(), 1) - counted.long()
    n_acc = acc.sum(1)
    # the accepting views of each voxel, in view order, then the rest
    order = torch.sort((~acc).long(), dim=1, stable=True).indices
    views = torch.gather(torch.arange(v).expand(n, v), 1, order)
    pix = torch.gather(pixs, 1, order)
    zb = torch.gather(rank, 1, order) - torch.arange(v)  # zeros before the j-th accepting view
    flat = feats.reshape(v, h * w, c)
    lanes = c // 4
    reads = 0

    def read(j, who):
        nonlocal reads
        reads += int(who.sum())
        return torch.where(who[:, None], flat[views[:, j], pix[:, j]], torch.nan)

    mx = torch.full((n, c), -torch.inf)
    cnt = torch.zeros((n, c), dtype=torch.int64)
    met = torch.zeros((n, v, lanes), dtype=torch.bool)
    held = torch.div(n_acc - 1, rows_held, rounding_mode="floor").clamp(min=0) * rows_held  # first row still held
    rows = []
    for j in range(v):
        live = j < n_acc
        rows.append(read(j, live))
        f = rows[j]
        up, eq = f > mx, f == mx
        met[:, j] = (up | eq).reshape(n, lanes, 4).any(-1)
        cnt = torch.where(up, 1, torch.where(eq, cnt + 1, cnt))
        mx = torch.where(up, f, mx)
    n_zero = (counted.sum(1) - n_acc)[:, None]
    m = torch.where((n_zero > 0) & (mx < 0), 0.0, mx)
    t = torch.where((n_zero > 0) & (mx < 0), n_zero, torch.where((n_zero > 0) & (mx == 0), cnt + n_zero, cnt))
    out = torch.zeros((v, h * w, c))
    gr = grad_out.reshape(-1, c)[idx]
    tied = torch.zeros((n, c), dtype=torch.int64)
    for j in range(v):
        live = j < n_acc
        still = live & (j >= held)
        again = live & (j < held) & (met[:, j].any(1) if j < 64 else True)
        f = torch.where(still[:, None], rows[j], torch.nan)  # the last round's rows, still in registers
        if bool(again.any()):
            reloaded = read(j, again)
            f = torch.where(again[:, None], reloaded, f)
        hit = f == m
        place = 1 + tied + torch.where(m == 0, zb[:, j, None], 0)
        e = torch.where(place == 1, t - 1, t - place + 1)
        share = torch.where(hit, torch.ldexp(gr, -e.float()), 0.0)
        out.view(-1, c).index_add_(0, views[:, j] * h * w + pix[:, j], share)
        tied += hit
    culled_any = culled.any(1)
    zero_ties = ((m == 0) & (mx == 0) & (n_zero > 0)).any(1) & culled_any
    return out.reshape(v, h, w, c), keep, int(zero_ties.sum()), reads, int(n_acc.sum()), int(held.sum())


def _slab_setup(name, rng, depth_min=DMIN):
    """(dims, voxel size, intrinsic, depth_min, depth_max, poses, world_to_grid,
    depths) of 8 views: "near_camera", cameras inside a small grid at random
    angles with depths down to 2 cm (with depth_min 0, slabs reach the
    camera plane); "scene", the color scene's 240x48x240 grid at 0.047 m
    with its room offset and cameras standing in the room; "train", the
    training call's 96x48x96 grid at 0.094 m, its offset and bench_train's
    cameras 1 m in front of it."""
    v = 8
    if name == "near_camera":
        ext = np.asarray(EDIMS) * EVOX
        poses = [chip_smoke.camera_pose(rng.uniform(0.1, 0.9, 3) * ext, rng.uniform(0, 360), rng.uniform(-60, 60))
                 for _ in range(v)]
        w2g = np.diag([1 / EVOX] * 3 + [1.0])
        w2g[:3, 3] = rng.uniform(-0.5, 0.5, 3)
        depths = rng.uniform(0.02, 3.0, (v, EH, EW))
        depths[::2] = rng.uniform(0.02, 0.3, (v // 2, EH, EW))  # every other view sees a wall at arm's length
        return EDIMS, EVOX, EK, depth_min, DMAX, poses, w2g, depths
    if name in ("sheared", "uneven"):
        # the near-camera views on a grid whose world_to_grid is sheared, or
        # scaled unevenly (3x3 condition numbers about 20 and 6)
        dims, vs, k, dmin, dmax, poses, w2g, depths = _slab_setup("near_camera", rng, depth_min)
        lin = (np.array([[1.0, 2.5, -1.5], [0.0, 1.0, 2.0], [0.0, 0.0, 1.0]]) if name == "sheared"
               else np.diag([1.0, 3.0, 0.5]))
        w2g[:3, :3] = lin @ w2g[:3, :3]
        return dims, vs, k, dmin, dmax, poses, w2g, depths
    if name == "train":
        cfg = chip_smoke.enet_train_config()
        poses = np.tile(np.eye(4), (v, 1, 1))
        poses[:, 2, 3] = -1.0
        vs, dims = float(cfg.VOXEL_SIZE), chip_smoke.SHAPE
        w2g = np.diag([1 / vs] * 3 + [1.0])
        w2g[:3, 3] = [dims[0] / 2, 0.0, dims[2] / 2]
        return dims, vs, cfg.INTRINSIC, cfg.PROJ_DEPTH_MIN, cfg.PROJ_DEPTH_MAX, poses, w2g, \
            rng.uniform(0.4, 4.0, (v, EH, EW))
    cfg = chip_smoke.scannet_color_scene_config()
    dims, vs = chip_smoke.SCENE_EXTENT, chip_smoke.VOXEL
    room = (np.asarray(dims) - 2 * chip_smoke.ROOM_OFFSET) * vs
    poses = [chip_smoke.camera_pose(np.array([rng.uniform(0.5, room[0] - 0.5), rng.uniform(1.25, 1.85),
                                              rng.uniform(0.5, room[2] - 0.5)]), rng.uniform(0, 360),
                                    rng.uniform(-5, 30)) for _ in range(v)]
    w2g = np.diag([1 / vs] * 3 + [1.0])
    w2g[:3, 3] = chip_smoke.ROOM_OFFSET
    return dims, vs, cfg.INTRINSIC, cfg.PROJ_DEPTH_MIN, cfg.PROJ_DEPTH_MAX, poses, w2g, \
        rng.uniform(0.05, 4.5, (v, EH, EW))


def _check_slabs(dims, vs, k, dmin, dmax, poses, w2g, depths, mean_box=50):
    """Every accepting (voxel, view) pair of the whole grid lies in its
    pixel's slab box; the boxes hold a few voxels; the float error the
    margins cover, measured against float64 at the accepting voxels (their
    camera coordinates) and at every live corner (its image in the grid),
    stays under a quarter of its margin. Returns the accepting pairs whose
    slab reaches the camera plane."""
    v = len(poses)
    poses, w2g = np.asarray(poses, np.float32), np.asarray(w2g, np.float32)
    depths = torch.from_numpy(np.asarray(depths, np.float32))
    valid = torch.ones(v, dtype=torch.bool)
    mats = P.view_matrices(poses, w2g)
    fx, fy, cx, cy = P._intrinsics(k)
    g = torch.meshgrid(*(torch.arange(n, dtype=torch.float32) for n in dims), indexing="ij")
    coords = tuple(t.reshape(-1) for t in g)
    first, last, inv_ratio = slab_boxes(mats, depths, valid, dims, dmin, vs, intrinsic=k, depth_max=dmax,
                                        inverse_error=True)
    cam_err = cam_margin(mats, dims)
    pairs = at_plane = 0
    cam_ratio = 0.0
    for i in range(v):
        a, pix = P._project(mats[i], depths[i], fx, fy, cx, cy, coords, torch.tensor(dmin), torch.tensor(dmax),
                            torch.tensor(vs))
        idx = torch.nonzero(a).flatten()
        grid = torch.stack([t[idx] for t in coords], 1)
        inside = ((grid >= first[i][pix[idx]]) & (grid <= last[i][pix[idx]])).all(1)
        assert bool(inside.all()), f"view {i}: an accepting voxel outside its pixel's slab"
        cam32 = torch.stack([((mats[i, r, 0] * grid[:, 0] + mats[i, r, 1] * grid[:, 1]) + mats[i, r, 2] * grid[:, 2])
                             + mats[i, r, 3] for r in range(3)], 1)
        cam64 = grid.double() @ mats[i, :, :3].double().T + mats[i, :, 3].double()
        if idx.numel():
            cam_ratio = max(cam_ratio, float((cam32.double() - cam64).abs().max()) / float(cam_err[i]))
        pairs += idx.numel()
        at_plane += int((depths[i].reshape(-1)[pix[idx]] - vs - P.CULL_EPS <= 0).sum())
    sizes = (last - first + 1).clamp(min=0).prod(-1)
    # a few voxels a pixel, not the grid
    assert pairs > 100 and float(sizes[sizes > 0].float().mean()) < mean_box, float(sizes[sizes > 0].float().mean())
    assert cam_ratio < 0.25 and inv_ratio < 0.25, (cam_ratio, inv_ratio)
    return at_plane


@pytest.mark.parametrize("depth_min", [0.0, DMIN])
def test_k3b_pixel_slabs_hold_every_accepting_voxel(depth_min):
    """Every (voxel, view) pair that accepts lies in the slab box of its
    pixel, the box K3b's pass 1 searches (``_check_slabs``): cameras inside
    the grid at random angles, depths down to 2 cm, and with depth_min 0
    slabs that reach the camera plane."""
    rng = np.random.RandomState(int(depth_min * 10) + 5)
    at_plane = _check_slabs(*_slab_setup("near_camera", rng, depth_min))
    if depth_min == 0.0:
        assert at_plane > 0  # slabs that reach the camera plane were exercised


@pytest.mark.parametrize("name", ["sheared", "uneven"])
def test_k3b_pixel_slabs_hold_for_any_invertible_grid(name):
    """``_check_slabs`` where world_to_grid is sheared or scaled unevenly,
    so that each view's 3x3 is no rotation times a uniform scale: pass 1's
    inverse-map margin, widened by the square of the 3x3's condition number
    (``margin_scales``), keeps every accepting voxel in its box and the
    inverse's float error under a quarter of it."""
    setup = _slab_setup(name, np.random.RandomState(sum(map(ord, name))))
    mats = P.view_matrices(np.asarray(setup[5], np.float32), np.asarray(setup[6], np.float32))
    assert float(P.margin_scales(mats).min()) > 30  # well outside the rigid envelope
    # a slab is no longer near a box of the grid's axes: boxes of up to 200 voxels, of the grid's 14,848
    _check_slabs(*setup, mean_box=200)


@pytest.mark.parametrize("name", ["scene", "train"])
def test_k3b_pixel_slabs_hold_on_the_shipped_grids(name):
    """``_check_slabs`` on every voxel of the shipped color scene's and
    training call's grids, with their voxel sizes, offsets and intrinsics."""
    _check_slabs(*_slab_setup(name, np.random.RandomState(sum(map(ord, name)))))


@pytest.mark.parametrize("rows_held", [KROWS, 1])
@pytest.mark.parametrize("case", ["plateaus", "negative", "invalid_views"])
def test_k3b_algorithm_matches_plain_gradient(case, rows_held):
    """The emulated passes == ``fuse_views_backward_plain`` within 1e-5 of
    the largest gradient (the order of the sums), on cameras inside the grid
    with exact-zero and plateau features; it exercises ties at 0 between
    views that accept a voxel with a 0 feature and views K3's cull drops for
    its brick, and counting those views is what makes it right. Each
    accepting view's row is read once, and again only where a voxel has more
    accepting views than the rows held (1 row held: many) and its row met or
    raised the running max."""
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
    got, keep, zero_ties, reads, accepted, earlier = k3b_emulated(g, feats, depths, poses, w2g, EDIMS, valid,
                                                         rows_held=rows_held)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    # not vacuous: voxels tie at 0 in bricks that culled a valid view
    assert zero_ties > 10
    # each accepting view's row read once, and again only in an earlier round's marked rows
    assert accepted <= reads <= accepted + earlier and (reads > accepted) == (earlier > 0)
    assert earlier > 0 or rows_held == KROWS
    # and those culled views matter: leaving them out of the zero count is wrong (the reads do not change it)
    if rows_held == KROWS:
        wrong = k3b_emulated(g, feats, depths, poses, w2g, EDIMS, valid, count_culled=False)[0]
        assert float((wrong - want).abs().max()) > 1e-3 * float(want.abs().max())
