"""The differentiable RoI max-pool of the port's training path, on the CPU.

The staged plain version (``roi_pool3d_staged_plain``) against the JAX
package's pool: its forward equals ``roi_pool3d_plain``, its gradient
equals ``jax.vjp`` of ``tpu3dsis.ops.roi_pool3d.roi_pool3d_multilevel``
(whose custom VJP differentiates the staged ``_pool_one``), on tie-free
features and on features with ties, one of which a joint ``amax`` over the
bin would split otherwise. Kernel K1b's algorithm (its bricks, kept rois
and columns, in numpy) against the staged plain gradient, and the CPU
dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dsis.ops.roi_pool3d import roi_pool3d_multilevel as jax_multilevel
from tpu3dsis_torch.ops import roi_pool3d as rp

SCALES = (0.25, 0.25)


def _rois(rng, n, extent=(32, 16, 32)):
    lo = rng.uniform(-4, np.asarray(extent) - 2, (n, 3))
    hi = lo + rng.uniform(0.5, 24, (n, 3))
    edge = np.array([[40, 20, 40, 60, 30, 60],  # past the far corner: every bin empty
                     [26, 12, 26, 40, 20, 40],  # across it: clamped and empty bins
                     [0, 0, 0, 32, 16, 32],  # the whole map
                     [5.5, 2.2, 7.9, 5.6, 2.3, 8.0]])  # thinner than a voxel
    return np.concatenate([lo, hi, ], 1).astype(np.float32), edge.astype(np.float32)


def _features(rng, kind, shape=(2, 8, 4, 8, 6)):
    f = rng.randn(*shape).astype(np.float32)
    if kind == "ties":  # post-ReLU zeros and quantised plateaus
        f = np.maximum(np.round(f * 2) / 2, 0).astype(np.float32)
    return f


def _port_grads(feats, rois, levels, g):
    tf = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    out = rp.roi_pool3d_multilevel(tf, torch.from_numpy(rois), torch.from_numpy(levels), 4, SCALES)
    out.backward(torch.from_numpy(g).permute(0, 1, 5, 2, 3, 4))
    return out.detach(), [t.grad.numpy() for t in tf]


@pytest.mark.parametrize("kind", ["tie_free", "ties"])
def test_staged_gradient_matches_jax_vjp(kind):
    """Two samples, two levels, 14 rois each with edge cases; float32."""
    rng = np.random.RandomState(0 if kind == "tie_free" else 1)
    feats = [_features(rng, kind), _features(rng, kind)]
    inner, edge = _rois(rng, 10)
    rois = np.stack([np.concatenate([inner, edge]), np.concatenate([edge, inner])])
    levels = rng.randint(1, 3, rois.shape[:2]).astype(np.float32)
    g = rng.randn(*rois.shape[:2], 4, 4, 4, 6).astype(np.float32)
    out, grads = _port_grads(feats, rois, levels, g)
    plain = rp.roi_pool3d_multilevel([torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
                                     torch.from_numpy(levels), 4, SCALES)
    assert torch.equal(out, plain)
    jgrads = [np.zeros_like(f) for f in feats]
    for b in range(2):
        fn = lambda *fs: jax_multilevel(fs, jnp.asarray(rois[b]), jnp.asarray(levels[b]), 4, SCALES)  # noqa: E731
        y, vjp = jax.vjp(fn, *[jnp.asarray(f[b]) for f in feats])
        np.testing.assert_array_equal(out[b].permute(0, 2, 3, 4, 1).numpy(), np.asarray(y))
        for lv, gj in enumerate(vjp(jnp.asarray(g[b]))):
            jgrads[lv][b] = np.asarray(gj)
    for got, want in zip(grads, jgrads):
        assert np.abs(want).max() > 0
        # 1e-6 of the largest share: only the order of the float32 sums differs
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_staged_rule_is_not_the_joint_split():
    """One bin, 2x2x1 voxels, three tied at the max: the staged rule gives
    g/4, g/4 to the row that ties twice and g/2 to the other row's max,
    as ``jax.vjp`` does; one ``amax`` over the bin would give g/3 each."""
    f = np.zeros((1, 2, 2, 1, 1), np.float32)
    f[0, :, 0, 0, 0] = [1.0, 1.0]  # row y=0: two tied maxima
    f[0, :, 1, 0, 0] = [1.0, 0.5]  # row y=1: one
    rois = np.array([[[0, 0, 0, 8, 8, 4]]], np.float32)  # 2x2x1 voxels at scale 1/4, P=1
    tf = torch.from_numpy(f).requires_grad_(True)
    out = rp.roi_pool3d_multilevel([tf], torch.from_numpy(rois), torch.ones(1, 1), 1, (0.25,))
    out.backward(torch.full_like(out, 12.0))
    want_staged = np.array([[3.0, 6.0], [3.0, 0.0]], np.float32)  # [x, y]
    np.testing.assert_array_equal(tf.grad[0, :, :, 0, 0].numpy(), want_staged)
    y, vjp = jax.vjp(lambda a: jax_multilevel((a,), jnp.asarray(rois[0]), jnp.ones(1), 1, (0.25,)),
                     jnp.asarray(f[0]))
    np.testing.assert_array_equal(np.asarray(vjp(jnp.full_like(y, 12.0))[0])[:, :, 0, 0], want_staged)
    joint = torch.from_numpy(f[0]).requires_grad_(True)
    joint[:, :, :1].amax(dim=(0, 1, 2)).backward(torch.full((1,), 12.0))
    assert not np.array_equal(joint.grad[:, :, 0, 0].numpy(), want_staged)


BRICK = (2, 4, 4)  # kBX, kBY, kBZ of csrc/roi_pool3d_bwd.cu


def k1b_emulated(feats, rois, bidx, lidx, scales, pooled, g, brick=BRICK):
    """K1b (``csrc/roi_pool3d_bwd.cu``) in float32 numpy, in its order. The
    column pass: each plane of a column's z-bins' union, its max over the
    column's rows of each row's x-max, and n_y; the plane's ct, the sum of
    g / n_z over the z-bins that hold it and whose max (from the planes) it
    ties, in z-bin order; ct / n_y. The brick pass:
    per level, sample and brick, the rois of that sample and level whose
    bins meet the brick, last to first, and for each the sum over its
    columns that meet the brick in the order autograd sums the plain
    version's stages: per px and brick row, the row's x-max and n_x, the
    sum over py of ct / n_y where the row ties the plane, divided by n_x,
    to the voxels that tie the row; then over px; then the roi's part is
    added to the brick. Each brick is written whole, its sums in float32
    rounded once; the output starts as NaN, so a voxel no brick writes
    shows."""
    grads = [np.full(f.shape, np.nan, np.float32) for f in feats]
    bx, by, bz = brick
    for lv, f in enumerate(feats):
        nb, w, h, l, nc = f.shape
        s = torch.tensor(scales[lv], dtype=torch.float32)
        r = torch.from_numpy(rois)
        lo = torch.floor(r[:, :3] * s).to(torch.int32)
        hi = torch.ceil(r[:, 3:] * s).to(torch.int32)
        axes = [[t.numpy() for t in rp._bin_bounds(lo[:, d], hi[:, d], pooled, e)] for d, e in enumerate((w, h, l))]
        mine = [m for m in range(rois.shape[0]) if lidx[m] == lv and 0 <= bidx[m] < nb]
        fy = np.zeros((rois.shape[0], pooled, pooled, l, nc), np.float32)  # column pass, by absolute z
        gy = np.zeros_like(fy)
        for m in mine:
            (xs, xe), (ys, ye), (zs, ze) = ((st[m], en[m]) for st, en in axes)
            for px, py in np.ndindex(pooled, pooled):
                if xe[px] <= xs[px] or ye[py] <= ys[py]:
                    continue
                fx = f[bidx[m], xs[px]:xe[px], ys[py]:ye[py], zs[0]:ze[-1]].astype(np.float32).max(0)
                fy[m, px, py, zs[0]:ze[-1]] = fx.max(0)
                ny = (fx == fx.max(0)).sum(0).astype(np.float32)
                ct = np.zeros_like(ny)
                for z in range(zs[0], ze[-1]):
                    for pz in range(pooled):
                        if zs[pz] <= z < ze[pz]:
                            planes = fy[m, px, py, zs[pz]:ze[pz]]
                            gz = g[m, :, px, py, pz] / (planes == planes.max(0)).sum(0).astype(np.float32)
                            ct[z - zs[0]] += np.where(fy[m, px, py, z] == planes.max(0), gz, np.float32(0))
                gy[m, px, py, zs[0]:ze[-1]] = ct / ny
        for b in range(nb):
            fb = f[b].astype(np.float32)
            for x0, y0, z0 in np.ndindex(-(-w // bx), -(-h // by), -(-l // bz)):
                x0, y0, z0 = x0 * bx, y0 * by, z0 * bz
                x1, y1, z1 = min(x0 + bx, w), min(y0 + by, h), min(z0 + bz, l)
                tile = np.zeros((x1 - x0, y1 - y0, z1 - z0, nc), np.float32)
                for m in reversed(mine):  # last to first, as autograd accumulates the plain version's rois
                    if bidx[m] != b:
                        continue
                    (xs, xe), (ys, ye), (zs, ze) = ((st[m], en[m]) for st, en in axes)
                    if ze[-1] <= zs[0] or zs[0] >= z1 or ze[-1] <= z0:
                        continue  # the z-bins' union misses the brick
                    pxs = [p for p in range(pooled) if xe[-1] > xs[0] and xe[p] > x0 and xs[p] < x1]
                    pys = [p for p in range(pooled) if ye[-1] > ys[0] and ye[p] > y0 and ys[p] < y1]
                    part = np.zeros_like(tile)  # the roi's shares: over py into the row's x-max, / n_x, over px
                    for px in pxs:
                        sx, ex = xs[px], xe[px]
                        if ex <= sx:
                            continue
                        for y, z in ((y, z) for y in range(y0, y1) for z in range(max(z0, zs[0]), min(z1, ze[-1]))):
                            row = fb[sx:ex, y, z]
                            fx = row.max(0)
                            t = np.zeros(nc, np.float32)
                            for py in pys:
                                if ye[py] > ys[py] and ys[py] <= y < ye[py]:
                                    t += np.where(fx == fy[m, px, py, z], gy[m, px, py, z], np.float32(0))
                            for x in range(max(sx, x0), min(ex, x1)):
                                part[x - x0, y - y0, z - z0] += np.where(
                                    fb[x, y, z] == fx, t / (row == fx).sum(0).astype(np.float32), np.float32(0))
                    tile += part
                grads[lv][b, x0:x1, y0:y1, z0:z1] = tile
    return grads


def _many_rois(rng, n=70):
    """n rois of sample 0, level 0, each overlapping the brick at voxels
    [0, 2) x [0, 4) x [0, 4) of (2, 8, 4, 8, 6) maps at scale 1/4: far more
    columns than a block stages at a time."""
    lo = rng.uniform(-2, 6, (n, 3))
    return np.concatenate([lo, lo + rng.uniform(4, 20, (n, 3))], 1).astype(np.float32)


@pytest.mark.parametrize("kind", ["tie_free", "ties", "disjoint", "many_rois"])
def test_k1b_algorithm_matches_staged_plain(kind):
    """The emulated kernel == the plain version's gradient: within 1e-6 of
    the largest share (the order of the float32 sums), and bit for bit
    where no voxel lies in two bins; no voxel is left unwritten."""
    rng = np.random.RandomState(5)
    feats = [_features(rng, "ties" if kind in ("ties", "many_rois") else "tie_free", (2, 8, 4, 8, 6))
             for _ in range(2)]
    if kind == "disjoint":  # one roi a sample, bins of 2x1x2 voxels
        rois = np.array([[0, 0, 0, 32, 16, 32], [0, 0, 0, 32, 16, 32]], np.float32)
        bidx, lidx = np.array([0, 1]), np.array([0, 1])
    elif kind == "many_rois":  # 70 rois on one brick, and two on the other sample
        inner, edge = _rois(rng, 2)
        rois = np.concatenate([_many_rois(rng), inner])
        bidx = np.array([0] * 70 + [1, 1])
        lidx = np.array([0] * 70 + [0, 1])
    else:
        inner, edge = _rois(rng, 12)
        rois = np.concatenate([inner, edge])
        bidx, lidx = rng.randint(0, 2, len(rois)), rng.randint(0, 2, len(rois))
    g = rng.randn(len(rois), 6, 4, 4, 4).astype(np.float32)
    args = ([torch.from_numpy(f) for f in feats], torch.from_numpy(rois), torch.from_numpy(bidx.astype(np.int32)),
            torch.from_numpy(lidx.astype(np.int32)), SCALES, 4)
    want = [w.numpy() for w in rp.roi_pool3d_backward_plain(*args, torch.from_numpy(g))]
    got = k1b_emulated(feats, rois, bidx, lidx, SCALES, 4, g)
    for a, w in zip(got, want):
        assert not np.isnan(a).any(), "a gradient voxel was left unwritten"
        if kind == "disjoint":
            np.testing.assert_array_equal(a, w)
        else:
            np.testing.assert_allclose(a, w, rtol=0, atol=1e-6 * np.abs(w).max())


def test_cpu_gradient_path_launches_no_kernel():
    """On CPU tensors the gradient runs through the staged plain version;
    the kernels' wrappers refuse CPU tensors."""
    before = (rp.roi_pool3d_cuda.launches, rp.roi_pool3d_backward_cuda.launches)
    rng = np.random.RandomState(2)
    inner, _ = _rois(rng, 4)
    f = torch.from_numpy(_features(rng, "tie_free")).requires_grad_(True)
    out = rp.roi_pool3d([f], torch.from_numpy(inner), torch.zeros(4, dtype=torch.int32),
                        torch.zeros(4, dtype=torch.int32), [0.25], 4)
    out.sum().backward()
    assert f.grad is not None and f.grad.abs().sum() > 0
    assert (rp.roi_pool3d_cuda.launches, rp.roi_pool3d_backward_cuda.launches) == before == (0, 0)
    with pytest.raises(ValueError):
        rp.roi_pool3d_backward_cuda([f.detach()], torch.from_numpy(inner), torch.zeros(4, dtype=torch.int32),
                                    torch.zeros(4, dtype=torch.int32), [0.25], 4, torch.zeros(4, 6, 4, 4, 4))
