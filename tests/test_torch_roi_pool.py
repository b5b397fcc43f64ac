"""Port's RoI max-pool (plain version of kernel K1) against the JAX package's
Pallas kernel (interpret mode), its masked-reduction oracle and its
multi-level dispatch, on the CPU: one map per level, levels of one or of two
spatial shapes, and NaN voxels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dsis.ops.roi_pool3d import roi_pool3d_multilevel as jax_multilevel
from tpu3dsis.ops.roi_pool3d import roi_pool3d_reference
from tpu3dsis.ops.roi_pool3d_pallas import roi_pool3d_pallas
from tpu3dsis_torch.ops import roi_pool3d as rp

_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rois(rng, n):
    """Chunk-scale rois (the test_ops.py pattern) plus edge cases: rois past
    the volume (clamped and empty bins), thin rois (size clamped to 1, bins
    that repeat a voxel) and rois on the borders."""
    lo = rng.uniform(0, 90, (n, 3))
    hi = lo + rng.uniform(1, 60, (n, 3))
    rois = np.clip(np.concatenate([lo, hi], 1), 0, [96, 48, 96, 96, 48, 96])
    edge = np.array(
        [
            [100, 50, 100, 140, 80, 140],  # past the far corner: all bins empty
            [90, 40, 90, 140, 80, 140],  # across it: clamped and empty bins
            [-20, -8, -20, 6, 3, 6],  # before the near corner: clamped
            [10.5, 3.2, 7.9, 10.6, 3.3, 8.0],  # thinner than one voxel
            [0, 0, 0, 96, 48, 96],  # the whole chunk
            [0, 0, 0, 1, 1, 1],
            [95, 47, 95, 96, 48, 96],
            [17, 9, 33, 17, 9, 33],  # zero size
            [4, 44, 1, 9, 48, 95],
        ]
    )
    return np.concatenate([rois, edge]).astype(np.float32)


def _pool_one_level(feat, rois, dtype):
    """Port, single level and sample: (R, C, P, P, P) -> (R, P, P, P, C)."""
    out = rp.roi_pool3d(
        [torch.from_numpy(feat).to(dtype)[None]], torch.from_numpy(rois),
        torch.zeros(len(rois), dtype=torch.int32), torch.zeros(len(rois), dtype=torch.int32),
        [0.25], 4,
    )
    return out.permute(0, 2, 3, 4, 1).float().numpy()


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_plain_matches_pallas_and_reference(dtype):
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.RandomState(0)
    feat = rng.randn(24, 12, 24, 8).astype(np.float32)
    feat = np.array(jnp.asarray(feat).astype(jdt).astype(jnp.float32))  # exact in bf16
    rois = _rois(rng, 16)
    got = _pool_one_level(feat, rois, tdt)
    fj, rj = jnp.asarray(feat).astype(jdt), jnp.asarray(rois)
    pallas = np.asarray(roi_pool3d_pallas(fj, rj, 4, 0.25, interpret=True).astype(jnp.float32))
    oracle = np.asarray(roi_pool3d_reference(fj, rj, 4, 0.25).astype(jnp.float32))
    np.testing.assert_array_equal(pallas, oracle)
    np.testing.assert_array_equal(got, pallas)
    assert (got == 0).all(axis=(1, 2, 3, 4))[16]  # the roi past the volume


# level 2 at the level-1 shape, or at half of it with twice the stride
_LEVEL2 = {"same_shape": ((24, 12, 24), 0.25), "half_shape": ((12, 6, 12), 0.125)}


@pytest.mark.parametrize("level2", sorted(_LEVEL2))
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_multilevel_own_level_matches_jax(dtype, level2):
    """Each roi pooled on its own level only == the JAX pool-all-then-select,
    for a batch of two samples in one call, with one map per level."""
    jdt, tdt = _DTYPES[dtype]
    shape2, scale2 = _LEVEL2[level2]
    rng = np.random.RandomState(1)
    feats = [rng.randn(2, *shape, 8).astype(np.float32) for shape in ((24, 12, 24), shape2)]
    rois = np.stack([_rois(rng, 24) for _ in range(2)])
    levels = rng.randint(1, 3, rois.shape[:2]).astype(np.float32)
    got = rp.roi_pool3d_multilevel(
        [torch.from_numpy(f).to(tdt) for f in feats], torch.from_numpy(rois),
        torch.from_numpy(levels), 4, [0.25, scale2],
    )
    assert got.shape == (2, rois.shape[1], 8, 4, 4, 4) and got.dtype == tdt
    for b in range(2):
        want = jax_multilevel(
            tuple(jnp.asarray(f[b]).astype(jdt) for f in feats), jnp.asarray(rois[b]),
            jnp.asarray(levels[b]), 4, (0.25, scale2),
        )
        np.testing.assert_array_equal(
            got[b].permute(0, 2, 3, 4, 1).float().numpy(), np.asarray(want.astype(jnp.float32))
        )


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_nan_voxel_gives_nan_as_pallas_does(dtype):
    """A NaN voxel makes every bin that holds it NaN, in the plain version
    as in the Pallas kernel (``jnp.max`` propagates NaN); the rest agree."""
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.RandomState(3)
    feat = rng.randn(24, 12, 24, 8).astype(np.float32)
    feat[5, 3, 7, 2] = feat[20, 9, 2, 5] = np.nan
    feat[12, 6, 12, :] = np.nan
    rois = _rois(rng, 24)
    got = _pool_one_level(feat, rois, tdt)
    pallas = np.asarray(
        roi_pool3d_pallas(jnp.asarray(feat).astype(jdt), jnp.asarray(rois), 4, 0.25, interpret=True)
        .astype(jnp.float32)
    )
    nan = np.isnan(pallas)
    assert nan.any() and not nan.all(axis=(1, 2, 3, 4)).all()
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(np.where(nan, 0, got), np.where(nan, 0, pallas))


def test_out_of_range_index_gives_nan():
    """The plain version, as K1, marks a roi with a batch or level index out
    of range with NaN and reads nothing for it."""
    rng = np.random.RandomState(4)
    feats = [torch.from_numpy(rng.randn(2, 6, 3, 6, 4).astype(np.float32))]
    rois = torch.from_numpy(_rois(rng, 2)[:4])
    out = rp.roi_pool3d(feats, rois, torch.tensor([0, 2, 1, -1], dtype=torch.int32),
                        torch.tensor([0, 0, 1, 0], dtype=torch.int32), [0.25], 4)
    assert torch.isnan(out[1:]).all() and not torch.isnan(out[0]).any()


def test_cpu_dispatch_launches_no_kernel():
    before = rp.roi_pool3d_cuda.launches
    rng = np.random.RandomState(2)
    feat = rng.randn(6, 3, 6, 4).astype(np.float32)
    _pool_one_level(feat, _rois(rng, 4), torch.float32)
    assert rp.roi_pool3d_cuda.launches == before == 0
    with pytest.raises(ValueError):
        rp.roi_pool3d_cuda([torch.zeros(1, 2, 2, 2, 4)], torch.zeros(1, 6), torch.zeros(1, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32), [0.25], 4)
