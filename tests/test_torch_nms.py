"""Port's greedy 3D NMS (plain version of kernel K2) against the JAX
package's tiled ``nms_mask``, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dsis.ops.nms import nms_mask as jax_nms_mask
from tpu3dsis_torch.ops import nms


def _boxes(rng, n, scale=60.0):
    """Score-sorted boxes with heavy overlap, sizes 1-20 voxels."""
    lo = rng.uniform(0, scale, (n, 3))
    hi = lo + rng.uniform(1, 20, (n, 3))
    return np.concatenate([lo, hi], 1).astype(np.float32)


@pytest.mark.parametrize("thresh", [0.1, 0.35])
def test_plain_matches_jax_nms_mask(thresh):
    """N = 300 spans several tiles of the JAX version (tile 128) and of K2
    (tile 64); invalid boxes sit inside and across tile boundaries."""
    rng = np.random.RandomState(0)
    b = _boxes(rng, 300)
    valid = rng.rand(300) > 0.15
    valid[250:] = False
    want = np.asarray(jax_nms_mask(jnp.asarray(b), thresh, jnp.asarray(valid)))
    got = nms.nms_mask_plain(torch.from_numpy(b), thresh, torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()
    np.testing.assert_array_equal(
        nms.nms_mask_plain(torch.from_numpy(b), thresh).numpy(),
        np.asarray(jax_nms_mask(jnp.asarray(b), thresh)),
    )


def test_batched_equals_per_sample_and_cpu_dispatch():
    rng = np.random.RandomState(1)
    b = np.stack([_boxes(rng, 130) for _ in range(3)])
    valid = rng.rand(3, 130) > 0.1
    got = nms.nms_mask(torch.from_numpy(b), 0.1, torch.from_numpy(valid))
    assert got.shape == (3, 130)
    for i in range(3):
        want = np.asarray(jax_nms_mask(jnp.asarray(b[i]), 0.1, jnp.asarray(valid[i])))
        np.testing.assert_array_equal(got[i].numpy(), want)
    assert nms.nms3d_cuda.launches == 0
    with pytest.raises(ValueError):
        nms.nms3d_cuda(torch.from_numpy(b), 0.1)


@pytest.mark.parametrize("thresh", [0.1, 0.25])
def test_class_aware_plain_matches_jax_nms_mask(thresh):
    """The stitch NMS's class-aware mode: N = 300 over 4 classes (several of
    the JAX version's 128-box tiles), invalid boxes inside and across tile
    boundaries; suppression only within a class, IoU on the raw boxes."""
    rng = np.random.RandomState(2)
    b = _boxes(rng, 300, scale=30.0)
    valid = rng.rand(300) > 0.15
    valid[240:260] = False
    classes = rng.randint(1, 5, 300).astype(np.int32)
    want = np.asarray(jax_nms_mask(jnp.asarray(b), thresh, jnp.asarray(valid), classes=jnp.asarray(classes)))
    got = nms.nms_mask(torch.from_numpy(b), thresh, torch.from_numpy(valid), classes=torch.from_numpy(classes))
    np.testing.assert_array_equal(got.numpy(), want)
    agnostic = nms.nms_mask_plain(torch.from_numpy(b), thresh, torch.from_numpy(valid)).numpy()
    assert got.sum() > agnostic.sum()  # other classes no longer suppress
    batched = nms.nms_mask_plain(torch.from_numpy(np.stack([b, b])), thresh, torch.from_numpy(np.stack([valid] * 2)),
                                 torch.from_numpy(np.stack([classes, classes])))
    np.testing.assert_array_equal(batched.numpy()[1], want)
    with pytest.raises(ValueError):
        nms.nms3d_cuda(torch.from_numpy(b), thresh, classes=torch.from_numpy(classes))
