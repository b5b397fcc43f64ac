"""Port's box math and anchors against the JAX package's, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dsis.geometry import anchors as jax_anchors
from tpu3dsis.geometry import boxes as jax_boxes
from tpu3dsis_torch.geometry import anchors, boxes


def _rand_boxes(rng, n, scale):
    lo = rng.uniform(-5, scale, (n, 3))
    hi = lo + rng.uniform(0.5, scale / 2, (n, 3))
    return np.concatenate([lo, hi], 1).astype(np.float32)


def test_bbox_transform_inv_per_class_blocks():
    rng = np.random.RandomState(0)
    rois = _rand_boxes(rng, 200, 90.0)
    deltas = (rng.randn(200, 19 * 6) * 0.3).astype(np.float32)  # K = 19 blocks
    want = np.asarray(jax_boxes.bbox_transform_inv(jnp.asarray(rois), jnp.asarray(deltas)))
    got = boxes.bbox_transform_inv(torch.from_numpy(rois), torch.from_numpy(deltas)).numpy()
    # Each coordinate is pc -/+ 0.5 * pw with pw = exp(d) * w. XLA's exp and
    # torch's may round apart by an ulp, which the sum carries as a few
    # float32 ulps of its largest intermediate |pc| + 0.5 |pw| (not of the
    # result, which can cancel to near 0): allow 4 such ulps per coordinate.
    w = (rois[:, 3:] - rois[:, :3]).astype(np.float64)
    d = deltas.reshape(200, 19, 6).astype(np.float64)
    pc = d[..., :3] * w[:, None] + (rois[:, :3] + 0.5 * w)[:, None]
    scale = np.abs(pc) + 0.5 * np.abs(np.exp(d[..., 3:]) * w[:, None])  # (200, K, 3)
    scale = np.concatenate([scale[..., a % 3] for a in range(6)], axis=1)  # the output's [x0 (K), y0 (K), ...]
    tol = 4 * np.spacing(scale.astype(np.float32))
    assert got.shape == want.shape == tol.shape
    assert (np.abs(got - want) <= tol).all(), float((np.abs(got - want) / tol).max())


def test_clip_boxes():
    rng = np.random.RandomState(1)
    b = _rand_boxes(rng, 300, 120.0) - 10.0
    want = np.asarray(jax_boxes.clip_boxes(jnp.asarray(b), (96, 48, 96)))
    got = boxes.clip_boxes(torch.from_numpy(b), (96, 48, 96)).numpy()
    np.testing.assert_array_equal(got, want)


def test_nms_overlap_plus_one_extents():
    rng = np.random.RandomState(2)
    a = _rand_boxes(rng, 64, 40.0)
    q = _rand_boxes(rng, 48, 40.0)
    want = np.asarray(jax_boxes.nms_overlap(jnp.asarray(a), jnp.asarray(q)))
    got = boxes.nms_overlap(torch.from_numpy(a), torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    batched = boxes.nms_overlap(torch.from_numpy(np.stack([a, a])), torch.from_numpy(np.stack([q, q])))
    np.testing.assert_array_equal(batched.numpy()[1], got)


@pytest.mark.parametrize("scene_shape", [(96, 48, 96), (32, 16, 32)])
@pytest.mark.parametrize("anchor_file", ["scannet14_3.txt", "scannet14_11.txt"])
def test_anchors_match(scene_shape, anchor_file):
    path = f"experiments/anchors/{anchor_file}"
    feat = tuple(s // 4 for s in scene_shape)
    want = jax_anchors.generate_level_anchors(path, feat, 4)
    got = anchors.generate_level_anchors(path, feat, 4)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        anchors.anchors_inside_mask(got, scene_shape),
        jax_anchors.anchors_inside_mask(want, scene_shape),
    )
