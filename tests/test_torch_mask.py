"""The port's mask FCN and halo-window planners against the JAX package's, on
the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dsis.models.backbones import MaskBackboneArch
from tpu3dsis.ops import mask_windows as jax_mw
from tpu3dsis_torch import load_jax_params
from tpu3dsis_torch.models.backbones import MaskBackbone
from tpu3dsis_torch.ops import mask_windows as mw

CANVAS = 16


@pytest.fixture(scope="module")
def mask_pair():
    from __graft_entry__ import _scannet_cfg

    arch = MaskBackboneArch(_scannet_cfg())
    shapes = jax.eval_shape(arch.init_params, jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    params = {k: (rng.uniform(-1, 1, v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
              for k, v in sorted(shapes.items())}
    port = MaskBackbone(19, device="cpu")
    load_jax_params(port, {k[len("mask_backbone."):]: v for k, v in params.items()})
    return arch, params, port


@pytest.mark.parametrize("with_region", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_mask_backbone_matches_jax(mask_pair, with_region, training):
    """fp32, 16^3 canvas, logits and sigmoid; the region is re-applied after
    every conv. atol = rtol = 1e-4: the two frameworks sum each conv in
    another order."""
    arch, params, port = mask_pair
    rng = np.random.RandomState(4)
    scene = rng.randn(2, CANVAS, CANVAS, CANVAS, 2).astype(np.float32)
    region = None
    if with_region:
        ix = np.arange(CANVAS)
        lo, hi = (3, 5, 2), (11, 14, 9)
        box = ((ix[:, None, None] >= lo[0]) & (ix[:, None, None] < hi[0]) & (ix[None, :, None] >= lo[1])
               & (ix[None, :, None] < hi[1]) & (ix[None, None, :] >= lo[2]) & (ix[None, None, :] < hi[2]))
        region = np.broadcast_to(box[None, ..., None], (2, CANVAS, CANVAS, CANVAS, 1)).astype(np.float32)
        scene = scene * region
    want = arch.apply(params, jnp.asarray(scene), training=training,
                      region_mask=None if region is None else jnp.asarray(region))
    with torch.no_grad():
        got = port(torch.from_numpy(scene), None if region is None else torch.from_numpy(region), training=training)
    assert tuple(got.shape) == want.shape == (2, CANVAS, CANVAS, CANVAS, 19)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    if with_region and training:  # outside the region the logits are exactly 0
        assert not got.numpy()[~np.broadcast_to(box[None, ..., None], got.shape)].any()


def _planner_rois():
    return np.array(
        [
            [4, 4, 4, 84, 40, 90],  # oversize in x and z
            [10.5, 10, 10, 20, 20.5, 20],  # small, half-voxel corners (round half to even)
            [0, 0, 0, 96, 48, 96],  # the whole scene
            [-1e4, -1e4, -1e4, -1e4 + 1, -1e4 + 1, -1e4 + 1],  # far outside
            [40, 0, 88, 96, 7, 96],  # edge sliver
            [2.5, 3.5, 60, 70, 47.6, 95.4],
        ],
        np.float32,
    )


@pytest.mark.parametrize("case", ["halo", "single_window", "drop", "oversize_drop"])
def test_plan_windows_matches_jax(case):
    """Every output of the tensor planner equals the JAX planner's, padding
    slots included: halo windows with room for all, single windows on a
    small canvas, capacity below the roi count, and oversize rois dropped."""
    scene, canvas = (96, 48, 96), (64, 48, 64)
    rois = _planner_rois()
    valid = np.array([True, True, True, False, True, True])
    kw = {
        "halo": dict(capacity=24),
        "single_window": dict(capacity=6, single_window=True),
        "drop": dict(capacity=3, allow_drop=True),
        "oversize_drop": dict(capacity=7, allow_drop=True),
    }[case]
    if case == "single_window":
        canvas = (32, 32, 32)
        valid = valid & np.array([False, True, False, True, False, False])
    want = jax_mw.plan_windows(jnp.asarray(rois), jnp.asarray(valid), scene, canvas, **kw)
    got = mw.plan_windows(torch.from_numpy(rois), torch.from_numpy(valid), scene, canvas, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    if case == "oversize_drop":
        assert int(got["dropped"]) > 0
    with pytest.raises(ValueError):
        mw.plan_windows(torch.from_numpy(rois), torch.from_numpy(valid), scene, canvas, capacity=2)


def test_plan_windows_np_copy_matches_jax():
    rng = np.random.RandomState(0)
    scene = (96, 48, 96)
    boxes = list(_planner_rois())
    for _ in range(40):
        lo = rng.uniform(-3, 90, 3) * [1, 0.5, 1]
        boxes.append(np.concatenate([lo, lo + rng.uniform(0.4, 80, 3)]).astype(np.float32))
    for canvas in ((64, 48, 64), (32, 32, 32), (20, 20, 20)):
        for box in boxes:
            got, want = mw.plan_windows_np(box, scene, canvas), jax_mw.plan_windows_np(box, scene, canvas)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
    for s in (48, 96, 400):
        assert mw.windows_per_axis(s, 32) == jax_mw.windows_per_axis(s, 32)
    assert mw.HALO == jax_mw.HALO
    with pytest.raises(ValueError):
        mw.windows_per_axis(96, 12)


def test_mask_backbone_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaskBackbone(19)
    assert MaskBackbone(19, device="cpu").geometry[0].weight.device.type == "cpu"
