"""The port's spatial sharding and tile parallelism against the JAX
package's, on the CPU.

(a) ``halo_exchange``'s edges (``tests/test_spatial_sharding.py``'s check);
(b) ``spatial_features`` on 2 and 4 shards of the CPU against the JAX
package's on as many XLA host devices (``tests/conftest.py`` makes 8),
within 1e-5 of the largest value, and against the port's unsharded
backbone; (c) ``spatial_single_shot`` against the JAX package's: boxes
within 1e-4 voxels, the same classes; (d) ``SceneInference`` with a list of
four CPU devices: bit for bit one device's result at a quarter of the
batch (detections and masks, also with a window count the device count
does not divide), and the
JAX package's 4-device mesh result under ``tests/test_torch_scene.py``'s
bars. The tiny config and shapes of ``tests/test_spatial_sharding.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_scene import TORCH_THREADS, _assert_same, _numpy_params, _scene, _small_cfg

from tpu3dsis.infer import tiling as jax_tiling
from tpu3dsis.models import Detector as JaxDetector
from tpu3dsis.parallel import spatial_features as jax_spatial_features
from tpu3dsis.parallel import scene as jax_scene
from tpu3dsis_torch import Detector, DetectorConfig, SceneInference, load_jax_params
from tpu3dsis_torch.parallel import halo_exchange, spatial_features
from tpu3dsis_torch.parallel.scene import spatial_single_shot
from tpu3dsis_torch.parallel.spatial import replicas


class _Jitted:
    """The JAX package's detector with its stages jitted, and its
    ``spatial_features`` and ``select_proposals`` as ``spatial_single_shot``
    calls them: op by op, its single-shot scene takes about 20 s on the CPU
    for what jitted takes 3. The functions are the JAX package's own."""

    def __init__(self, det):
        self.det = det

    def __getattr__(self, name):
        return getattr(self.det, name)

    def rpn_forward(self, params, feats):
        return jax.jit(self.det.rpn_forward)(params, feats)

    def classify_rois(self, params, feats, rois, level_inds):
        return jax.jit(self.det.classify_rois)(params, feats, rois, level_inds)

    def decode_test_boxes(self, rois, cls_pred, cls_prob, bbox_pred, shape):
        return jax.jit(lambda *a: self.det.decode_test_boxes(*a, shape))(rois, cls_pred, cls_prob, bbox_pred)


def _jax_spatial_features(det, params, scene, mesh, axis="space"):
    return jax.jit(lambda p, s: jax_spatial_features(det, p, s, mesh, axis))(params, scene)


def _jax_spatial_single_shot(jdet, cfg, params, scene, mesh, monkeypatch):
    select = jax_scene.select_proposals
    monkeypatch.setattr(jax_scene, "spatial_features", _jax_spatial_features)
    monkeypatch.setattr(jax_scene, "select_proposals", lambda rpn_out, *a: jax.jit(lambda r: select(r, *a))(rpn_out))
    return jax_scene.spatial_single_shot(_Jitted(jdet), cfg, params, scene, mesh)


@pytest.fixture(scope="module")
def detectors():
    """The conftest's ScanNet config (fixed TEST sizes for the single-shot
    scene) in both packages, with the same numpy-drawn weights; the port on
    ``TORCH_THREADS`` threads while the module's tests run."""
    from __graft_entry__ import _scannet_cfg

    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    cfg = _scannet_cfg()
    cfg.TEST.RPN_PRE_NMS_TOP_N = 128
    cfg.TEST.RPN_POST_NMS_TOP_N = 16
    cfg.CLASS_THRESH = 0.0
    jdet = JaxDetector(cfg, anchor_dir="experiments/anchors")
    params = _numpy_params(jdet, 0)
    tcfg = DetectorConfig.from_cfg(cfg)
    tdet = load_jax_params(Detector(tcfg, device="cpu"), params)
    yield cfg, jdet, params, tcfg, tdet
    torch.set_num_threads(threads)


def test_halo_exchange_edges():
    """Interior halos carry the neighbours' edge slabs, the grid's ends
    zeros; each shard keeps its own voxels in between."""
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 1, 16, 2, 2).astype(np.float32))
    shards = list(x.chunk(4, dim=2))
    out = halo_exchange(shards)
    assert [tuple(o.shape) for o in out] == [(1, 1, 6, 2, 2)] * 4
    assert not out[0][:, :, 0].any() and not out[3][:, :, 5].any()
    for s in range(4):
        assert torch.equal(out[s][:, :, 1:5], shards[s])
        if s > 0:
            assert torch.equal(out[s][:, :, 0], shards[s - 1][:, :, 3])
        if s < 3:
            assert torch.equal(out[s][:, :, 5], shards[s + 1][:, :, 0])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_spatial_features_match_jax(detectors, n_shards):
    _, jdet, params, _, tdet = detectors
    scene = np.random.RandomState(n_shards).randn(32 * n_shards, 16, 32, 2).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("space",))
    want = _jax_spatial_features(jdet, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(scene), mesh)
    got = spatial_features(tdet, torch.from_numpy(scene), ["cpu"] * n_shards)
    with torch.inference_mode():
        whole = tdet.features(torch.from_numpy(scene)[None])
    for lvl in (1, 2):
        w = np.asarray(want[lvl])
        assert tuple(got[lvl].shape) == w.shape and got[lvl].is_contiguous()  # K1 reads it as it is
        scale = np.abs(w).max()
        assert np.abs(got[lvl].numpy() - w).max() <= 1e-5 * scale, lvl
        assert float((got[lvl] - whole[lvl]).abs().max()) <= 1e-5 * scale, lvl


@pytest.mark.parametrize("n_shards", [2, 4])
def test_spatial_single_shot_matches_jax(detectors, n_shards, monkeypatch):
    cfg, jdet, params, tcfg, tdet = detectors
    scene = np.random.RandomState(7).randn(64, 16, 48, 2).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("space",))
    want = _jax_spatial_single_shot(jdet, cfg, {k: jnp.asarray(v) for k, v in params.items()}, scene, mesh,
                                    monkeypatch)
    got = spatial_single_shot(tdet, tcfg, scene, ["cpu"] * n_shards)
    assert got["pred_class"].dtype == np.int32 and len(got["pred_box"]) == len(want["pred_box"]) > 0
    np.testing.assert_array_equal(got["pred_class"], want["pred_class"])
    np.testing.assert_allclose(got["pred_box"], want["pred_box"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["pred_conf"], want["pred_conf"], rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="first device"):
        spatial_single_shot(tdet, tcfg, scene, ["meta", "cpu"])


@pytest.fixture(scope="module")
def scene_pair():
    """``tests/test_torch_scene.py``'s small-tile scene setup: the JAX
    detector and params, the port's detector with the same weights."""
    from __graft_entry__ import _scannet_cfg

    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    cfg = _small_cfg(_scannet_cfg())
    jdet = JaxDetector(cfg, anchor_dir="experiments/anchors")
    params = _numpy_params(jdet, 0)
    tcfg = DetectorConfig.from_cfg(cfg)
    yield cfg, jdet, params, tcfg, load_jax_params(Detector(tcfg, device="cpu"), params)
    torch.set_num_threads(threads)


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_tile_parallel_scene_matches_one_device_and_jax_mesh(scene_pair):
    """Four CPU devices, tile batches of 8 (9 tiles: a batch of 8 split 2,
    2, 2, 2 over the devices, then one of 1): the fused path's detections
    and masks (each window queue split in four) equal one device's at tile
    batches of 2 bit for bit, and the JAX package's 4-device mesh result;
    three boxes' masks in batches of 4 large and 16 small windows, split
    over the devices, equal one device's in batches of 1 and 4 too. The CPU
    named four times holds the weights once; a list naming other devices
    holds one replica a device."""
    cfg, jdet, params, tcfg, tdet = scene_pair
    scene = _scene(5)
    one = SceneInference(tdet, tcfg, tile_batch=2)
    four = SceneInference(tdet, tcfg, tile_batch=8, mesh=["cpu"] * 4)
    assert four._deal(9, 8) == [(0, 0, 2), (1, 2, 4), (2, 4, 6), (3, 6, 8), (0, 8, 9)]
    assert four._deal(3, 3) == [(0, 0, 1), (1, 1, 2), (2, 2, 3)]
    assert SceneInference(tdet, tcfg, tile_batch=6, mesh=["cpu"] * 4).tile_batch == 8
    assert len(four._replicas) == 4 and all(r is tdet for r in four._replicas)
    lin = torch.nn.Linear(2, 2)
    reps = replicas(lin, [torch.device(d) for d in ("cpu", "meta", "meta")])
    assert reps[0] is lin and reps[1] is reps[2] and reps[1].weight.device.type == "meta"
    det1, masks1 = one.infer(scene)
    det4, masks4 = four.infer(scene)
    assert one.last_fused and four.last_fused
    _equal(det4, det1)
    assert len(masks4) == len(masks1) and all(np.array_equal(a, b) for a, b in zip(masks4, masks1))
    assert sum(m.sum() for m in masks4) > 0
    _equal(four.detect(scene), one.detect(scene))

    jsi = jax_tiling.SceneInference(jdet, cfg, tile_batch=8, mesh=Mesh(np.array(jax.devices()[:4]), ("tiles",)))
    want = jsi.detect(params, scene)
    few = {k: v[:3] for k, v in want.items()}
    _assert_same(det4, masks4, want, jsi.predict_masks(params, scene, want))

    got1 = one.predict_masks(scene, {k: v[:3] for k, v in det1.items()}, batch=1)
    got4 = four.predict_masks(scene, {k: v[:3] for k, v in det4.items()}, batch=4)
    assert len(got4) == 3 and all(np.array_equal(a, b) for a, b in zip(got4, got1))
    _assert_same({k: v[:3] for k, v in det4.items()}, got4, few, jsi.predict_masks(params, scene, few))
    with pytest.raises(ValueError, match="detector's"):
        SceneInference(tdet, tcfg, mesh=["meta"])
