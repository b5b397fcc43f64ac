"""The port's whole-scene inference against the JAX package's, on the CPU.

(a) tile origins, padding and the scene configuration; (b) the port's fused
``SceneInference.infer`` against the JAX package's ``detect`` +
``predict_masks`` with the same weights (the setup of
``tests/test_tiling.py::test_fused_matches_multidispatch``); (c) the port's
``infer`` against its own host-planned path, with every overflow forced, and
independent of the tile batch and of prefetching.
"""

import importlib.util

import jax
import numpy as np
import pytest
import torch

from tpu3dsis.infer import tiling as jax_tiling
from tpu3dsis.models import Detector as JaxDetector
from tpu3dsis_torch import (Detector, DetectorConfig, ProposalConfig, SceneInference, load_jax_params,
                            scannet_scene_config)
from tpu3dsis_torch.infer import tiling

# mask flips allowed at the sigmoid threshold: the JAX test's own bar
# (test_tiling.py:312), for two frameworks that sum each conv in another order
MASK_FLIPS = 0.005
# Box corners to 1e-4 voxels, confidences to rtol 1e-5. The CPU's conv
# library splits its sums by thread, so the port runs on a fixed number of
# threads here (``pair``): the same result on every host and under any load.
BOX_ATOL, CONF_RTOL = 1e-4, 1e-5
TORCH_THREADS = 4


def _small_cfg(cfg):
    cfg = cfg.copy()
    cfg.TPU_TILE_SIZE = [48, 48, 48]
    cfg.TPU_TILE_STRIDE = [36, 36, 36]
    cfg.TEST.RPN_PRE_NMS_TOP_N = 64
    cfg.TEST.RPN_POST_NMS_TOP_N = 8
    cfg.CLASS_THRESH = 0.0  # untrained net: accept everything valid
    # mask canvases cut to keep the FCN's CPU time small; 24 > 2 x HALO
    cfg.TPU_MASK_INFER_CANVAS = [24, 24, 24]
    cfg.TPU_MASK_INFER_CANVAS_SMALL = [16, 16, 16]
    return cfg


def _numpy_params(jdet, seed):
    """Every param of the JAX detector, drawn with numpy as torch's default
    init draws them: U(+-1/sqrt(fan_in)) for a layer's weight and bias."""
    shapes = jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = {}
    for name in sorted(shapes):
        fan_in = int(np.prod(shapes[name.rsplit(".", 1)[0] + ".weight"].shape[:-1]))
        params[name] = (rng.uniform(-1, 1, shapes[name].shape) / np.sqrt(fan_in)).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def pair():
    """JAX detector + params, and the port's detector on the CPU with the
    same weights (mask head included), on the small tiles; the port on
    ``TORCH_THREADS`` threads while the module's tests run."""
    from __graft_entry__ import _scannet_cfg

    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    cfg = _small_cfg(_scannet_cfg())
    jdet = JaxDetector(cfg, anchor_dir="experiments/anchors")
    params = _numpy_params(jdet, 0)
    tcfg = DetectorConfig.from_cfg(cfg)
    tdet = load_jax_params(Detector(tcfg, device="cpu"), params)
    yield cfg, jdet, params, tcfg, tdet
    torch.set_num_threads(threads)


def _scene(seed, shape=(60, 48, 60)):
    return np.random.RandomState(seed).randn(*shape, 2).astype(np.float32)


def _assert_same(got_det, got_masks, want_det, want_masks):
    assert len(got_det["pred_box"]) == len(want_det["pred_box"]) > 0
    np.testing.assert_array_equal(got_det["pred_class"], want_det["pred_class"])
    np.testing.assert_allclose(got_det["pred_box"], want_det["pred_box"], atol=BOX_ATOL, rtol=0)
    np.testing.assert_allclose(got_det["pred_conf"], want_det["pred_conf"], rtol=CONF_RTOL, atol=0)
    assert len(got_masks) == len(want_masks)
    for a, b in zip(got_masks, want_masks):
        assert a.shape == b.shape and a.dtype == np.uint8
        if a.size:
            assert (a != b).mean() < MASK_FLIPS


@pytest.mark.parametrize("extent", [48, 60, 96, 97, 240, 400])
def test_tile_origins_and_pad_volume_match_jax(extent):
    for tile, stride in ((96, 43), (48, 9), (48, 36)):
        assert tiling.tile_origins(extent, tile, stride) == jax_tiling.tile_origins(extent, tile, stride)
    data = np.random.RandomState(extent).rand(min(extent, 70), 30, 50, 2).astype(np.float32)
    for shape in ((96, 48, 96), (48, 48, 48)):
        np.testing.assert_array_equal(tiling.pad_volume(data.copy(), shape), jax_tiling.pad_volume(data.copy(), shape))


def test_scene_config_is_bench_masked_scene():
    """``scannet_scene_config()`` is what ``bench.py::bench_masked_scene``
    builds: ``tiling_parity_check.build_cfg`` on benchmark.yml, USE_MASK."""
    spec = importlib.util.spec_from_file_location("tiling_parity_check", "tools/tiling_parity_check.py")
    tpc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tpc)
    cfg = tpc.build_cfg(steps=700, lr=0.003)
    cfg.USE_MASK = True
    assert DetectorConfig.from_cfg(cfg) == scannet_scene_config()
    cfg.MASK_USE_IMAGES = True
    with pytest.raises(NotImplementedError):
        DetectorConfig.from_cfg(cfg)


def test_infer_matches_jax_detect_and_predict_masks(pair):
    """The port's fused path on the CPU == the JAX package's host-planned
    path: same count and classes, boxes and confidences to the bars above
    (float32 both sides; only the sum order differs)."""
    cfg, jdet, params, tcfg, tdet = pair
    scene = _scene(5)
    jsi = jax_tiling.SceneInference(jdet, cfg, tile_batch=2)
    want_det = jsi.detect(params, scene)
    want_masks = jsi.predict_masks(params, scene, want_det)
    si = SceneInference(tdet, tcfg, tile_batch=2)
    got_det, got_masks = si.infer(scene)
    assert si.last_fused
    _assert_same(got_det, got_masks, want_det, want_masks)
    assert sum(m.sum() for m in got_masks) > 0


def test_infer_matches_own_host_path_with_overflows(pair):
    """``infer`` == ``detect`` + ``predict_masks`` of the port: served by the
    fused path, then with a pre-NMS cap that overflows (the whole scene goes
    to the host path), and with a large-window queue of one (the short rois
    are redone on the host)."""
    _, _, _, tcfg, tdet = pair
    scene = _scene(6)
    si = SceneInference(tdet, tcfg, tile_batch=3)
    want_det = si.detect(scene)
    want_masks = si.predict_masks(scene, want_det)
    got = si.infer(scene)
    assert si.last_fused
    _assert_same(*got, want_det, want_masks)

    over = SceneInference(tdet, tcfg.replace(TPU_FUSED_PRE_NMS=8), tile_batch=3)
    got = over.infer(scene)
    assert not over.last_fused and over.host_path_scenes == 1 and si.host_path_scenes == 0
    _assert_same(*got, want_det, want_masks)

    # boxes larger than the small canvas: several halo windows each, more
    # than one large slot holds
    shorted = SceneInference(tdet, tcfg.replace(TPU_MASK_INFER_CANVAS_SMALL=(12, 12, 12),
                                                TPU_MASK_INFER_CANVAS=(20, 20, 20),
                                                TPU_FUSED_LARGE_WINDOWS=1), tile_batch=3)
    host_det = shorted.detect(scene)
    host_masks = shorted.predict_masks(scene, host_det)
    data, scene_dev = shorted._device_scene(scene)
    fused = tiling._to_host(shorted._fused(scene_dev, shorted._origins(data.shape[:3]), scene.shape[:3]))
    assert int(fused["mask_large"]["dropped"]) > 0
    got = shorted.infer(scene)
    assert shorted.last_fused
    _assert_same(*got, host_det, host_masks)


def test_results_independent_of_tile_batch_and_prefetch(pair):
    _, _, _, tcfg, tdet = pair
    scenes = [_scene(7 + i, (60, 40, 40)) for i in range(2)]  # 3 tiles each
    one = SceneInference(tdet, tcfg, tile_batch=1)
    want = [one.detect(s) for s in scenes]
    streamed = SceneInference(tdet, tcfg, tile_batch=4)
    streamed.prefetch_scene(scenes[0])
    for j, s in enumerate(scenes):
        if j + 1 < len(scenes):
            streamed.prefetch_scene(scenes[j + 1])
        got = streamed.detect(s)
        _assert_same(got, [], want[j], [])
    streamed.close()
    assert streamed.device_seconds(scenes[1], iters=1) > 0


def test_scene_inference_takes_no_mesh_or_frames(pair):
    _, _, _, tcfg, tdet = pair
    with pytest.raises(NotImplementedError):
        SceneInference(tdet, tcfg, mesh=object())
    si = SceneInference(tdet, tcfg)
    with pytest.raises(NotImplementedError):
        si.infer(_scene(0), frames={})
    cfg = tcfg.replace(TEST=ProposalConfig(8, 4, 0.1))
    assert SceneInference(Detector(cfg.replace(USE_MASK=False), device="cpu"), cfg).predict_masks(
        _scene(0), {"pred_box": np.zeros((1, 6), np.float32)}) == []


def test_scene_path_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Detector(scannet_scene_config())
    det = Detector(scannet_scene_config(), device="cpu")
    assert det.mask_backbone is not None and SceneInference(det, scannet_scene_config()).device.type == "cpu"
