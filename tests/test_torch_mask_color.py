"""The port's color options against the JAX package's, on the CPU.

(a) the mask FCN's color and combine branches (``MASK_USE_IMAGES``, with
``MASK_ONLY_IMAGES``) against ``MaskBackboneArch.apply``, and the combinations
the JAX package cannot run refused; (b) the color-only backbone
(``ONLY_IMAGES``) of both nets against ``BackboneArch.apply``; (c) the new
weights' names in the checkpoint partitions; (d) the three served routes of
the masks (the fused program and the host-planned path on the resident color
volume, and the host-planned path fusing each window's own views) against
the JAX package's ``predict_masks`` on one small room, with every view
admitted so that the routes agree. The train step with ``MASK_USE_IMAGES``
and the ENet trained runs in ``tests/test_torch_train_mask_color.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scene import COLOR_VIEWS, DEPTH_WH, INTRINSIC, TORCH_THREADS, _frames, _numpy_params, _scene, \
    _small_cfg

from tpu3dsis.infer import tiling as jax_tiling
from tpu3dsis.models import Detector as JaxDetector
from tpu3dsis.models.backbones import BACKBONES as JAX_BACKBONES
from tpu3dsis.models.backbones import MaskBackboneArch
from tpu3dsis_torch import Detector, DetectorConfig, SceneInference, load_jax_params
from tpu3dsis_torch import checkpoint as ckpt
from tpu3dsis_torch.config import default_config
from tpu3dsis_torch.models.backbones import MaskBackbone

CANVAS = 12
# the two frameworks sum each conv in another order: 1e-5 of the largest output
TOL = 1e-5


def _params(shapes, seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.uniform(-1, 1, v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
            for k, v in sorted(shapes.items())}


def _mask_cfg(use, only):
    from __graft_entry__ import _scannet_cfg

    cfg = _scannet_cfg()
    cfg.MASK_USE_IMAGES, cfg.MASK_ONLY_IMAGES = use, only
    return cfg


@pytest.mark.parametrize("branches", ["geometry", "combine", "color_only"])
def test_mask_fcn_branches_match_jax(branches):
    """Every branch combination, logits (training) and sigmoid, with a
    region re-applied after every conv of every branch, within 1e-5 of the
    largest output; the weights load strictly under the JAX package's
    names."""
    use, only = {"geometry": (False, False), "combine": (True, False), "color_only": (True, True)}[branches]
    arch = MaskBackboneArch(_mask_cfg(use, only))
    params = _params(jax.eval_shape(arch.init_params, jax.random.PRNGKey(0)), 5)
    port = MaskBackbone(19, device="cpu", use_images=use, only_images=only)
    load_jax_params(port, {k[len("mask_backbone."):]: v for k, v in params.items()})
    assert set(params) == {"mask_backbone." + k for k in port.state_dict()}
    rng = np.random.RandomState(6)
    ix = np.arange(CANVAS)
    box = ((ix[:, None, None] >= 2) & (ix[:, None, None] < 9) & (ix[None, :, None] >= 1)
           & (ix[None, :, None] < 11) & (ix[None, None, :] >= 3) & (ix[None, None, :] < 10))
    region = np.broadcast_to(box[None, ..., None], (2, CANVAS, CANVAS, CANVAS, 1)).astype(np.float32)
    scene = rng.randn(2, CANVAS, CANVAS, CANVAS, 2).astype(np.float32) * region
    imageft = np.maximum(rng.randn(2, CANVAS, CANVAS, CANVAS, 128), 0).astype(np.float32) * region
    for training in (True, False):
        want = np.asarray(arch.apply(params, jnp.asarray(scene), imageft=jnp.asarray(imageft) if use else None,
                                     training=training, region_mask=jnp.asarray(region)))
        with torch.no_grad():
            got = port(torch.from_numpy(scene), torch.from_numpy(region), training=training,
                       imageft=torch.from_numpy(imageft) if use else None).numpy()
        assert got.shape == want.shape == (2, CANVAS, CANVAS, CANVAS, 19)
        np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)
    if use:
        with pytest.raises(ValueError, match="imageft"):
            port(torch.from_numpy(scene), torch.from_numpy(region))


@pytest.mark.parametrize("net", ["ScanNet_Backbone", "SUNCG_Backbone"])
def test_color_only_backbone_matches_jax(net):
    """``ONLY_IMAGES`` with the color stream: no ``geometry1``, level 1 the
    color stream alone; both levels within 1e-5 of the JAX package's
    ``BackboneArch.apply`` on 16^3 chunks of 128-channel color volumes.
    Without the color stream SUNCG builds its geometry stream (as the JAX
    package does) and ScanNet is refused (its level 1 would have no
    channels)."""
    from __graft_entry__ import _scannet_cfg

    cfg = _scannet_cfg()
    cfg.NET, cfg.USE_IMAGES, cfg.USE_IMAGES_GT, cfg.ONLY_IMAGES = net, True, True, True
    arch = JAX_BACKBONES[net](cfg)
    params = _params(jax.eval_shape(arch.init_params, jax.random.PRNGKey(0)), 7)
    det = load_jax_params(Detector(DetectorConfig.from_cfg(cfg), device="cpu"),
                          {**ckpt.module_params(Detector(DetectorConfig.from_cfg(cfg), device="cpu")), **params})
    assert det.geometry1 is None and not any(k.startswith("geometry1.") for k in params)
    rng = np.random.RandomState(8)
    scene = rng.randn(2, 16, 16, 16, 2).astype(np.float32)
    imageft = np.maximum(rng.randn(2, 16, 16, 16, 128), 0).astype(np.float32)
    want = arch.apply(params, jnp.asarray(scene), jnp.asarray(imageft))
    with torch.no_grad():
        got = det.features(torch.from_numpy(scene), torch.from_numpy(imageft))
    for lvl in (1, 2):
        w = np.asarray(want[lvl - 1])
        assert got[lvl].shape == w.shape == (2, 4, 4, 4, 64 if (net, lvl) == ("SUNCG_Backbone", 1) else 128)
        np.testing.assert_allclose(got[lvl].numpy(), w, atol=TOL * np.abs(w).max(), rtol=0)
    cfg.USE_IMAGES = False
    if net == "SUNCG_Backbone":
        det = Detector(DetectorConfig.from_cfg(cfg), device="cpu")
        assert det.geometry1 is not None and det.color is None
        assert set(ckpt.module_params(det)) >= set(JAX_BACKBONES[net](cfg).param_names())
    else:
        with pytest.raises(ValueError, match="ONLY_IMAGES"):
            DetectorConfig.from_cfg(cfg)


def test_mask_color_config_refusals_and_partitions():
    """What the JAX package cannot run raises with its reason; the mask
    FCN's new weights load through ``partial_update`` as the JAX package's
    partitions take them: ``mask_backbone.combine.*`` with the backbone,
    ``mask_backbone.color.*`` with the color stream."""
    from tpu3dsis.train import checkpoint as jax_ckpt

    from __graft_entry__ import _scannet_cfg

    cfg = _scannet_cfg()
    cfg.MASK_USE_IMAGES = True
    with pytest.raises(ValueError, match="needs USE_IMAGES"):
        DetectorConfig.from_cfg(cfg)
    cfg.MASK_USE_IMAGES, cfg.MASK_ONLY_IMAGES, cfg.USE_IMAGES = False, True, True
    with pytest.raises(ValueError, match="MASK_ONLY_IMAGES needs MASK_USE_IMAGES"):
        DetectorConfig.from_cfg(cfg)
    cfg.MASK_USE_IMAGES, cfg.USE_IMAGES_GT = True, True
    det = Detector(DetectorConfig.from_cfg(cfg), device="cpu")
    names = ckpt.module_params(det)
    assert {"mask_backbone.combine.0.weight", "mask_backbone.combine.2.weight",
            "mask_backbone.color.0.weight", "mask_backbone.color.10.weight"} <= set(names)
    model = {k: np.zeros_like(v) for k, v in names.items()}
    pretrained = {k: np.ones_like(v) for k, v in names.items()}
    for load_backbone, use_images in ((True, False), (False, True)):
        tcfg, jcfg = default_config(), cfg.copy()
        for c in (tcfg, jcfg):
            c.update(LOAD_BACKBONE=load_backbone, LOAD_RPN=False, LOAD_CLASS=False, USE_IMAGES=use_images)
        got = ckpt.partial_update(model, pretrained, tcfg)
        want = jax_ckpt.partial_update(model, pretrained, jcfg)
        assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
        loaded = {k for k in got if got[k].any()}
        assert ("mask_backbone.combine.0.weight" in loaded) == load_backbone
        assert ("mask_backbone.color.0.weight" in loaded) == use_images


@pytest.fixture(scope="module")
def mask_color_pair():
    """The JAX color detector with ``MASK_USE_IMAGES`` on the small tiles
    (``test_torch_scene.py``'s color setup: 128-channel feature images,
    every view admitted per tile and per window) and the port's with the
    same weights, on ``TORCH_THREADS`` threads."""
    from __graft_entry__ import _scannet_cfg

    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    cfg = _small_cfg(_scannet_cfg())
    cfg.USE_IMAGES, cfg.USE_IMAGES_GT, cfg.NUM_IMAGE_CHANNELS, cfg.MASK_USE_IMAGES = True, True, 128, True
    cfg.DEPTH_SHAPE, cfg.INTRINSIC, cfg.VOXEL_SIZE = list(DEPTH_WH), INTRINSIC, 0.1
    cfg.PROJ_DEPTH_MIN, cfg.PROJ_DEPTH_MAX = 0.4, 4.0
    cfg.TPU_MAX_TILE_VIEWS = COLOR_VIEWS
    jdet = JaxDetector(cfg, anchor_dir="experiments/anchors")
    params = _numpy_params(jdet, 2)
    tcfg = DetectorConfig.from_cfg(cfg)
    tdet = load_jax_params(Detector(tcfg, device="cpu"), params)
    yield cfg, jdet, params, tcfg, tdet
    torch.set_num_threads(threads)


def test_mask_color_routes_match_jax_predict_masks(mask_color_pair):
    """On one room of ``COLOR_VIEWS`` views: the port's fused ``infer`` (its
    mask windows cropping the resident color volume), its host-planned
    ``predict_masks`` on that volume and with each window fusing its own
    views (``TPU_SCENE_COLOR_RESIDENT="never"``) give the masks of the JAX
    package's ``predict_masks`` on the same boxes, equal but for the
    geometry test's share of flips at the threshold; ``predict_masks``
    needs the frames."""
    from test_torch_scene import MASK_FLIPS

    cfg, jdet, params, tcfg, tdet = mask_color_pair
    scene, frames = _scene(25, (48, 48, 48)), _frames(26)  # one tile: its 8 proposals bound the masks' CPU time
    si = SceneInference(tdet, tcfg, tile_batch=2)
    det, fused = si.infer(scene, frames)
    assert si.last_fused and len(det["pred_box"]) > 0
    routes = {"fused": fused, "resident": si.predict_masks(scene, det, frames=frames)}
    never = SceneInference(tdet, tcfg.replace(TPU_SCENE_COLOR_RESIDENT="never"), tile_batch=2)
    routes["per_window"] = never.predict_masks(scene, det, frames=frames)
    assert "color" not in never._device_color(frames, scene.shape[:3])
    want = jax_tiling.SceneInference(jdet, cfg, tile_batch=2).predict_masks(params, scene, det, frames=frames)
    assert len(want) == len(det["pred_box"]) and sum(m.sum() for m in want) > 0
    for name, got in routes.items():
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == np.uint8
            if a.size:
                assert (a != b).mean() < MASK_FLIPS, name
    assert (si._device_color(frames, scene.shape[:3])["color"] != 0).any()  # the windows crop real color
    with pytest.raises(ValueError, match="frames"):
        si.predict_masks(scene, det)
