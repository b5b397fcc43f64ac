"""The port's detector against the JAX package's, on the CPU.

(a) backbone and RPN heads, (b) the whole inference function on a batch,
(c) the full-width chunk against the pinned golden stages of
``tests/fixtures/full_net_golden.npz`` (no reference checkout needed), (d)
config reading and strict weight loading, the port's weight conversion
against the JAX package's, and the card as the default device. Weights
always come from the JAX package through ``load_jax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dsis.config import cfg_from_file
from tpu3dsis.models import Detector as JaxDetector
from tpu3dsis.models import build_inference_fn as jax_build_inference_fn
from tpu3dsis.train.checkpoint import params_to_torch_state_dict as jax_params_to_torch_state_dict
from tpu3dsis_torch import Detector, DetectorConfig, build_inference_fn, load_jax_params, scannet_chunk_config
from tpu3dsis_torch.checkpoint import params_to_torch_state_dict

SMALL = (32, 16, 32)
GOLDEN = "tests/fixtures/full_net_golden.npz"
TRAINED = "tests/fixtures/tiling_parity_params.npz"


def _encode(sdf):
    """encode_tsdf with TRUNCATED 3, no flip, no log (io/dataset.py:41)."""
    return np.stack([np.abs(np.clip(sdf, -3, 3)), (sdf > -1).astype(np.float32)], -1).astype(np.float32)


def _scene(seed):
    rng = np.random.RandomState(seed)
    sdf = np.full(SMALL, 8.0, np.float32)
    for _ in range(3):
        lo = rng.randint(1, [20, 8, 20])
        hi = lo + rng.randint(5, [12, 8, 12])
        sdf[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 0.3
        sdf[lo[0] + 1:hi[0] - 1, lo[1] + 1:hi[1] - 1, lo[2] + 1:hi[2] - 1] = -2.0
    sdf += rng.randn(*SMALL).astype(np.float32) * 0.05  # distinct scores
    return _encode(sdf)


def _pair(cfg, key):
    """JAX detector + params, and the port's detector holding the same weights."""
    jdet = JaxDetector(cfg, anchor_dir="experiments/anchors")
    params = jdet.init_params(jax.random.PRNGKey(key))
    tdet = Detector(DetectorConfig.from_cfg(cfg), device="cpu")
    assert tdet.mask_backbone is not None
    load_jax_params(tdet, {k: np.asarray(v) for k, v in params.items()})  # every param, mask head included
    return jdet, params, tdet


@torch.no_grad()
def test_backbone_and_rpn_heads_match_jax(scannet_cfg):
    jdet, params, tdet = _pair(scannet_cfg, 1)
    scene = _scene(0)[None]
    jfeats = jdet.features(params, jnp.asarray(scene))
    jrpn = jdet.rpn_forward(params, jfeats)
    tfeats = tdet.features(torch.from_numpy(scene))
    trpn = tdet.rpn_forward(tfeats)
    # atol/rtol 1e-4: the two frameworks sum each conv in another order
    tol = dict(atol=1e-4, rtol=1e-4)
    for lvl in (1, 2):
        np.testing.assert_allclose(tfeats[lvl].numpy(), np.asarray(jfeats[lvl]), **tol)
        for got, want in zip(trpn[lvl], jrpn[lvl]):
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_inference_matches_jax_on_a_batch(scannet_cfg):
    """A batch of two scenes through the port in one call == each scene
    through the JAX inference function, on the valid rows."""
    jdet, params, tdet = _pair(scannet_cfg, 2)
    scenes = np.stack([_scene(1), _scene(2)])
    got = build_inference_fn(tdet, DetectorConfig.from_cfg(scannet_cfg), SMALL)(torch.from_numpy(scenes))
    jinfer = jax.jit(jax_build_inference_fn(jdet, scannet_cfg, SMALL))
    assert got["rois"].shape == (2, 200, 6) and got["cls_prob"].shape == (2, 200, 19)
    for b in range(2):
        want = {k: np.asarray(v) for k, v in jinfer(params, jnp.asarray(scenes[b:b + 1])).items()}
        assert set(want) == set(got)
        v = want["valid"]
        assert v.sum() > 0
        np.testing.assert_array_equal(got["valid"][b].numpy(), v)
        np.testing.assert_array_equal(got["level_inds"][b].numpy()[v], want["level_inds"][v])
        np.testing.assert_array_equal(got["cls_pred"][b].numpy()[v], want["cls_pred"][v])
        for key in ("rois", "pred_box"):  # voxels
            np.testing.assert_allclose(got[key][b].numpy()[v], want[key][v], atol=1e-3, rtol=0)
        np.testing.assert_allclose(got["cls_prob"][b].numpy()[v], want["cls_prob"][v], atol=1e-4, rtol=0)


def test_full_width_chunk_matches_golden_stages():
    """96x48x96 chunk (test_full_net_parity.make_chunk(seed=3)) with the JAX
    ``init_params(PRNGKey(5))`` weights against the pinned JAX stages."""
    from test_full_net_parity import make_chunk

    cfg = cfg_from_file("experiments/cfgs/ScanNet/benchmark.yml")
    cfg.LABEL_MAP = ""
    cfg.NUM_CLASSES = 19
    cfg.USE_IMAGES = False
    _, _, tdet = _pair(cfg, 5)
    g = np.load(GOLDEN)
    scene = torch.from_numpy(make_chunk(seed=3))
    with torch.no_grad():
        feats = tdet.features(scene)
        rpn = tdet.rpn_forward(feats)
    out = build_inference_fn(tdet, DetectorConfig.from_cfg(cfg), (96, 48, 96))(scene)
    v = out["valid"].numpy()
    stages = {
        "l1": feats[1], "l2": feats[2], "rpn_prob_l1": rpn[1][1], "rpn_prob_l2": rpn[2][1],
        "rpn_bbox_l2": rpn[2][2], "rois": out["rois"][v], "level_inds": out["level_inds"][v],
        "cls_prob": out["cls_prob"][v], "bbox_pred": out["bbox_pred"][v],
        "pred_box": out["pred_box"][v], "pred_conf": out["pred_conf"][v],
    }
    assert v.sum() == len(g["rois"])
    for key, got in stages.items():
        # the golden test's own tolerance (test_full_net_parity.py:307)
        np.testing.assert_allclose(got.numpy(), g[key], atol=1e-4, rtol=1e-3, err_msg=key)


def test_config_and_strict_loading_of_trained_weights():
    from __graft_entry__ import _scannet_cfg

    # chunk detection reads no mask head: scannet_chunk_config() leaves it
    # out, so the geometry-only fixture loads strictly
    assert DetectorConfig.from_cfg(_scannet_cfg()) == scannet_chunk_config().replace(USE_MASK=True)
    det = Detector(scannet_chunk_config(), device="cpu")
    trained = np.load(TRAINED)
    assert set(det.state_dict()) == set(trained.files)
    load_jax_params(det, TRAINED)
    w = trained["geometry1.4.weight"].astype(np.float32)  # (kx, ky, kz, in, out)
    np.testing.assert_array_equal(det.geometry1[4].weight.detach().numpy(), w.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(
        det.classifier[0].weight.detach().numpy(), trained["classifier.0.weight"].astype(np.float32).T
    )
    with pytest.raises(RuntimeError):  # strict: a missing key is an error
        load_jax_params(det, {k: trained[k] for k in trained.files if k != "classifier.0.bias"})


def test_weight_conversion_matches_jax_package():
    """The port's own copy of the layout conversion == the JAX package's,
    key for key and array for array, on the trained fixture."""
    with np.load(TRAINED) as data:
        params = {k: data[k] for k in data.files}
    got = params_to_torch_state_dict(params)
    want = jax_params_to_torch_state_dict(params)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_detector_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Detector(scannet_chunk_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Detector(scannet_chunk_config(), device="cuda:0")
    assert Detector(scannet_chunk_config(), device="cpu").device.type == "cpu"
