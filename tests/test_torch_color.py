"""The port's color stream against the JAX package's, on the CPU.

(a) the color configuration and the strict load of the trained color
fixture; (b) ENet's features, with the on-device normalisation; (c) the
plain version of K3 (``fuse_views_plain``) and the resident-volume builder
against the JAX package's ``fuse_views`` and ``make_color_volume_fn``, and
the plain version's own NaN and view-validity semantics; (d) on the
ScanNet and the SUNCG backbone, the JAX package's params loaded strictly,
and chunk detection fed a color crop, or the chunk's frames, against the
JAX ``build_inference_fn``. Inputs come from numpy seeds.
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dsis.geometry.projection import fuse_views as jax_fuse_views
from tpu3dsis.infer.color_volume import make_color_volume_fn
from tpu3dsis.models import Detector as JaxDetector
from tpu3dsis.models import build_inference_fn as jax_build_inference_fn
from tpu3dsis.models.color import ColorProjector as JaxColorProjector
from tpu3dsis.models.enet2d import ENet2D as JaxENet2D
from tpu3dsis_torch import Detector, DetectorConfig, build_inference_fn, load_jax_params, scannet_color_scene_config
from tpu3dsis_torch import checkpoint as ckpt
from tpu3dsis_torch.geometry.projection import fuse_views_plain
from tpu3dsis_torch.infer.color_volume import build_color_volume
from tpu3dsis_torch.models.color import ColorProjector

FIXTURE = "tests/fixtures/color_loop_params.npz"
K = np.array([[7.0, 0, 7.3, 0], [0, 7.5, 5.6, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)  # at 16x12 depth maps
DEPTH_WH = (16, 12)
VOXEL = 0.25
DEPTH_MIN, DEPTH_MAX = 0.4, 4.0
GRID = (32, 12, 32)  # 12,288 voxels: the 1e-4 bound on boundary flips allows one
# a voxel whose float64 margin to a rounding or depth-test boundary is below
# this is a boundary case: float32 projections of these coordinates (<= 40)
# carry errors of ~1e-5
BOUNDARY = 1e-3


class _Cfg(dict):
    __getattr__ = dict.__getitem__


def _color_loop_check():
    spec = importlib.util.spec_from_file_location("color_loop_check", "tools/color_loop_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_color_scene_config_is_bench_color_scene():
    """``scannet_color_scene_config()`` is what ``bench.py::bench_color_scene``
    builds: ``color_loop_check.build_cfg`` on benchmark.yml; its color
    options read through, and the combinations the JAX package cannot run
    are refused."""
    cfg = _color_loop_check().build_cfg("")
    assert DetectorConfig.from_cfg(cfg) == scannet_color_scene_config()
    for key in ("MASK_USE_IMAGES", "ONLY_IMAGES"):
        cfg[key] = True
        assert DetectorConfig.from_cfg(cfg) == scannet_color_scene_config().replace(**{key: True})
        cfg[key] = False
    cfg.MASK_ONLY_IMAGES = True  # the color branch alone, without the branch
    with pytest.raises(ValueError, match="MASK_ONLY_IMAGES needs MASK_USE_IMAGES"):
        DetectorConfig.from_cfg(cfg)
    cfg.MASK_ONLY_IMAGES = False
    with pytest.raises(ValueError):
        scannet_color_scene_config().replace(TPU_SCENE_COLOR_RESIDENT="sometimes")


def test_color_fixture_loads_strictly_into_the_detector():
    """All 511 keys, the ENet's classifier ``enet.26.0.weight`` and its
    BatchNorm statistics included; the ENet stays float32 while the 3D
    convs take the compute dtype (bfloat16)."""
    det = Detector(scannet_color_scene_config(), device="cpu")
    with np.load(FIXTURE) as d:
        params = {k: d[k] for k in d.files}
    assert len(params) == 511 and set(det.state_dict()) == set(params)
    load_jax_params(det, params)
    enet = det.enet
    np.testing.assert_array_equal(enet._modules["26"][0].weight.detach().numpy(),
                                  params["enet.26.0.weight"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(enet._modules["4"]._modules["0"][0][1].running_var.numpy(),
                                  params["enet.4.0.0.1.running_var"])
    assert enet._modules["0"][0].weight.dtype == torch.float32
    assert det.color[0].weight.dtype == torch.bfloat16 and det.color[0].weight.shape[1] == 128
    assert det.geometry1[4].weight.shape[0] == 64 and det.geometry2[0].weight.shape[1] == 128
    with pytest.raises(RuntimeError):  # strict: a missing key is an error
        load_jax_params(det, {k: v for k, v in params.items() if k != "enet.25.0.0.4.running_var"})


def _enet_params(seed):
    """Random ENet weights, BatchNorm statistics and PReLU slopes (numpy)."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, shape, kind in JaxENet2D(41).param_specs():
        if kind == "conv":
            params[name] = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("running_var"):
            params[name] = rng.uniform(0.5, 2.0, shape)
        elif name.endswith("running_mean"):
            params[name] = rng.randn(*shape) * 0.1
        elif kind == "prelu":
            params[name] = rng.uniform(0.0, 0.5, shape)
        else:
            params[name] = 1.0 + 0.1 * rng.randn(*shape)
    return {k: v.astype(np.float32) for k, v in params.items()}


@pytest.mark.parametrize("images", ["uint8", "float"])
def test_enet_features_match_jax(images):
    """``ColorProjector.image_features`` (normalisation of uint8 images, then
    ENet modules 0-25) == the JAX package's, on 2 views of 64x80, with random
    weights and BatchNorm statistics. rtol 1e-4 and atol 1e-5 of the largest
    feature: the two frameworks sum each of the 25 layers' convs in another
    order."""
    cfg = scannet_color_scene_config()
    params = _enet_params(0)
    rng = np.random.RandomState(1)
    x = rng.randint(0, 256, (2, 64, 80, 3)).astype(np.uint8)
    if images == "float":
        x = rng.randn(2, 64, 80, 3).astype(np.float32)
    jproj = JaxColorProjector(_Cfg(USE_IMAGES_GT=False, NUM_2D_CLASSES=41, INTRINSIC=cfg.INTRINSIC,
                                   DEPTH_SHAPE=cfg.DEPTH_SHAPE, PROJ_DEPTH_MIN=0.1, PROJ_DEPTH_MAX=4.0,
                                   VOXEL_SIZE=cfg.VOXEL_SIZE, COLOR_MEAN=cfg.COLOR_MEAN, COLOR_STD=cfg.COLOR_STD))
    want = np.asarray(jproj.image_features({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    det = Detector(cfg, device="cpu")
    load_jax_params(det.enet, {k[len("enet."):]: v for k, v in params.items()})
    with torch.no_grad():
        got = det.color_projector.image_features(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8, 10, 128)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _poses(v, seed, away=False):
    """Cameras on a circle about the centre of the grid's world box (8 x 3 x
    8 m), looking at it; with ``away``, outside the box looking away."""
    rng = np.random.RandomState(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    centre = np.array([4.0, 1.5, 4.0])
    for i in range(v):
        ang = 2 * np.pi * i / v + rng.uniform(-0.2, 0.2)
        r = 7.0 if away else 3.5
        eye = centre + [r * np.sin(ang), rng.uniform(-0.5, 0.5), -r * np.cos(ang)]
        fwd = (centre - eye) * (-1 if away else 1)
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        poses[i, :3, 0], poses[i, :3, 1], poses[i, :3, 2] = right, np.cross(fwd, right), fwd
        poses[i, :3, 3] = eye
    return poses


def _views(case):
    """(feats, depths, poses, view_valid, zero_floor) of one case."""
    rng = np.random.RandomState(sum(map(ord, case)))
    v = {"single_view_negative": 3, "zero_floor": 4}.get(case, 6)
    w, h = DEPTH_WH
    feats = rng.randn(v, h, w, 5).astype(np.float32)
    depths = rng.uniform(0.5, 3.8, (v, h, w)).astype(np.float32)
    valid = np.ones(v, bool)
    zero_floor = None
    if case == "view_valid":
        valid[[1, 4]] = False
    elif case == "single_view_negative":
        valid[[0, 2]] = False
        feats = -np.abs(feats) - 0.1
    elif case == "zero_floor":
        zero_floor = True
    return feats, depths, _poses(v, 3, away=case == "no_coverage"), valid, zero_floor


def _w2g():
    return np.diag([1 / VOXEL, 1 / VOXEL, 1 / VOXEL, 1.0]).astype(np.float32)


def _boundary_margin(vox, depths, poses, valid):
    """The smallest float64 distance, over the valid views, of voxel `vox`'s
    projection to a decision boundary: a half-integer pixel coordinate, or
    the depth test's |d - zc| = voxel_size, d = depth_min or depth_max."""
    k = K.astype(np.float64)
    g2w = np.linalg.inv(_w2g().astype(np.float64))
    p = np.array([*vox, 1.0])
    margin = np.inf
    for i in np.flatnonzero(valid):
        cam = np.linalg.inv(poses[i].astype(np.float64)) @ g2w @ p
        if cam[2] <= 0:
            continue
        px, py = cam[0] * k[0, 0] / cam[2] + k[0, 2], cam[1] * k[1, 1] / cam[2] + k[1, 2]
        margin = min(margin, abs(px - np.floor(px) - 0.5), abs(py - np.floor(py) - 0.5))
        ix, iy = int(np.round(px)), int(np.round(py))
        if 0 <= ix < DEPTH_WH[0] and 0 <= iy < DEPTH_WH[1]:
            d = float(depths[i, iy, ix])
            margin = min(margin, abs(abs(d - cam[2]) - VOXEL), abs(d - DEPTH_MIN), abs(d - DEPTH_MAX))
    return margin


def _assert_equal_but_boundary_voxels(got, want, depths, poses, valid):
    """Equal everywhere but in at most 1e-4 of the voxels, each of which is
    shown to be a boundary case: the JAX package inverts and multiplies the
    matrices with XLA's float32 routines, which may differ from the port's
    by an ulp."""
    bad = np.argwhere((got != want).any(-1))
    assert len(bad) <= 1e-4 * np.prod(GRID), f"{len(bad)} voxels differ"
    for vox in bad:
        assert _boundary_margin(vox, depths, poses, valid) < BOUNDARY, f"voxel {vox} differs off a boundary"


@pytest.mark.parametrize("case", ["views", "view_valid", "single_view_negative", "no_coverage", "zero_floor",
                                  "bf16"])
def test_fuse_views_plain_matches_jax(case):
    """``fuse_views_plain`` (K3's plain version) == JAX ``fuse_views``: several
    views; two invalid ones skipped whole; a single valid view whose negative
    features pass through as they are; cameras that see no voxel (all 0);
    ``zero_floor``; bfloat16 features."""
    feats, depths, poses, valid, zero_floor = _views(case)
    dt = (jnp.bfloat16, torch.bfloat16) if case == "bf16" else (jnp.float32, torch.float32)
    want = np.asarray(jax_fuse_views(
        jnp.asarray(feats, dt[0]), jnp.asarray(depths), jnp.asarray(poses), jnp.asarray(_w2g()), jnp.asarray(K),
        GRID, DEPTH_WH, DEPTH_MIN, DEPTH_MAX, VOXEL, view_valid=jnp.asarray(valid), zero_floor=zero_floor,
    ).astype(jnp.float32))
    got = fuse_views_plain(torch.from_numpy(feats).to(dt[1]), torch.from_numpy(depths), poses, _w2g(), K, GRID,
                           DEPTH_MIN, DEPTH_MAX, VOXEL, view_valid=torch.from_numpy(valid), zero_floor=zero_floor)
    assert got.dtype == dt[1] and tuple(got.shape) == (*GRID, 5)
    got = got.float().numpy()
    covered = (want != 0).any(-1).sum()
    if case == "no_coverage":
        assert covered == 0
    else:
        assert covered > 100
    if case == "single_view_negative":
        assert (want < 0).any()
    if case == "zero_floor":
        assert (want >= 0).all()
    _assert_equal_but_boundary_voxels(got, want, depths, poses, valid)


def test_color_volume_matches_jax_resident_builder():
    """``build_color_volume`` == the JAX package's resident builder
    (``make_color_volume_fn``: bfloat16 volume, the split gather of
    128-channel rows), with a padding view marked invalid."""
    feats, depths, poses, valid, _ = _views("view_valid")
    feats = np.random.RandomState(4).randn(*feats.shape[:3], 128).astype(np.float32)
    cfg = _Cfg(USE_IMAGES_GT=True, INTRINSIC=K.tolist(), DEPTH_SHAPE=list(DEPTH_WH), PROJ_DEPTH_MIN=DEPTH_MIN,
               PROJ_DEPTH_MAX=DEPTH_MAX, VOXEL_SIZE=VOXEL, COLOR_MEAN=[0.0] * 3, COLOR_STD=[1.0] * 3)
    build = make_color_volume_fn(JaxColorProjector(cfg), GRID, jnp.bfloat16)
    want = np.asarray(build(jnp.asarray(feats), jnp.asarray(depths), jnp.asarray(poses), jnp.asarray(_w2g()),
                            jnp.asarray(valid)).astype(jnp.float32))
    proj = ColorProjector(scannet_color_scene_config().replace(
        INTRINSIC=tuple(map(tuple, K.tolist())), DEPTH_SHAPE=DEPTH_WH, PROJ_DEPTH_MIN=DEPTH_MIN,
        PROJ_DEPTH_MAX=DEPTH_MAX, VOXEL_SIZE=VOXEL), None)
    got = build_color_volume(proj, torch.from_numpy(feats), torch.from_numpy(depths), poses, _w2g(), GRID,
                             torch.bfloat16, view_valid=torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16 and (want != 0).any(-1).sum() > 100
    _assert_equal_but_boundary_voxels(got.float().numpy(), want, depths, poses, valid)


def test_fuse_views_plain_propagates_nan_rows_and_skips_invalid_views():
    """A NaN feature row makes exactly the voxels that accept that pixel NaN
    (the max propagates NaN, as ``jnp.maximum`` does); an invalid view
    changes nothing."""
    feats, depths, poses, valid, _ = _views("views")
    args = (torch.from_numpy(depths), poses, _w2g(), K, GRID, DEPTH_MIN, DEPTH_MAX, VOXEL)
    marked = np.ones_like(feats)
    marked[0, 5, 7] = 5.0  # find the voxels that read view 0's pixel (7, 5)
    one_view = np.arange(len(valid)) == 0
    reads = (fuse_views_plain(torch.from_numpy(marked), *args, view_valid=torch.from_numpy(one_view)) == 5).all(-1)
    assert reads.sum() > 0
    nanned = feats.copy()
    nanned[0, 5, 7] = np.nan
    out = fuse_views_plain(torch.from_numpy(nanned), *args)
    assert torch.equal(torch.isnan(out).all(-1), reads) and torch.equal(torch.isnan(out).any(-1), reads)
    # views 1 and 4 invalid == the four valid views alone
    valid[[1, 4]] = False
    keep = np.flatnonzero(valid)
    a = fuse_views_plain(torch.from_numpy(feats), *args, view_valid=torch.from_numpy(valid))
    b = fuse_views_plain(torch.from_numpy(feats[keep]), args[0][keep], poses[keep], *args[2:])
    assert torch.equal(a, b)


SMALL = (32, 16, 32)


@pytest.fixture(scope="module", params=["ScanNet_Backbone", "SUNCG_Backbone"])
def color_pair(request):
    """The JAX color detector (ground-truth 128-channel feature images) on
    the ScanNet or the SUNCG backbone (its 3 + 6 anchors) with its params,
    and the port's detector holding the same weights, loaded strictly."""
    from __graft_entry__ import _scannet_cfg

    cfg = _scannet_cfg()
    if request.param == "SUNCG_Backbone":
        cfg.NET, cfg.NUM_ANCHORS_LEVEL2 = "SUNCG_Backbone", 6
        cfg.ANCHORS_TYPE_LEVEL1, cfg.ANCHORS_TYPE_LEVEL2 = "suncg9_3.txt", "suncg9_6.txt"
    cfg.USE_IMAGES, cfg.USE_IMAGES_GT, cfg.NUM_IMAGE_CHANNELS = True, True, 128
    cfg.DEPTH_SHAPE, cfg.INTRINSIC = list(DEPTH_WH), K.tolist()
    cfg.VOXEL_SIZE, cfg.PROJ_DEPTH_MIN, cfg.PROJ_DEPTH_MAX = VOXEL, DEPTH_MIN, DEPTH_MAX
    jdet = JaxDetector(cfg, anchor_dir="experiments/anchors")
    params = jdet.init_params(jax.random.PRNGKey(3))
    tdet = load_jax_params(Detector(DetectorConfig.from_cfg(cfg), device="cpu"),
                           {k: np.asarray(v) for k, v in params.items()})
    assert tdet.enet is None and tdet.color is not None
    return cfg, jdet, params, tdet


def test_jax_params_load_strictly_into_the_backbone(color_pair):
    """Every parameter of the JAX package's ``init_params`` (ScanNet's or
    SUNCG's backbone, RPN, classifier) is the port's of the same name, in
    the torch layout, and nothing else is."""
    cfg, jdet, params, tdet = color_pair
    assert set(tdet.state_dict()) == set(params)
    want = ckpt.params_to_torch_state_dict({k: np.asarray(v) for k, v in params.items()})
    for k, v in tdet.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    if cfg.NET == "SUNCG_Backbone":  # no max-pools; geometry2 reads the two 64-channel streams
        assert not any(isinstance(m, torch.nn.MaxPool3d) for m in tdet.modules())
        assert tdet.geometry2[0].weight.shape[1] == 128 and tdet.color[3].weight.shape[:2] == (64, 64)


@pytest.mark.parametrize("color_input", ["imageft", "frames"])
def test_chunk_detection_with_color_matches_jax(color_pair, color_input):
    """``build_inference_fn`` fed the chunk's color crop (the resident path)
    or its frames (the per-tile path: fused in the call, with an invalid
    view and ``zero_floor``) == the JAX package's on the valid rows; boxes
    to 1e-3 voxels and class probabilities to 1e-4, as the geometry
    detector's test holds them."""
    cfg, jdet, params, tdet = color_pair
    rng = np.random.RandomState(5)
    scene = np.stack([np.abs(rng.randn(*SMALL)) * 2, rng.rand(*SMALL) > 0.3], -1).astype(np.float32)[None]
    v = 4
    frames = {"images": rng.randn(v, DEPTH_WH[1], DEPTH_WH[0], 128).astype(np.float32),
              "depths": rng.uniform(0.5, 3.8, (v, DEPTH_WH[1], DEPTH_WH[0])).astype(np.float32),
              "poses": _poses(v, 6), "world_to_grid": _w2g(), "view_valid": np.array([1, 1, 0, 1], bool),
              "zero_floor": True}
    jinfer = jax.jit(jax_build_inference_fn(jdet, cfg, SMALL))
    tinfer = build_inference_fn(tdet, DetectorConfig.from_cfg(cfg), SMALL)
    if color_input == "imageft":
        crop = np.maximum(rng.randn(*SMALL, 128), 0).astype(np.float32)
        want = jinfer(params, jnp.asarray(scene), {"imageft": jnp.asarray(crop)})
        got = tinfer(torch.from_numpy(scene), imageft=torch.from_numpy(crop)[None])
    else:
        want = jinfer(params, jnp.asarray(scene), {k: jnp.asarray(a) for k, a in frames.items()})
        got = tinfer(torch.from_numpy(scene), frames=frames)
    want = {k: np.asarray(a) for k, a in want.items()}
    ok = want["valid"]
    assert ok.sum() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), ok)
    np.testing.assert_array_equal(got["cls_pred"].numpy()[ok], want["cls_pred"][ok])
    for key in ("rois", "pred_box"):
        np.testing.assert_allclose(got[key].numpy()[ok], want[key][ok], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["cls_prob"].numpy()[ok], want["cls_prob"][ok], atol=1e-4, rtol=0)


def test_color_detector_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """The color detector (ENet included) lives on the CUDA card unless the
    caller passes ``device="cpu"``; K3's wrapper takes only CUDA tensors, and
    ``fuse_views`` sends CPU tensors to the plain version."""
    from tpu3dsis_torch.geometry.projection import fuse_views, fuse_views_cuda

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Detector(scannet_color_scene_config())
    det = Detector(scannet_color_scene_config(), device="cpu")
    assert det.enet._modules["0"][0].weight.device.type == "cpu" and det.color[0].weight.device.type == "cpu"
    feats, depths, poses, valid, _ = _views("views")
    args = (torch.from_numpy(feats), torch.from_numpy(depths), poses, _w2g(), K, GRID, DEPTH_MIN, DEPTH_MAX, VOXEL)
    with pytest.raises(ValueError, match="CUDA"):
        fuse_views_cuda(*args)
    assert torch.equal(fuse_views(*args), fuse_views_plain(*args))
