"""The port's whole-scene inference against the JAX package's, on the CPU.

(a) tile origins, padding and the scene configuration; (b) the port's fused
``SceneInference.infer`` against the JAX package's ``detect`` +
``predict_masks`` with the same weights (the setup of
``tests/test_tiling.py::test_fused_matches_multidispatch``); (c) the port's
``infer`` against its own host-planned path, with every overflow forced, and
independent of the tile batch and of prefetching; (d) the same for color
scenes with frames, on 128-channel feature images (``USE_IMAGES_GT``, the
setup of ``tests/test_color_pipeline.py``): the fused path with the resident
color volume, the per-tile path, and prefetched frames; (e) the chain
after the tiles as one function of device inputs, against the stages
composed with the host's values, never captured on the CPU, and, with the
capture stood in for, captured on a bucket's second room; on a CUDA
card (``-m gpu``, which needs no JAX: ``python -m pytest --noconftest -m
gpu tests/test_torch_scene.py``), its replays against eager rooms, bit for
bit.
"""

import importlib.util
import threading

import numpy as np
import pytest
import torch

try:  # the CPU tests' reference; the card's host, which runs only the gpu test here, may lack it
    import jax
    from tpu3dsis.infer import tiling as jax_tiling
    from tpu3dsis.models import Detector as JaxDetector
except ImportError:
    jax = jax_tiling = JaxDetector = None
from tpu3dsis_torch import (Detector, DetectorConfig, ProposalConfig, SceneInference, load_jax_params,
                            scannet_scene_config)
from tpu3dsis_torch.geometry.boxes import clip_boxes
from tpu3dsis_torch.infer import tiling
from tpu3dsis_torch.ops.mask_windows import plan_windows
from tpu3dsis_torch.utils import tracing

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
    cfg.MASK_USE_IMAGES = True  # the mask FCN's color branch reads a color volume this config has not
    with pytest.raises(ValueError, match="needs USE_IMAGES"):
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
    """A mesh is a device list that starts with the detector's device (the
    CPU named twice at tile batches of 2 splits each batch over the two and
    serves what one device does at tile batches of 1, bit for bit; another
    first device raises); a geometry-only detector ignores frames, as the JAX
    package's does (its ``infer`` and ``detect`` read them only with a color
    stream)."""
    _, _, _, tcfg, tdet = pair
    with pytest.raises(ValueError, match="detector's"):
        SceneInference(tdet, tcfg, mesh=["meta", "cpu"])
    si = SceneInference(tdet, tcfg)
    want = si.infer(_scene(0))
    two = SceneInference(tdet, tcfg, tile_batch=2, mesh=["cpu", "cpu"])
    one = SceneInference(tdet, tcfg, tile_batch=1)
    got, masks = two.infer(_scene(0))
    want2, masks2 = one.infer(_scene(0))
    assert all(np.array_equal(got[k], want2[k]) for k in want2)
    assert len(masks) == len(masks2) and all(np.array_equal(a, b) for a, b in zip(masks, masks2))
    _assert_same(*si.infer(_scene(0), frames={}), *want)
    cfg = tcfg.replace(TEST=ProposalConfig(8, 4, 0.1))
    assert SceneInference(Detector(cfg.replace(USE_MASK=False), device="cpu"), cfg).predict_masks(
        _scene(0), {"pred_box": np.zeros((1, 6), np.float32)}) == []


def test_scene_path_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Detector(scannet_scene_config())
    det = Detector(scannet_scene_config(), device="cpu")
    assert det.mask_backbone is not None and SceneInference(det, scannet_scene_config()).device.type == "cpu"


# --- color scenes ------------------------------------------------------------------

COLOR_VIEWS = 3
DEPTH_WH = (16, 12)
INTRINSIC = [[7.0, 0, 7.3, 0], [0, 7.5, 5.6, 0], [0, 0, 1, 0], [0, 0, 0, 1]]


@pytest.fixture(scope="module")
def color_pair():
    """The JAX color detector on the small tiles (128-channel ground-truth
    feature images, 0.1 m voxels) with its params, a JAX ``SceneInference``
    on its resident path, and the port's detector on the CPU with the same
    weights, on ``TORCH_THREADS`` threads."""
    from __graft_entry__ import _scannet_cfg

    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    cfg = _small_cfg(_scannet_cfg())
    cfg.USE_IMAGES, cfg.USE_IMAGES_GT, cfg.NUM_IMAGE_CHANNELS = True, True, 128
    cfg.DEPTH_SHAPE, cfg.INTRINSIC, cfg.VOXEL_SIZE = list(DEPTH_WH), INTRINSIC, 0.1
    cfg.PROJ_DEPTH_MIN, cfg.PROJ_DEPTH_MAX = 0.4, 4.0
    cfg.TPU_MAX_TILE_VIEWS = COLOR_VIEWS  # every view: the per-tile path is uncapped
    jdet = JaxDetector(cfg, anchor_dir="experiments/anchors")
    params = _numpy_params(jdet, 1)
    tcfg = DetectorConfig.from_cfg(cfg)
    tdet = load_jax_params(Detector(tcfg, device="cpu"), params)
    yield cfg, jdet, params, tcfg, tdet, jax_tiling.SceneInference(jdet, cfg, tile_batch=2)
    torch.set_num_threads(threads)


def _assert_same_up_to_ties(got_det, got_masks, want_det, want_masks):
    """``_assert_same``, after putting ``got``'s detections in ``want``'s
    order where their confidences tie within CONF_RTOL: untrained weights at
    CLASS_THRESH 0 give boxes clipped to the scene's border confidences that
    differ in the last bits, and either framework may rank such a pair
    either way."""
    order, used = [], set()
    for i, (box, cls, conf) in enumerate(zip(want_det["pred_box"], want_det["pred_class"], want_det["pred_conf"])):
        same = [j for j in range(len(got_det["pred_box"])) if j not in used and got_det["pred_class"][j] == cls
                and abs(got_det["pred_conf"][j] - conf) <= CONF_RTOL * conf
                and np.abs(got_det["pred_box"][j] - box).max() <= BOX_ATOL]
        j = same[0] if same else i
        order.append(j)
        used.add(j)
    if sorted(order) == list(range(len(got_det["pred_box"]))):
        got_det = {k: v[order] for k, v in got_det.items()}
        got_masks = [got_masks[j] for j in order] if got_masks else got_masks
    _assert_same(got_det, got_masks, want_det, want_masks)


def _frames(seed, v=COLOR_VIEWS):
    """Cameras 2.4 m up inside the scene's 6 x 4.8 x 6 m box at random yaw,
    pitched down; random depths and 128-channel feature images."""
    rng = np.random.RandomState(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    for i in range(v):
        yaw, pitch = rng.uniform(0, 2 * np.pi), rng.uniform(-0.6, -0.2)
        fwd = np.array([np.cos(pitch) * np.sin(yaw), np.sin(pitch), np.cos(pitch) * np.cos(yaw)])
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        poses[i, :3, 0], poses[i, :3, 1], poses[i, :3, 2] = right, np.cross(fwd, right), fwd
        poses[i, :3, 3] = [rng.uniform(2, 4), 2.4, rng.uniform(2, 4)]
    w, h = DEPTH_WH
    return {"images": rng.randn(v, h, w, 128).astype(np.float32),
            "depths": rng.uniform(0.5, 3.5, (v, h, w)).astype(np.float32),
            "poses": poses, "world_to_grid": np.diag([10.0, 10.0, 10.0, 1.0]).astype(np.float32)}


def test_color_infer_matches_jax_detect_and_predict_masks(color_pair):
    """A color scene through the port's fused path, its tiles cropping the
    resident color volume, == the JAX package's ``detect`` +
    ``predict_masks`` with frames, to the geometry test's bars."""
    _, _, params, tcfg, tdet, jsi = color_pair
    scene, frames = _scene(15), _frames(16)
    want_det = jsi.detect(params, scene, frames=frames)
    want_masks = jsi.predict_masks(params, scene, want_det, frames=frames)
    si = SceneInference(tdet, tcfg, tile_batch=2)
    got_det, got_masks = si.infer(scene, frames)
    assert si.last_fused
    assert (si._device_color(frames, scene.shape[:3])["color"] != 0).any()
    _assert_same_up_to_ties(got_det, got_masks, want_det, want_masks)


def test_color_resident_and_per_tile_paths_match_jax_pair(color_pair):
    """The port's resident and per-tile (``TPU_SCENE_COLOR_RESIDENT="never"``)
    paths against the JAX package's own pair
    (``test_color_pipeline.py::test_resident_matches_per_tile_all_views``):
    each equals its JAX counterpart, and, with every view admitted, the two
    agree."""
    cfg, jdet, params, tcfg, tdet, jsi = color_pair
    scene, frames = _scene(17), _frames(18)
    jcfg = cfg.copy()
    jcfg.TPU_SCENE_COLOR_RESIDENT = "never"
    want = {"auto": jsi.detect(params, scene, frames=frames),
            "never": jax_tiling.SceneInference(jdet, jcfg, tile_batch=2).detect(params, scene, frames=frames)}
    got = {}
    for mode in want:
        si = SceneInference(tdet, tcfg.replace(TPU_SCENE_COLOR_RESIDENT=mode), tile_batch=2)
        got[mode] = si.detect(scene, frames)
        assert ("color" in si._device_color(frames, scene.shape[:3])) == (mode == "auto")
        _assert_same_up_to_ties(got[mode], [], want[mode], [])
    _assert_same_up_to_ties(got["never"], [], got["auto"], [])
    # the per-tile path also serves infer, as the JAX package's does
    si = SceneInference(tdet, tcfg.replace(TPU_SCENE_COLOR_RESIDENT="never"), tile_batch=2)
    det, masks = si.infer(scene, frames)
    assert not si.last_fused and len(masks) == len(det["pred_box"])
    _assert_same_up_to_ties(det, [], got["never"], [])


def test_color_results_independent_of_prefetch_frames(color_pair):
    """A prefetched stream of color scenes (``prefetch_scene`` +
    ``prefetch_frames``) gives what each scene gives alone; a color detector
    needs frames."""
    _, _, _, tcfg, tdet, _ = color_pair
    scenes = [(_scene(19 + i, (60, 40, 40)), _frames(21 + i)) for i in range(3)]
    alone = SceneInference(tdet, tcfg, tile_batch=4)
    want = [alone.infer(s, f) for s, f in scenes]
    streamed = SceneInference(tdet, tcfg, tile_batch=4)
    streamed.prefetch_scene(scenes[0][0])
    streamed.prefetch_frames(scenes[0][1], scenes[0][0].shape)
    for j, (s, f) in enumerate(scenes):
        if j + 1 < len(scenes):
            streamed.prefetch_scene(scenes[j + 1][0])
            streamed.prefetch_frames(scenes[j + 1][1], scenes[j + 1][0].shape)
        got = streamed.infer(s, f)
        assert streamed.last_fused
        _assert_same(*got, *want[j])
    streamed.close()
    assert streamed.device_seconds(scenes[2][0], scenes[2][1], iters=1) > 0
    with pytest.raises(ValueError, match="frames"):
        streamed.infer(scenes[0][0])


# --- the chain after the tiles --------------------------------------------------------

def _chain_composed(si, tiles, origins, scene_dev, extent):
    """The chain after the tiles as the fused program composed its stages
    before it became one function: the clip by the host's extent tuple
    (``clip_boxes``), the small canvas's test against a float tensor made
    here on every call."""
    cfg = si.cfg
    out = si._stitch(tiles, origins, torch.full((3,), 1e9))  # no clip here
    out["pred_box"] = clip_boxes(out["pred_box"], extent)
    box, valid = out["pred_box"], out["det_valid"]
    small, large = si._queue_canvas["mask_small"], si._queue_canvas["mask_large"]
    dims = torch.round(box[:, 3:6]) - torch.round(box[:, :3])
    fits = (dims <= torch.tensor(small, dtype=torch.float32)).all(dim=1)
    pad = scene_dev.shape[:3]
    plans = {"mask_small": plan_windows(box, valid & fits, pad, small, cfg.TPU_FUSED_MAX_DETECTIONS, single_window=True),
             "mask_large": plan_windows(box, valid & ~fits, pad, large, cfg.TPU_FUSED_LARGE_WINDOWS, allow_drop=True)}
    for name, plan in plans.items():
        labels = out["pred_class"][plan["roi_idx"].long()]
        plan["masks"] = si._window_masks(scene_dev, plan["starts"], plan["locals6"], labels, si._queue_canvas[name])
        del plan["locals6"]
        out[name] = plan
    return out


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


CHAIN_CASES = {
    "served": {},
    "overflow": {"TPU_FUSED_PRE_NMS": 8},  # more candidates than the stitch takes
    "dropped": {"TPU_MASK_INFER_CANVAS_SMALL": (12, 12, 12), "TPU_MASK_INFER_CANVAS": (20, 20, 20),
                "TPU_FUSED_LARGE_WINDOWS": 1},  # halo windows beyond the large queue
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_equals_the_stages_composed(pair, case):
    """``_chain`` with the extent as a device tensor and the planners'
    constants made once == the stitch, the planners and the mask FCN
    composed with the host's values, bit for bit in every output; in a room
    that overflows the stitch and in one whose large queue drops windows."""
    _, _, _, tcfg, tdet = pair
    scene = _scene(6)
    si = SceneInference(tdet, tcfg.replace(**CHAIN_CASES[case]), tile_batch=3)
    data, scene_dev = si._device_scene(scene)
    origins = si._bucket(data.shape[:3])["origins"]
    tiles = si._tile_outputs(scene_dev, origins)
    extent = torch.tensor(scene.shape[:3], dtype=torch.float32)
    got = _flat(si._chain(tiles, origins, scene_dev, extent))
    want = _flat(_chain_composed(si, tiles, origins, scene_dev, scene.shape[:3]))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    if case == "overflow":
        assert int(got[("pre_overflow",)]) > 0
    if case == "dropped":
        assert int(got[("mask_large", "dropped")]) > 0


def test_rooms_of_one_bucket_clip_to_their_own_extent(pair):
    """Two rooms of one bucket (96x48x96) with other true extents, served
    one after the other by one instance on the bucket's constants: each
    equals its own host-planned path, and the smaller one's boxes reach its
    own border, not the larger one's."""
    _, _, _, tcfg, tdet = pair
    si = SceneInference(tdet, tcfg, tile_batch=3)
    rooms = [_scene(6), _scene(23, (50, 40, 55))]
    assert si._bucket_shape(rooms[0].shape[:3]) == si._bucket_shape(rooms[1].shape[:3])
    for scene in rooms:
        got = si.infer(scene)
        assert si.last_fused
        want = si.detect(scene)
        _assert_same(*got, want, si.predict_masks(scene, want))
    assert len(si._buckets) == 1
    box, extent = got[0]["pred_box"], np.asarray(rooms[1].shape[:3], np.float32)
    assert (box[:, 3:] <= extent).all() and (box[:, 3:] == extent).any()


def test_infer_never_captures_on_the_cpu(pair):
    """On the CPU the chain runs eagerly in every room: no ``si.replay`` or
    ``si.capture`` span, no graph in the bucket cache, the results those of
    the host-planned path; the cache keeps the last ``GRAPH_BUCKETS``
    buckets used."""
    _, _, _, tcfg, tdet = pair
    si = SceneInference(tdet, tcfg, tile_batch=3)
    scene = _scene(6)
    tracing.clear()
    with tracing.recording():
        got = [si.infer(scene) for _ in range(2)]
    names = {sp.name for sp in tracing.spans()}
    tracing.clear()
    assert not si._graphs and "si.fused" in names and "si.stitch" in names
    assert not names & {"si.replay", "si.capture"}
    assert all("graph" not in b for b in si._buckets.values())
    want = si.detect(scene)
    want_masks = si.predict_masks(scene, want)
    for det, masks in got:
        _assert_same(det, masks, want, want_masks)
    shapes = [(96 + 48 * i, 48, 96) for i in range(tiling.GRAPH_BUCKETS + 1)]
    for shape in shapes:
        si._bucket(shape)
    assert list(si._buckets) == shapes[1:]
    si._bucket(shapes[1])
    assert list(si._buckets)[-1] == shapes[1] and len(si._buckets) == tiling.GRAPH_BUCKETS


def test_a_bucket_captures_on_its_second_room(pair, monkeypatch):
    """Where the instance takes graphs, a bucket's first room runs the
    chain eagerly and captures nothing, its second runs it eagerly and then
    captures, and its later rooms replay; a bucket seen once pays no
    capture. On the CPU, with the capture stood in for by one that keeps
    the chain's outputs as the graph's (its replay returns them)."""
    _, _, _, tcfg, tdet = pair
    si = SceneInference(tdet, tcfg, tile_batch=3)
    captured = []

    def capture(entry, tiles, scene_dev, extent):
        captured.append(tuple(scene_dev.shape[:3]))
        ins = {"tiles": {k: v.clone() for k, v in tiles.items()}, "origins": entry["origins"],
               "scene": scene_dev.clone(), "extent": extent.clone()}
        outs = si._chain(ins["tiles"], ins["origins"], ins["scene"], ins["extent"])
        return {"graph": type("Graph", (), {"replay": lambda self: None})(), "inputs": ins, "outputs": outs}

    monkeypatch.setattr(si, "_graphs", True)
    monkeypatch.setattr(si, "_capture", capture)
    rooms = [_scene(6), _scene(6), _scene(6), _scene(7, (100, 48, 60))]
    tracing.clear()
    with tracing.recording():
        got = [si.infer(scene) for scene in rooms]
    spans = tracing.spans()
    tracing.clear()
    fused = sorted((sp for sp in spans if sp.name == "si.fused"), key=lambda sp: sp.start_ns)
    stages = [[c.name for c in sorted((c for c in spans if c.parent is f), key=lambda c: c.start_ns)] for f in fused]
    eager = ["si.tiles", "si.stitch", "si.plan", "si.masks"]
    assert stages == [eager, eager + ["si.capture"], ["si.tiles", "si.replay"], eager]
    assert captured == [(96, 48, 96)]
    for det, masks in got[1:3]:
        _assert_same(det, masks, *got[0])


@pytest.mark.gpu
def test_replayed_rooms_equal_eager_rooms_on_the_card():
    """On the card, the cell ``scannet.rooms``'s configuration, weights and
    rooms (``portbench``): rooms whose chain a bucket's graph replays ==
    the same rooms with the chain eager, bit for bit in every served key.
    All three of the cell's buckets; two extents in one bucket; rooms that
    overflow to the host-planned path and rooms whose masks are redone; a
    prefetched stream whose captures overlap the upload thread's color
    prep; weights reloaded in place after the captures."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import harness, traffic, weights
    from portbench.kinds.serve_rooms import ServeRooms

    cell = ServeRooms(harness.config("scannet.rpn_class_mask_5"), dict(traffic.load("rooms"), pool=9), 3810000217)
    pool = [(t, f) for t, _, f in traffic.rooms(cell.mix, cell.seed, cell.cfg["serve"]["INTRINSIC"], cell.device)]
    t0, f0 = pool[0]
    cut = tuple(d - 7 for d in t0.shape[:3])  # another extent in the first room's bucket
    pool.append((np.ascontiguousarray(t0[:cut[0], :cut[1], :cut[2]]), f0))
    cell.pool = [(t, None, f) for t, f in pool]
    serve = dict(cell.cfg["serve"])
    serve["TEST"] = ProposalConfig(**serve["TEST"])
    for k, v in serve.items():
        if isinstance(v, list):
            serve[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
    dcfg = DetectorConfig(**serve)
    params = weights.make(cell.cfg["model"], cell.cfg["serve_weights"], cell.seed, cell.device)
    det = Detector(dcfg, device=cell.device)
    det.load_state_dict(params, strict=True)

    def serve_all(si, order, prefetch=False):
        rooms, out = [cell.fresh(i) for i in order], []
        if prefetch:
            si.prefetch_scene(rooms[0][0])
            si.prefetch_frames(rooms[0][1], rooms[0][0].shape)
        for j, (tsdf, frames) in enumerate(rooms):
            if prefetch and j + 1 < len(rooms):
                si.prefetch_scene(rooms[j + 1][0])
                si.prefetch_frames(rooms[j + 1][1], rooms[j + 1][0].shape)
            out.append(si.infer(tsdf, frames))
        si.close()
        return out

    def same(got, want, label):
        assert len(got) == len(want)
        for j, ((gd, gm), (wd, wm)) in enumerate(zip(got, want)):
            for k in wd:
                assert np.array_equal(gd[k], wd[k]), f"{label}, room {j}: {k}"
            assert len(gm) == len(wm) and all(np.array_equal(a, b) for a, b in zip(gm, wm)), f"{label}, room {j}"

    def instances(cfg):
        eager = SceneInference(det, cfg)
        eager._graphs = False
        return SceneInference(det, cfg), eager

    order = list(range(len(pool))) * 2  # each bucket's second room captures, its later rooms replay
    graphed, eager = instances(dcfg)
    assert graphed._graphs and len({graphed._bucket_shape(t.shape[:3]) for t, _ in pool}) == 3
    tracing.clear()
    with tracing.recording():
        want = serve_all(eager, order)
        same(serve_all(graphed, order), want, "served")
        over_g, over_e = instances(dcfg.replace(TPU_FUSED_MAX_DETECTIONS=4))  # most rooms overflow
        same(serve_all(over_g, order), serve_all(over_e, order), "overflow")
        assert over_g.host_path_scenes > 0 and over_g.host_path_scenes == over_e.host_path_scenes

        # a prefetched stream on a fresh instance, each capture joined by a color prep on the upload thread
        streamed = SceneInference(det, dcfg)
        real = streamed._capture

        def capture(*args):
            streamed.prefetch_frames(cell.fresh(1)[1], pool[1][0].shape)
            return real(*args)

        streamed._capture = capture
        same(serve_all(streamed, order, prefetch=True), want, "prefetched")
    spans = tracing.spans()
    tracing.clear()
    names = [sp.name for sp in spans]
    assert names.count("si.capture") == 3 * 3 and names.count("si.replay") == 3 * (len(order) - 2 * 3)
    assert "si.mask_redo" in names and "si.host_path" in names
    preps = [sp for sp in spans if sp.name == "si.prepare_color" and sp.thread.startswith("scene-upload")]
    caps = [sp for sp in spans if sp.name == "si.capture" and sp.thread == threading.current_thread().name]
    assert any(p.start_ns < c.end_ns and c.start_ns < p.end_ns for p in preps for c in caps)

    # weights reloaded in place: the graphs read them where the capture found them
    det.load_state_dict({k: v * 1.25 if k.startswith("mask_backbone") else v for k, v in params.items()}, strict=True)
    reloaded = serve_all(graphed, order[:len(pool)])
    same(reloaded, serve_all(eager, order[:len(pool)]), "reloaded")
    assert any(not all(np.array_equal(a, b) for a, b in zip(r[1], w[1])) for r, w in zip(reloaded, want))
