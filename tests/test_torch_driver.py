"""The port's test and benchmark drivers against the JAX package's, on the CPU.

``tpu3dsis_torch.infer.driver.run_scenes`` and
``tpu3dsis.infer.driver.run_scenes`` run over the same ``.scene`` files
(written by the port's writer) with the same numpy weights
(``test_torch_scene._numpy_params``), at ``test_torch_scene``'s small tile
configuration on ``benchmark.yml``, the port on ``TORCH_THREADS`` threads.
Every artifact is compared file by file: boxes to ``test_torch_scene``'s
``BOX_ATOL`` (1e-4 voxels), confidences to its ``CONF_RTOL`` (1e-5),
classes, ``scene.npy`` and the gt files exactly, masks within its
``MASK_FLIPS`` share (0.005) of their voxels: two frameworks sum each conv
in another order. The
scenes' gt boxes are some of the detections themselves, so that both mAPs
are above 0; the two mAP dicts must be equal. Then: benchmark mode skips
finished scenes, a color scene goes through its frames directory, the entry
module ``tpu3dsis_torch.main`` gives ``run_scenes``' artifacts, and the
port's ``export_scene`` writes from them what the JAX package's writes from
its own.
"""

import copy
import os
import pickle
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from test_torch_scene import TORCH_THREADS, _assert_same_up_to_ties, _numpy_params

from tpu3dsis import config as jax_config
from tpu3dsis.eval import scannet_benchmark as jax_sb
from tpu3dsis.infer import driver as jax_driver
from tpu3dsis.models import Detector as JaxDetector
from tpu3dsis.tools.ply import write_ply
from tpu3dsis_torch import Detector, SceneInference, load_jax_params, main, scannet_scene_config, yaml_subset
from tpu3dsis_torch import config
from tpu3dsis_torch.eval import scannet_benchmark
from tpu3dsis_torch.infer import driver
from tpu3dsis_torch.infer.single_shot import SingleShotInference
from tpu3dsis_torch.io import SceneDataset, write_chunk_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHMARK_YML = "experiments/cfgs/ScanNet/benchmark.yml"
SCENE_DIMS = (48, 40, 48)  # one 48^3 tile
# test_torch_scene._small_cfg's tiles, proposals and canvases, geometry only
SMALL = {"USE_IMAGES": False, "TPU_TILE_SIZE": [48, 48, 48], "TPU_TILE_STRIDE": [36, 36, 36], "CLASS_THRESH": 0.0,
         "TPU_MASK_INFER_CANVAS": [24, 24, 24], "TPU_MASK_INFER_CANVAS_SMALL": [16, 16, 16],
         "TEST": {"RPN_PRE_NMS_TOP_N": 64, "RPN_POST_NMS_TOP_N": 8}}
PRED_FILES = ("pred_box.npy", "pred_class.npy", "pred_conf.npy", "pred_mask", "pred_mask_index", "scene.npy")
GT_FILES = ("gt_box.npy", "gt_class.npy", "gt_mask")


def small_cfg(module, filelist, save_dir, overlay=SMALL):
    """benchmark.yml with ``overlay`` merged, finalized, by ``module``'s reader."""
    cfg = module.finalize_config(module.cfg_from_file(BENCHMARK_YML))
    module.merge_into(copy.deepcopy(overlay), cfg)
    cfg.TEST_FILELIST, cfg.TEST_SAVE_DIR = filelist, save_dir
    return cfg


def load_artifacts(scene_dir):
    out = {}
    for name in os.listdir(scene_dir):
        path = os.path.join(scene_dir, name)
        if name.endswith(".npy"):
            out[name] = np.load(path)
        else:
            with open(path, "rb") as f:
                out[name] = pickle.load(f)
    return out


def assert_same_artifacts(got_dir, want_dir):
    """One scene's files, port against JAX (or port against port)."""
    got, want = load_artifacts(got_dir), load_artifacts(want_dir)
    assert sorted(got) == sorted(want)
    for name in ("pred_box.npy", "pred_class.npy", "pred_conf.npy", "scene.npy", *GT_FILES):
        if name in want and not name.endswith("mask"):
            assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape, name
    for name in GT_FILES[:2] + ("scene.npy",):
        if name in want:
            assert np.array_equal(got[name], want[name]), name
    if "gt_mask" in want:
        assert len(got["gt_mask"]) == len(want["gt_mask"])
        assert all(np.array_equal(a, b) for a, b in zip(got["gt_mask"], want["gt_mask"]))
    for masks in (got["pred_mask"], want["pred_mask"]):
        assert all(type(m) is np.ndarray and m.dtype == np.uint8 for m in masks)
    assert got["pred_mask_index"] == want["pred_mask_index"] == [True] * len(want["pred_mask"])
    det = {k: {"pred_box": a["pred_box.npy"], "pred_class": a["pred_class.npy"], "pred_conf": a["pred_conf.npy"]}
           for k, a in (("got", got), ("want", want))}
    _assert_same_up_to_ties(det["got"], got["pred_mask"], det["want"], want["pred_mask"])


def write_scene(path, sdf, boxes=None, labels=None, masks=None):
    if boxes is None:  # a placeholder object
        boxes, labels = np.array([[2, 2, 2, 6, 6, 6]], np.float32), np.array([5], np.uint32)
        masks = [np.ones((4, 4, 4), np.uint16)]
    write_chunk_file(path, sdf, boxes, labels, masks, np.ones(len(boxes), np.float32), np.eye(4, dtype=np.float32),
                     np.zeros(0, np.uint32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two scenes whose gt is three of their own detections (same class, the
    box rounded, the predicted mask) plus one box nothing detects; both
    drivers in test mode on them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    tmp = tmp_path_factory.mktemp("driver")
    filelist = str(tmp / "scenes.txt")
    cfg = small_cfg(config, filelist, str(tmp / "port"))
    jcfg = small_cfg(jax_config, filelist, str(tmp / "jax"))
    jdet = JaxDetector(jcfg, anchor_dir="experiments/anchors")
    params = _numpy_params(jdet, 0)
    det = load_jax_params(Detector(config.DetectorConfig.from_cfg(cfg), device="cpu"), params)

    rng = np.random.RandomState(0)
    paths = [str(tmp / f"scene{i:04d}_00_vh.scene") for i in range(2)]
    with open(filelist, "w") as f:
        f.write("\n".join(paths) + "\n")
    mapping, _ = config.load_label_mapping(cfg.LABEL_MAP)
    to_nyu40 = {v: k for k, v in sorted(mapping.items(), reverse=True)}
    si = SceneInference(det, config.DetectorConfig.from_cfg(cfg))
    scenes = SceneDataset(filelist, "scene", cfg)
    for path in paths:
        sdf = (rng.randn(*SCENE_DIMS) * 2).astype(np.float32)
        write_scene(path, sdf)
        found, masks = si.infer(scenes.load(path).data)
        top = np.argsort(-found["pred_conf"], kind="stable")[:3]
        boxes = [np.round(found["pred_box"][j]) for j in top] + [np.array([40, 30, 40, 46, 38, 47], np.float32)]
        labels = [to_nyu40[int(found["pred_class"][j])] for j in top] + [3]
        gt_masks = [masks[j].astype(np.uint16) for j in top] + [np.ones((6, 8, 7), np.uint16)]
        write_scene(path, sdf, np.asarray(boxes, np.float32), np.asarray(labels, np.uint32), gt_masks)
    si.close()

    results = {"port": driver.run_scenes(cfg, det, "test"),
               "jax": jax_driver.run_scenes(jcfg, params, "test", detector=jdet)}
    yield {"tmp": tmp, "cfg": cfg, "params": params, "det": det, "paths": paths, "results": results,
           "jdet": jdet, "jcfg": jcfg}
    torch.set_num_threads(threads)


def test_artifacts_match_jax(runs):
    for path in runs["paths"]:
        name = os.path.basename(path)[:12]
        got = os.path.join(runs["cfg"].TEST_SAVE_DIR, name)
        assert sorted(os.listdir(got)) == sorted(PRED_FILES + GT_FILES)
        assert_same_artifacts(got, os.path.join(runs["jcfg"].TEST_SAVE_DIR, name))
        assert np.load(os.path.join(got, "pred_class.npy")).dtype == np.int32
        assert np.load(os.path.join(got, "pred_conf.npy")).dtype == np.float32


def test_map_matches_jax(runs):
    got, want = runs["results"]["port"], runs["results"]["jax"]
    assert got == want
    assert set(got) == {"mAP_CLASSIFICATION", "mAP_MASK"} and got["mAP_CLASSIFICATION"] > 0 and got["mAP_MASK"] > 0


def test_benchmark_mode_skips_finished_scenes(runs, tmp_path):
    """A scene whose pred_box.npy exists is skipped; the other gets the test
    run's predictions and no gt files; a second run does nothing."""
    cfg = runs["cfg"].copy()
    cfg.TEST_SAVE_DIR = str(tmp_path / "bench")
    done, todo = (os.path.basename(p)[:12] for p in runs["paths"])
    os.makedirs(os.path.join(cfg.TEST_SAVE_DIR, done))
    open(os.path.join(cfg.TEST_SAVE_DIR, done, "pred_box.npy"), "wb").close()
    timings = {}
    assert driver.run_scenes(cfg, runs["det"], "benchmark", timings=timings) == {}
    assert timings["scenes"] == 1 and set(timings) == {"read", "infer", "write", "map", "scenes"}
    assert os.listdir(os.path.join(cfg.TEST_SAVE_DIR, done)) == ["pred_box.npy"]
    assert sorted(os.listdir(os.path.join(cfg.TEST_SAVE_DIR, todo))) == sorted(PRED_FILES)
    got = load_artifacts(os.path.join(cfg.TEST_SAVE_DIR, todo))
    want = load_artifacts(os.path.join(runs["cfg"].TEST_SAVE_DIR, todo))
    for name in PRED_FILES:
        if name.endswith(".npy"):
            assert np.array_equal(got[name], want[name]), name
        else:
            assert len(got[name]) == len(want[name])
            assert all(np.array_equal(a, b) for a, b in zip(got[name], want[name])), name
    stamps = {p: os.stat(os.path.join(cfg.TEST_SAVE_DIR, todo, p)).st_mtime_ns for p in PRED_FILES}
    timings = {}
    driver.run_scenes(cfg, runs["det"], "benchmark", timings=timings)
    assert timings["scenes"] == 0
    assert stamps == {p: os.stat(os.path.join(cfg.TEST_SAVE_DIR, todo, p)).st_mtime_ns for p in PRED_FILES}


def test_main_entry_matches_run_scenes(runs, tmp_path, monkeypatch):
    """``python -m tpu3dsis_torch.main --mode test`` in-process, on an overlay
    of benchmark.yml with a ``param:`` snapshot of the weights: the config
    dump, the mAP and every artifact of ``run_scenes`` with those weights.
    ``--mode train`` with ``FIX_ENET: False`` builds its trainer and writes
    a snapshot that carries the ENet's statistics and their momentum, and
    the SUNCG config builds the SUNCG detector for ``run_scenes``."""
    monkeypatch.chdir(ROOT)
    with open(BENCHMARK_YML) as f:
        overlay = yaml_subset.load(f.read())
    for key, value in SMALL.items():
        if isinstance(value, dict):
            overlay[key].update(value)
        else:
            overlay[key] = value
    overlay.update(TEST_FILELIST=runs["cfg"].TEST_FILELIST, TEST_SAVE_DIR=str(tmp_path / "main"))
    with open(tmp_path / "overlay.yml", "w") as f:
        f.write(yaml_subset.dump(overlay))
    snapshot = str(tmp_path / "step_1.npz")
    np.savez(snapshot, **{f"param:{k}": v for k, v in runs["params"].items()})
    args = ["--cfg", str(tmp_path / "overlay"), "--step", snapshot, "--device", "cpu", "--output_dir",
            str(tmp_path / "out")]
    got = main.main(args + ["--mode", "test"])
    assert got == runs["results"]["port"]
    assert os.path.isfile(tmp_path / "overlay" / "overlay.yml")  # the config dump, --cfg being absolute
    for path in runs["paths"]:
        name = os.path.basename(path)[:12]
        assert_same_artifacts(str(tmp_path / "main" / name), os.path.join(runs["cfg"].TEST_SAVE_DIR, name))
    # train mode with ENet training (FIX_ENET False): the trainer builds, and
    # its snapshot (no epoch run) holds the ENet's statistics with a momentum
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # JSONL logs only
    with open(tmp_path / "enet.yml", "w") as f:
        f.write(yaml_subset.dump({**overlay, "USE_IMAGES": True, "FIX_ENET": False,
                                  "TRAIN_FILELIST": runs["cfg"].TEST_FILELIST}))
    got = main.main(["--cfg", str(tmp_path / "enet"), "--mode", "train", "--epochs", "0", "--device", "cpu",
                     "--output_dir", str(tmp_path / "out")])
    assert got == {"step": 0}
    with np.load(tmp_path / "enet" / "checkpoints" / "step_0.npz") as snap:  # --cfg is absolute
        assert "momentum:enet.4.0.0.1.running_var" in snap.files and "param:enet.4.0.0.1.running_var" in snap.files
    # the SUNCG config builds the SUNCG detector and hands it to run_scenes
    built = {}
    monkeypatch.setattr(main, "run_scenes", lambda cfg, det, mode: built.update(cfg=cfg, det=det, mode=mode) or {})
    assert main.main(["--cfg", "SUNCG/rpn_class_mask_5", "--mode", "test", "--device", "cpu", "--output_dir",
                      str(tmp_path / "out")]) == {}
    det = built["det"]
    assert built["cfg"].NET == "SUNCG_Backbone" and built["mode"] == "test"
    assert len(det.geometry1) == 6 and len(det.color) == 6 and len(det.geometry2) == 3
    assert det.enet is not None and det.num_anchors == {1: 3, 2: 6}


def test_export_scene_takes_port_artifacts(runs, tmp_path):
    """The port's ScanNet export (``python -m tpu3dsis_torch.tools.vox2mesh``)
    on the port's artifacts writes what the JAX package's
    (``tools/vox2mesh.py``) writes on its own."""
    name = os.path.basename(runs["paths"][0])[:12]
    boxes = np.load(os.path.join(runs["cfg"].TEST_SAVE_DIR, name, "pred_box.npy"))
    verts = np.concatenate([np.random.RandomState(4).uniform(b[:3], b[3:], (60, 3)) for b in boxes[:4]])
    mesh = str(tmp_path / "mesh.ply")
    write_ply(mesh, verts.astype(np.float32))
    w2g = np.eye(4)
    w2g[:3, 3] = (10, 16, 10)  # the padding export_scene takes off
    np.savetxt(tmp_path / "world2grid.txt", w2g, fmt="%.6f")
    out = {}
    for side, save_dir, sb in (("port", runs["cfg"].TEST_SAVE_DIR, scannet_benchmark),
                               ("jax", runs["jcfg"].TEST_SAVE_DIR, jax_sb)):
        sb.export_scene(os.path.join(save_dir, name), mesh, str(tmp_path / "world2grid.txt"),
                        str(tmp_path / side), name)
        with open(tmp_path / side / f"{name}.txt") as f:
            out[side] = f.read().splitlines()
    assert out["port"] and len(out["port"]) == len(out["jax"])
    for a, b in zip(out["port"], out["jax"]):
        (fa, ca, sa), (fb, cb, sb_) = a.split(), b.split()
        assert (fa, ca) == (fb, cb) and abs(float(sa) - float(sb_)) <= 1e-4
        assert np.array_equal(np.loadtxt(tmp_path / "port" / fa), np.loadtxt(tmp_path / "jax" / fb))


def test_single_shot_detect_matches_jax(runs):
    """``TPU_SCENE_MODE="single_shot"``: the port's one-pass detector equals
    the JAX package's on a scene, and the driver takes its boxes (masks from
    the tiled path)."""
    from tpu3dsis.infer.single_shot import SingleShotInference as JaxSingleShot

    sample = SceneDataset(runs["cfg"].TEST_FILELIST, "scene", runs["cfg"])[0]
    dcfg = config.DetectorConfig.from_cfg(runs["cfg"])
    got = SingleShotInference(runs["det"], dcfg).detect(sample.data)
    want = JaxSingleShot(runs["jdet"], runs["jcfg"]).detect(runs["params"], sample.data)
    assert got["pred_class"].dtype == np.int32 and len(got["pred_box"]) > 0
    _assert_same_up_to_ties(got, [], want, [])

    cfg = runs["cfg"].copy()
    cfg.TPU_SCENE_MODE = "single_shot"
    cfg.TEST_SAVE_DIR = runs["cfg"].TEST_SAVE_DIR + "_single_shot"
    driver.run_scenes(cfg, runs["det"], "benchmark", max_scenes=1)
    art = load_artifacts(os.path.join(cfg.TEST_SAVE_DIR, os.path.basename(runs["paths"][0])[:12]))
    assert np.array_equal(art["pred_box.npy"], got["pred_box"])
    assert len(art["pred_mask"]) == len(got["pred_box"])


def test_tile_parallel_and_bad_modes_raise(runs):
    """``TPU_SCENE_TILE_PARALLEL: 2`` on the CPU splits each scene's tile
    batches and mask window queues over the CPU named twice, and writes the
    artifacts of one device bit for bit (tile batches of 16 a device
    against 32: on the CPU they agree to the bit from 3 tiles a batch up);
    an unknown mode raises."""
    cfg = runs["cfg"].copy()
    cfg.TPU_SCENE_TILE_PARALLEL = 2
    cfg.TEST_SAVE_DIR = runs["cfg"].TEST_SAVE_DIR + "_tile_parallel"
    assert driver.tile_parallel_devices(cfg, runs["det"]) == [torch.device("cpu")] * 2
    assert driver.tile_parallel_devices(runs["cfg"], runs["det"]) is None
    driver.run_scenes(cfg, runs["det"], "benchmark", max_scenes=1)
    scene = os.path.basename(runs["paths"][0])[:12]
    got = load_artifacts(os.path.join(cfg.TEST_SAVE_DIR, scene))
    want = load_artifacts(os.path.join(runs["cfg"].TEST_SAVE_DIR, scene))
    for name in ("pred_box.npy", "pred_class.npy", "pred_conf.npy", "scene.npy"):
        assert np.array_equal(got[name], want[name]), name
    assert len(got["pred_mask"]) == len(want["pred_mask"]) > 0
    assert all(np.array_equal(a, b) for a, b in zip(got["pred_mask"], want["pred_mask"]))
    with pytest.raises(ValueError):
        driver.run_scenes(runs["cfg"], runs["det"], "train")


def test_prefetch_from_other_threads_is_safe():
    """``run_scenes`` prefetches from its loader thread while the main thread
    takes scenes. Sixteen threads prefetching scenes at random while one
    takes them, with a short switch interval: no prefetch raises (an
    unguarded eviction fails here with "dictionary changed size during
    iteration" or a KeyError) and no scene is mixed up."""
    cfg = scannet_scene_config().replace(TPU_TILE_SIZE=(8, 8, 8))
    si = SceneInference(Detector(cfg, device="cpu"), cfg)
    scenes = [np.full((8, 8, 8, 2), i, np.float32) for i in range(32)]

    def prefetch(seed):
        rng = np.random.RandomState(seed)
        for _ in range(300):
            si.prefetch_scene(scenes[rng.randint(len(scenes))])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            futures = [pool.submit(prefetch, seed) for seed in range(16)]
            for j in range(300):
                data, scene_dev = si._device_scene(scenes[j % len(scenes)])
                assert data.shape == (48, 48, 48, 2) and float(data[0, 0, 0, 0]) == j % len(scenes)
                assert torch.equal(scene_dev, torch.from_numpy(data))
            for f in futures:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(old)
        si.close()


# --- a color scene through its frames directory ----------------------------------------

COLOR_DIMS, FRAME_W, FRAME_H = (48, 40, 48), 8, 6  # one 48^3 tile


def test_color_scene_through_frames_directory_matches_jax(tmp_path):
    """``tests/test_color_pipeline.py``'s color setup (label images as the
    features, no ENet; frames written with PIL) on a scene in test mode:
    the frames go through both packages' ``SceneDataset`` and the drivers'
    prefetch, and the artifacts and mAP agree."""
    from test_color_pipeline import build_frames_dir

    rng = np.random.RandomState(5)
    base = build_frames_dir(tmp_path, rng, scene="s0", n_frames=3)
    path = str(tmp_path / "s0__scene.scene")
    write_chunk_file(path, (rng.randn(*COLOR_DIMS) * 2).astype(np.float32),
                     np.array([[4, 4, 4, 12, 12, 12]], np.float32), np.array([5], np.uint32),
                     [np.ones((8, 8, 8), np.uint16)], np.ones(1, np.float32), np.eye(4, dtype=np.float32),
                     np.zeros(0, np.uint32))
    filelist = str(tmp_path / "list.txt")
    with open(filelist, "w") as f:
        f.write(path + "\n")
    overlay = {"USE_IMAGES": True, "USE_IMAGES_GT": True, "IMAGE_TYPE": "label", "IMAGE_EXT": ".png",
               "IMAGE_SHAPE": [FRAME_W, FRAME_H], "DEPTH_SHAPE": [FRAME_W, FRAME_H], "NUM_IMAGE_CHANNELS": 1,
               "VOXEL_SIZE": 0.25, "INTRINSIC": [[7.0, 0, 3.5, 0], [0, 7.5, 2.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
               "BASE_IMAGE_PATH": base, "TPU_MAX_TILE_VIEWS": 3}
    overlay = dict(copy.deepcopy(SMALL), **overlay)
    cfg = small_cfg(config, filelist, str(tmp_path / "port"), overlay)
    jcfg = small_cfg(jax_config, filelist, str(tmp_path / "jax"), overlay)
    jdet = JaxDetector(jcfg, anchor_dir="experiments/anchors")
    params = _numpy_params(jdet, 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    try:
        det = load_jax_params(Detector(config.DetectorConfig.from_cfg(cfg), device="cpu"), params)
        got = driver.run_scenes(cfg, det, "test")
    finally:
        torch.set_num_threads(threads)
    want = jax_driver.run_scenes(jcfg, params, "test", detector=jdet)
    assert got == want
    assert_same_artifacts(str(tmp_path / "port" / "s0__scene.sc"), str(tmp_path / "jax" / "s0__scene.sc"))
    assert len(np.load(tmp_path / "port" / "s0__scene.sc" / "pred_box.npy")) > 0
