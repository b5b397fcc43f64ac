"""The port's copies of the JAX package's numpy-only modules against their
originals, on the CPU: the config files (``tpu3dsis_torch.config`` and its
YAML-subset reader), the ``.chunk``/``.scene`` format, ``SceneDataset`` with
frames on disk, ``DetectionMAP`` and the checkpoint loaders.

Tolerance: none. Every copy runs the same numpy (or Python) arithmetic as
its original, so results are compared for equality, types included.
"""

import glob
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tpu3dsis import config as jax_config
from tpu3dsis.eval import detection_map as jax_map
from tpu3dsis.io import chunk_format as jax_chunk
from tpu3dsis.io import dataset as jax_dataset
from tpu3dsis.train import checkpoint as jax_ckpt
from tpu3dsis_torch import checkpoint as ckpt
from tpu3dsis_torch import config, yaml_subset
from tpu3dsis_torch.eval import detection_map
from tpu3dsis_torch.io import chunk_format, dataset

CFG_FILES = sorted(glob.glob("experiments/cfgs/**/*.yml", recursive=True))
LABEL_MAP = "experiments/labelmaps/nyu40labels_scannet.csv"


def assert_same(a, b, where="value"):
    """Equal values of the same Python types, all the way down (each
    package's ``Config`` is its own dict type: the names must agree)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and type(a).__name__ == type(b).__name__, where
    else:
        assert type(a) is type(b), f"{where}: {type(a).__name__} vs {type(b).__name__}"
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b or (a != a and b != b), f"{where}: {a!r} vs {b!r}"


# --- config ----------------------------------------------------------------------


def plain(d):
    """A Config as the plain dicts ``yaml.safe_load`` gives."""
    return {k: plain(v) for k, v in d.items()} if isinstance(d, dict) else d


def test_cfg_files_found():
    assert len(CFG_FILES) == 5


@pytest.mark.parametrize("path", CFG_FILES, ids=[os.path.relpath(p, "experiments/cfgs") for p in CFG_FILES])
def test_cfg_from_file_matches_jax(path):
    """The port's reader + merge + finalize against ``tpu3dsis.config`` (YAML
    through ``yaml.safe_load``): equal dicts of equal types; the raw mapping
    too; and ``DetectorConfig.from_cfg`` reads it, wherever the port builds
    that detector."""
    with open(path) as f:
        text = f.read()
    assert_same(yaml_subset.load(text, path), yaml.safe_load(text), "raw")
    got = config.finalize_config(config.cfg_from_file(path))
    want = jax_config.finalize_config(jax_config.cfg_from_file(path))
    assert isinstance(got, config.Config)
    assert_same(dict(got), dict(want), "cfg")
    assert got.TEST.RPN_POST_NMS_TOP_N == want.TEST.RPN_POST_NMS_TOP_N  # attribute access, nested
    if got.NET == "ScanNet_Backbone":
        assert config.DetectorConfig.from_cfg(got) == config.DetectorConfig.from_cfg(want)


def test_cfg_to_file_round_trips(tmp_path):
    """``cfg_to_file`` writes what ``yaml.safe_load`` (and the port's reader)
    read back equal to the config, with the JAX package's defaults and
    finalized keys."""
    cfg = config.finalize_config(config.cfg_from_file("experiments/cfgs/ScanNet/benchmark.yml"))
    cfg.LEARNING_RATE, cfg.BASE_IMAGE_PATH = 5e-06, "it's a \"path\"\twith #"
    cfg.TEST.RPN_NMS_THRESH = 1e17
    path = str(tmp_path / "dump.yml")
    config.cfg_to_file(cfg, path)
    with open(path) as f:
        text = f.read()
    assert_same(yaml.safe_load(text), plain(cfg), "safe_load")
    assert_same(yaml_subset.load(text), plain(cfg), "port")
    # read back onto a finalized base (NORMALIZE_WEIGHTS is a list there)
    base = config.finalize_config(config.cfg_from_file("experiments/cfgs/ScanNet/benchmark.yml"))
    assert_same(plain(config.cfg_from_file(path, base)), plain(cfg), "cfg_from_file")


YAML_CASES = [
    "a: 0.000005", "a: 2.0", "a: 2", "a: 1e-5", "a: 1.0e-5", "a: 1.5E+3", "a: .5", "a: -.inf", "a: .NaN",
    "a: 0x1F", "a: 017", "a: 0b101", "a: 1_000", "a: +12", "a: -0", "a: 190:20:30", "a: 1:20.5", "a: 12:60",
    "a: True", "a: off", "a: YES", "a: y", "a: ~", "a: null", "a:", "a: ''", "a: 'it''s # no comment'",
    'a: "tab\\there\\u00e9"', "a: bare/path/../x.txt  # comment", "a: b#c", "a: -foo", "a: [ ]",
    "a: [1, [2.5, 'x'], y, ]", "a: [[1, 0],\n    [0, 1]]  # 2 lines", "T:\n  X: 1\n  Y: [a, b]\nZ: 3",
    "T:\nZ: 3", "# only a comment",
]
YAML_REFUSED = ["a: [1, 2", "- a", "a: &x 1", "a: !!str 1", "a: {b: 1}", "a: |\n  text", "a: 2020-01-01",
                "a: b: c", "a:\n  - 1", "  a: 1", "a: 'open"]


@pytest.mark.parametrize("text", YAML_CASES)
def test_yaml_subset_resolves_like_safe_load(text):
    assert_same(yaml_subset.load(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", YAML_REFUSED)
def test_yaml_subset_refuses_what_it_does_not_read(text):
    """Outside the subset the reader raises, never reads a value that
    ``safe_load`` would read otherwise."""
    with pytest.raises(ValueError):
        yaml_subset.load(text)


def test_merge_into_type_rules_match_jax():
    for overlay in ({"LEARNING_RATE": 1}, {"FIX_ENET": 0}, {"STEPSIZE": []}, {"TEST": {"RPN_NMS_THRESH": 1}},
                    {"NUM_CLASSES": 2.0}, {"NET": 3}, {"TEST": 1}, {"NOT_A_KEY": 1}, {"TEST": {"NOPE": 1}}):
        got, want = config.default_config(), jax_config.default_config()
        errs = []
        for merge, cfg in ((config.merge_into, got), (jax_config.merge_into, want)):
            try:
                merge(overlay, cfg)
                errs.append(None)
            except (KeyError, ValueError) as e:
                errs.append(type(e))
        assert errs[0] == errs[1], overlay
        assert_same(dict(got), dict(want), str(overlay))
    assert_same(dict(config.default_config()), dict(jax_config.default_config()), "defaults")


def test_label_mapping_matches_jax():
    assert config.load_label_mapping(LABEL_MAP) == jax_config.load_label_mapping(LABEL_MAP)


# --- .chunk / .scene files ------------------------------------------------------------


def _chunk_contents(rng, dims=(9, 7, 5), n=3):
    sdf = (rng.randn(*dims) * 2).astype(np.float32)
    lo = rng.uniform(0, 4, (n, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(1, 3, (n, 3))], 1)
    masks = [(rng.rand(*(np.ceil(b[3:]) - np.floor(b[:3])).astype(int)) > 0.5).astype(np.uint16) * rng.randint(1, 3)
             for b in boxes]
    mat = np.eye(4, dtype=np.float32)
    mat[:3, 3] = rng.uniform(-5, 5, 3)
    return (sdf, boxes, rng.randint(1, 41, n).astype(np.uint32), masks, rng.rand(n).astype(np.float32), mat,
            rng.randint(0, 900, 4).astype(np.uint32))


@pytest.mark.parametrize("n_boxes", [0, 3])
def test_chunk_files_byte_equal_both_ways(tmp_path, n_boxes):
    contents = _chunk_contents(np.random.RandomState(n_boxes), n=n_boxes)
    ours, theirs = str(tmp_path / "port.scene"), str(tmp_path / "jax.scene")
    chunk_format.write_chunk_file(ours, *contents)
    jax_chunk.write_chunk_file(theirs, *contents)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for reader, path in ((chunk_format.read_chunk_file, theirs), (jax_chunk.read_chunk_file, ours)):
        for with_masks in (True, False):
            got = reader(path, with_masks=with_masks)
            want = jax_chunk.read_chunk_file(theirs, with_masks=with_masks)
            for field in ("sdf", "boxes", "labels", "box_in_vol", "world_to_grid", "frame_ids"):
                a, b = getattr(got, field), getattr(want, field)
                assert a.dtype == b.dtype and np.array_equal(a, b), field
            assert len(got.masks) == len(want.masks)
            for a, b in zip(got.masks, want.masks):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_chunk_reader_refuses_a_short_file(tmp_path):
    path = str(tmp_path / "short.scene")
    chunk_format.write_chunk_file(path, *_chunk_contents(np.random.RandomState(1)))
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-3])
    with pytest.raises(EOFError):
        chunk_format.read_chunk_file(path)


# --- SceneDataset with frames on disk ---------------------------------------------------

FRAME_WH = (10, 6)  # the images on disk; the configs below resize and crop some of them


def write_frames(root, rng, scene, n_frames=3):
    """A frames directory as ``tests/test_color_pipeline.py::build_frames_dir``
    writes it (PIL: uint16 depth PNGs in mm, label PNGs, pose and
    world2grid text), plus RGB color PNGs."""
    base = os.path.join(root, scene)
    for sub in ("depth", "pose", "label", "color"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    w, h = FRAME_WH
    for i in (0, 4, 11)[:n_frames]:
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.uniform(-1, 1, 3)
        Image.fromarray((rng.uniform(0.5, 3.5, (h, w)) * 1000).astype(np.uint16)).save(
            os.path.join(base, "depth", f"{i}.png"))
        np.savetxt(os.path.join(base, "pose", f"{i}.txt"), pose, fmt="%.6f")
        Image.fromarray(rng.randint(0, 45, (h, w)).astype(np.uint8)).save(os.path.join(base, "label", f"{i}.png"))
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(os.path.join(base, "color", f"{i}.png"))
    w2g = np.diag([4.0, 4.0, 4.0, 1.0]).astype(np.float32)
    w2g[:3, 3] = (10, 16, 10)
    np.savetxt(os.path.join(base, "world2grid.txt"), w2g, fmt="%.6f")


def write_scenes(tmp_path, rng, n=2, dims=(12, 60, 10)):
    """n scenes whose boxes exercise the label remap (a weight-0 class), the
    KEEP_THRESH filter (a box 0.4 inside) and the height crop (a box above
    48 voxels), with their frames; returns the filelist's path."""
    paths = []
    for i in range(n):
        boxes = np.array([[1.2, 1.1, 1.3, 4.8, 4.2, 5.9], [0, 0, 0, 3, 3, 3], [2, 50, 1, 5, 55, 4],
                          [0.5, 2, 0.5, 6, 5, 6], [3, 10, 3, 7, 12, 6]])
        labels = np.array([5, 4, 7, 1, 39], np.uint32)  # chair, bed, table, wall (weight 0), otherfurniture
        masks = [(rng.rand(*(np.ceil(b[3:]) - np.floor(b[:3])).astype(int)) > 0.5).astype(np.uint16) * 2
                 for b in boxes]
        frac = np.array([1.0, 1.0, 1.0, 1.0, 0.4], np.float32)
        path = str(tmp_path / f"s{i}__{i}.scene")
        chunk_format.write_chunk_file(path, (rng.randn(*dims) * 2).astype(np.float32), boxes, labels, masks, frac,
                                      np.eye(4, dtype=np.float32), np.array([0, 4, 11], np.uint32))
        write_frames(str(tmp_path / "frames_square"), rng, f"s{i}")
        paths.append(path)
    filelist = tmp_path / "list.txt"
    filelist.write_text("\n".join(paths) + "\n")
    return str(filelist)


def _dataset_cfg(cfg, frames_root, use_images, gt_images):
    cfg.LABEL_MAP = LABEL_MAP
    cfg.KEEP_THRESH = 1.0
    cfg.USE_IMAGES = use_images
    cfg.USE_IMAGES_GT = gt_images
    cfg.BASE_IMAGE_PATH = frames_root
    cfg.IMAGE_TYPE, cfg.IMAGE_EXT = ("label" if gt_images else "color"), ".png"
    cfg.IMAGE_SHAPE = [8, 5] if gt_images else list(FRAME_WH)  # the label images are resized and cropped
    cfg.DEPTH_SHAPE = [5, 3]
    return cfg


@pytest.mark.parametrize("mode,use_images,gt_images", [
    ("scene", False, False), ("benchmark", False, False), ("scene", True, True), ("benchmark", True, False),
    ("chunk", True, True)])
def test_scene_dataset_matches_jax(tmp_path, mode, use_images, gt_images):
    filelist = write_scenes(tmp_path, np.random.RandomState(2))
    root = str(tmp_path / "frames_square")
    got_ds = dataset.SceneDataset(filelist, mode, _dataset_cfg(config.default_config(), root, use_images, gt_images))
    want_ds = jax_dataset.SceneDataset(filelist, mode,
                                       _dataset_cfg(jax_config.default_config(), root, use_images, gt_images))
    assert got_ds.scenes == want_ds.scenes and len(got_ds) == 2
    for i in range(len(got_ds)):
        got, want = got_ds[i], want_ds[i]
        assert got.sample_id == want.sample_id
        for field in ("data", "gt_box", "world_to_grid", "frame_ids", "images", "depths", "poses"):
            a, b = getattr(got, field), getattr(want, field)
            if b is None:
                assert a is None, field
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b), field
        assert len(got.gt_mask) == len(want.gt_mask)
        for a, b in zip(got.gt_mask, want.gt_mask):
            assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
        if use_images:
            assert got.images is not None and len(got.images) == 3
        # the crop, the filter and the remap did something
        assert got.data.shape[1] == (60 if mode == "benchmark" else 48)
        assert 0 < len(got.gt_box) < 5


def test_frames_need_pil_only_from_disk(tmp_path, monkeypatch):
    """Without PIL a frame read raises an ImportError that names it."""
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    filelist = write_scenes(tmp_path, np.random.RandomState(3), n=1)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    cfg = _dataset_cfg(config.default_config(), str(tmp_path / "frames_square"), False, False)
    assert dataset.SceneDataset(filelist, "scene", cfg)[0].images is None
    cfg.USE_IMAGES = True
    with pytest.raises(ImportError, match="PIL"):
        dataset.SceneDataset(filelist, "scene", cfg)[0]


# --- DetectionMAP -------------------------------------------------------------------------


def _random_scene_preds(rng, n_pred, n_gt, n_class, dims=(20, 12, 20)):
    lo = rng.randint(0, 10, (n_gt, 3))
    gt = np.concatenate([lo, lo + rng.randint(2, 8, (n_gt, 3))], 1).astype(np.float32)
    src = rng.randint(0, n_gt, n_pred)
    pred = gt[src] + rng.uniform(-1.5, 1.5, (n_pred, 6)).astype(np.float32)
    pred[:, 3:] = np.maximum(pred[:, 3:], pred[:, :3] + 1)
    gt_cls = rng.randint(1, n_class, n_gt)
    pred_cls = np.where(rng.rand(n_pred) < 0.7, gt_cls[src], rng.randint(1, n_class, n_pred)).astype(np.int32)
    conf = rng.rand(n_pred).astype(np.float32)

    def crop_masks(boxes):
        return [(rng.rand(*np.maximum(np.round(b[3:]) - np.round(b[:3]), 0).astype(int)) > 0.3).astype(np.uint8)
                for b in boxes]

    return pred, pred_cls, conf, crop_masks(pred), gt, gt_cls.astype(np.float32), crop_masks(gt), dims


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_map_matches_jax(seed):
    rng = np.random.RandomState(seed)
    n_class = 6
    maps = {}
    for name, mod in (("port", detection_map), ("jax", jax_map)):
        maps[name] = (mod.DetectionMAP(n_class, overlap_threshold=0.5, ignore_class=[0]),
                      mod.DetectionMAP(n_class, overlap_threshold=0.25, ignore_class=[0]))
    scenes = [_random_scene_preds(rng, rng.randint(0, 12), rng.randint(1, 6), n_class) for _ in range(4)]
    for scene in scenes:
        pred, pred_cls, conf, pmask, gt, gt_cls, gmask, dims = scene
        for cls_map, mask_map in maps.values():
            cls_map.evaluate(pred, pred_cls, conf, gt, gt_cls)
            mask_map.evaluate_mask(pred, pred_cls, conf, pmask, gt, gt_cls, gmask, dims)
    got, want = maps["port"], maps["jax"]
    for g, w in zip(got, want):
        g.finalize()
        w.finalize()
        assert g.ignore_class == w.ignore_class
        kept = [i for i in range(n_class) if i not in w.ignore_class]
        assert len(kept) > 1 and [g.AP(i) for i in kept] == [w.AP(i) for i in kept]
        assert g.mAP() == w.mAP()
    # the class-agnostic mode (all pred classes -1), as for RPN roi AP
    pred, _, conf, _, gt, gt_cls, _, _ = scenes[0]
    results = []
    for mod in (detection_map, jax_map):
        m = mod.DetectionMAP(2, overlap_threshold=0.25)
        m.evaluate(pred, -np.ones(len(pred), np.int32), conf, gt, np.ones(len(gt)))
        m.finalize()
        results.append(m.mAP())
    assert results[0] == results[1]
    a = np.random.RandomState(seed).rand(3, 4, 5, 6) > 0.5
    b = np.random.RandomState(seed + 9).rand(2, 4, 5, 6) > 0.5
    assert np.array_equal(detection_map.mask_jaccard(a, b), jax_map.mask_jaccard(a, b))
    assert np.array_equal(detection_map.box_jaccard(pred, gt), jax_map.box_jaccard(pred, gt))


# --- checkpoints ---------------------------------------------------------------------------


def _fixture(name):
    with np.load(f"tests/fixtures/{name}") as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("flags", [dict(), dict(NYUV2_FINETUNE=True), dict(USE_IMAGES=False, LOAD_RPN=False),
                                   dict(LOAD_BACKBONE=False, LOAD_CLASS=False)])
def test_partial_update_matches_jax(flags):
    """On the color fixture over random params of its shapes: the same keys
    taken, ``mask_backbone.geometry.*`` with the backbone and ``enet.*``
    never (the JAX package's partitions)."""
    pre = _fixture("color_loop_params.npz")
    rng = np.random.RandomState(0)
    model = {k: rng.randn(*v.shape).astype(np.float32) for k, v in pre.items()}
    cfg = config.finalize_config(config.cfg_from_file("experiments/cfgs/ScanNet/benchmark.yml"))
    jcfg = jax_config.finalize_config(jax_config.cfg_from_file("experiments/cfgs/ScanNet/benchmark.yml"))
    for c in (cfg, jcfg):
        c.update(flags)
    got, want = ckpt.partial_update(model, pre, cfg), jax_ckpt.partial_update(model, pre, jcfg)
    assert got.keys() == want.keys()
    assert all(got[k] is want[k] for k in got)
    taken = {k for k in got if got[k] is pre[k]}
    assert not any(k.startswith("enet.") for k in taken)
    assert any(k.startswith("mask_backbone.geometry.") for k in taken) == cfg.LOAD_BACKBONE
    bad = dict(pre, **{sorted(taken)[0]: np.zeros((1, 1), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.partial_update(model, bad, cfg)


def test_load_snapshot_and_load_pth_match_jax(tmp_path):
    params = _fixture("tiling_parity_params.npz")
    snap = str(tmp_path / "step_7.npz")
    np.savez(snap, **{f"param:{k}": v for k, v in params.items()},
             **{"momentum:geometry1.0.weight": params["geometry1.0.weight"] * 0.5}, opt_step=np.asarray(7))
    got, want = ckpt.load_snapshot(snap), jax_ckpt.load_snapshot(snap)
    assert got[2] == want[2] == 7
    for a, b in zip(got[:2], want[:2]):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    pth = str(tmp_path / "model.pth")
    torch.save({k: torch.from_numpy(v) for k, v in ckpt.params_to_torch_state_dict(params).items()}, pth)
    got, want = ckpt.load_pth(pth), jax_ckpt.load_pth(pth)
    assert got.keys() == want.keys() == params.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) and np.array_equal(got[k], params[k])


def test_module_params_inverts_load_jax_params():
    """A detector's parameters under the JAX names and layouts (the ENet's 2D
    convs included) load back unchanged, and hold the fixture's shapes."""
    from tpu3dsis_torch import Detector, load_jax_params, scannet_color_scene_config

    det = Detector(scannet_color_scene_config().replace(TPU_COMPUTE_DTYPE="float32"), device="cpu")
    det.init_params(torch.Generator().manual_seed(0))
    params = ckpt.module_params(det)
    pre = _fixture("color_loop_params.npz")
    assert params.keys() == pre.keys() and all(params[k].shape == pre[k].shape for k in pre)
    before = {k: v.clone() for k, v in det.state_dict().items()}
    load_jax_params(det, params)
    assert all(torch.equal(before[k], v) for k, v in det.state_dict().items())
