"""The port's closed color loop at a tiny size on the CPU
(``tpu3dsis_torch/tools/color_loop.py``; the JAX package's composition test
is ``tests/test_color_loop.py``): generated scenes with their frames on
disk -> two ``Trainer`` steps with the ENet trained, reading the frames
from disk -> ``run_scenes`` in test mode with images from disk -> the
marching-tets mesh, the ScanNet export and the official evaluator, where
the gt pushed through the same export scores AP@0.5 of about 1."""

import os
import sys

import numpy as np

from tpu3dsis_torch.config import default_config
from tpu3dsis_torch.datagen.synthetic_color import scaled_intrinsic
from tpu3dsis_torch.datagen.virtual_scan import intrinsic_from_fov
from tpu3dsis_torch.tools import color_loop

sys.modules.setdefault("torch.utils.tensorboard", None)  # TensorBoard imports TensorFlow where installed, and it JAX

W, H = 64, 48  # frames; ENet features at (8, 6)
# tests/test_color_loop.py's scene
TINY_SCENE = {"extent_m": (4.0, 2.2, 4.0), "n_objects": 5, "voxel_size": 0.1, "image_wh": (W, H),
              "traj_wh": (48, 36), "sample_factor": 24, "chunk_dim": (32, 32, 32)}


def tiny_color_cfg(base_path):
    """``tests/test_color_loop.py::color_loop_cfg`` over conftest's
    ``scannet_cfg``, on the port's config."""
    cfg = default_config()
    cfg.update(NUM_CLASSES=19, NORMALIZE_WEIGHTS=[1.0] * 19, NET="ScanNet_Backbone", MASK_BACKBONE="MaskBackbone",
               NUM_ANCHORS_LEVEL1=3, NUM_ANCHORS_LEVEL2=11, NUM_ANCHORS_LEVEL3=0,
               ANCHORS_TYPE_LEVEL1="scannet14_3.txt", ANCHORS_TYPE_LEVEL2="scannet14_11.txt", CLASS_POOLING_SIZE=4,
               USE_RPN=True, USE_CLASS=True, USE_BACKBONE=True, USE_MASK=True, RPN_POSITIVE_OVERLAP=0.35,
               RPN_NEGATIVE_OVERLAP=0.15, FG_FRACTION=0.5, FG_THRESH=0.5, BG_THRESH=0.2, BG_THRESH_LO=0.0)
    cfg.TRAIN.RPN_NMS_THRESH = 0.5
    cfg.TEST.RPN_NMS_THRESH = 0.1
    cfg.update(LABEL_MAP="experiments/labelmaps/nyu40labels_scannet.csv", USE_IMAGES=True, USE_IMAGES_GT=False,
               NUM_2D_CLASSES=41, IMAGE_TYPE="color", IMAGE_EXT=".jpg", IMAGE_SHAPE=[W, H],
               DEPTH_SHAPE=[W // 8, H // 8], NUM_IMAGE_CHANNELS=128, NUM_IMAGES=2, VOXEL_SIZE=0.1,
               INTRINSIC=scaled_intrinsic(intrinsic_from_fov(W, H), (W, H), (W // 8, H // 8)).tolist(),
               COLOR_MEAN=[0.45, 0.45, 0.45], COLOR_STD=[0.3, 0.3, 0.3], BASE_IMAGE_PATH=base_path, FIX_ENET=False,
               KEEP_THRESH=0.0, MODE="train", RPN_BATCHSIZE=16, CLASS_BATCH_SIZE=8, TPU_MAX_GT=8,
               TPU_MAX_MASK_ROIS=2, TPU_TILE_SIZE=[32, 32, 32], TPU_TILE_STRIDE=[24, 24, 24],
               TPU_MASK_CANVAS=[16, 16, 16], TPU_MASK_INFER_CANVAS=[32, 32, 32],
               TPU_MASK_INFER_CANVAS_SMALL=[16, 16, 16], CLASS_THRESH=0.05, MAP_THRESH=0.25, VAL_TIME=0.0,
               DISPLAY=1, TPU_DATA_PARALLEL=1)
    cfg.TRAIN.RPN_PRE_NMS_TOP_N = 32
    cfg.TRAIN.RPN_POST_NMS_TOP_N = 8
    cfg.TEST.RPN_PRE_NMS_TOP_N = 64
    cfg.TEST.RPN_POST_NMS_TOP_N = 8
    return cfg


def test_color_loop_closes_on_the_cpu(tmp_path):
    from PIL import Image

    from tpu3dsis_torch import checkpoint as ckpt
    from tpu3dsis_torch.config import DetectorConfig
    from tpu3dsis_torch.eval import scannet_benchmark as sb
    from tpu3dsis_torch.infer.driver import run_scenes
    from tpu3dsis_torch.io.dataset import SceneDataset
    from tpu3dsis_torch.models.detector import Detector
    from tpu3dsis_torch.train.loop import Trainer

    out = str(tmp_path)
    chunk_paths, eval_records, stats = color_loop.generate_data(out, n_train=1, n_eval=1, seed=0, max_views=20,
                                                                scene=TINY_SCENE)
    assert chunk_paths and len(eval_records) == 1
    assert [s["chunks"] for s in stats] == [len(chunk_paths), 0] and all(s["views"] > 0 and s["bytes"] > 0
                                                                            for s in stats)
    rec = eval_records[0]
    img = np.array(Image.open(os.path.join(rec["frames_dir"], "color", "0.jpg")))
    assert img.shape == (H, W, 3) and len(np.unique(img.mean(-1).astype(int))) > 10  # shaded, not flat
    assert color_loop.generate_data(out, n_train=1, n_eval=1)[0] == chunk_paths  # the manifest's cache

    cfg = tiny_color_cfg(os.path.join(out, "frames_square"))
    filelist = tmp_path / "train.txt"
    filelist.write_text("".join(p + "\n" for p in chunk_paths))
    cfg.TRAIN_FILELIST = str(filelist)
    cfg.VAL_FILELIST = ""
    sample = SceneDataset(str(filelist), "chunk", cfg)[0]
    assert sample.images is not None and sample.images.shape[1:] == (H, W, 3) and sample.gt_box.shape[0] >= 1

    trainer = Trainer(cfg, os.path.join(out, "run"), device="cpu")
    _, step = trainer.train(epochs=100, max_steps=2)
    assert step == 2 and os.path.isfile(os.path.join(out, "run", "checkpoints", "step_2.npz"))
    params = ckpt.module_params(trainer.detector)
    assert all(np.isfinite(v).all() for v in params.values())

    cfg_t = cfg.copy()
    cfg_t.MODE = "test"
    cfg_t.TEST_SAVE_DIR = os.path.join(out, "res")
    scene_list = tmp_path / "scenes.txt"
    scene_list.write_text(rec["scene_path"] + "\n")
    det = Detector(DetectorConfig.from_cfg(cfg_t), device="cpu")
    ckpt.load_jax_params(det, params)
    sds = SceneDataset(str(scene_list), "scene", cfg_t)
    assert sds[0].images is not None  # the eval scene's frames, from disk
    results = run_scenes(cfg_t, det, "test", dataset=sds)
    assert set(results) == {"mAP_CLASSIFICATION", "mAP_MASK"}

    scene_id = os.path.basename(rec["scene_path"])[:12]
    oracle_dir = os.path.join(out, "res_oracle", scene_id)
    color_loop.write_oracle_predictions(sds[0], oracle_dir)
    ap50 = {}
    for tag, pred_dir in (("trained", os.path.join(out, "res", scene_id)), ("oracle", oracle_dir)):
        pred_file, gt_file = color_loop.benchmark_eval(rec, pred_dir, out, tag=tag)
        avgs = sb.evaluate([pred_file], [gt_file], verbose=False)
        ap50[tag] = avgs["all_ap_50%"]
    assert np.isfinite(ap50["trained"]) or np.isnan(ap50["trained"])
    assert ap50["oracle"] >= 0.99, ap50
