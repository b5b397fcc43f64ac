"""The golden path on synthetic data (``tools/demo.py``, what
``example.sh --synthetic`` runs), on the port:

datagen (TSDF fusion -> ``.scene`` file and the fused mesh) -> whole-scene
tiled inference through ``run_scenes`` -> artifacts -> PLY views.

Run from the repository root:

    python -m tpu3dsis_torch.tools.demo --out example_result [--checkpoint path.npz|path.pth] [--device cpu]

The detector starts from a seeded random init, or from ``--checkpoint``
through ``partial_update``; it runs on the CUDA card unless ``--device cpu``.
"""

import argparse
import os


def fuse_demo_scene(out_dir):
    """Fuse four synthetic depth frames of a box in front of a wall into a
    TSDF, write its ``.scsdf``/``.aabbs`` and ``.scene`` files and the fused
    isosurface; returns the ``.scene`` path (``tools/demo.py``'s step 1)."""
    import numpy as np

    from tpu3dsis_torch.datagen import scene_sampler as ss
    from tpu3dsis_torch.datagen import tsdf_fusion as tf
    from tpu3dsis_torch.datagen.marching_tets import grid_to_mesh
    from tpu3dsis_torch.tools.ply import write_ply

    voxel = 0.046875
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 289.0
    K[0, 2], K[1, 2] = 160, 120
    frames = []
    for step in range(4):
        pose = np.eye(4)
        pose[0, 3] = 0.5 + step * 0.8
        pose[2, 3] = -1.2
        depth = np.full((240, 320), 1.6, np.float32)
        depth[80:160, 100:220] = 1.2  # a box-shaped object
        label = np.zeros((240, 320), np.uint8)
        label[80:160, 100:220] = 5  # chair
        inst = ((label > 0) * 2).astype(np.uint8)
        frames.append((K, pose, depth, label, inst))
    bbox = ((0.0, -0.8, -0.4), (3.5, 0.8, 0.8))
    grid, _ = tf.fuse_scene(frames, bbox, voxel_size=voxel)
    scsdf = os.path.join(out_dir, "demo.scsdf")
    tf.save_scsdf(scsdf, grid.sdf, voxel, *bbox)
    # instance boxes from the fused instance volume
    occ = np.array(np.nonzero(grid.instance == 2))
    lo, hi = occ.min(axis=1), occ.max(axis=1) + 1
    mask, _, _ = grid.instance_mask_for_aabb(np.concatenate([lo, hi]), 2)
    aabbs = os.path.join(out_dir, "demo.aabbs")
    tf.save_aabbs(aabbs, np.concatenate([lo, hi])[None], np.array([5]), [mask])
    scene_file = os.path.join(out_dir, "demo__scene.scene")
    ss.process_scene(scsdf, aabbs, scene_file)
    # the fused TSDF's isosurface (the reference's s_bDebugOut dump)
    mverts, mfaces = grid_to_mesh(grid)
    write_ply(os.path.join(out_dir, "demo_fused.ply"), mverts, faces=mfaces)
    return scene_file


def demo_config(out_dir, scene_file):
    """benchmark.yml without images, with the demo's thresholds, reading
    ``scene_file`` and writing under ``out_dir/test``."""
    from tpu3dsis_torch.config import cfg_from_file, finalize_config

    cfg = cfg_from_file("experiments/cfgs/ScanNet/benchmark.yml")
    finalize_config(cfg)
    cfg.USE_IMAGES = False
    cfg.TEST_SAVE_DIR = os.path.join(out_dir, "test")
    cfg.CLASS_THRESH = 0.05
    cfg.TEST.RPN_PRE_NMS_TOP_N = 256
    cfg.TEST.RPN_POST_NMS_TOP_N = 32
    filelist = os.path.join(out_dir, "scenes.txt")
    with open(filelist, "w") as f:
        f.write(scene_file + "\n")
    cfg.TEST_FILELIST = filelist
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="example_result")
    p.add_argument("--checkpoint", default=None, help=".npz or .pth")
    p.add_argument("--device", default="cuda", help="cuda (the default), or cpu for tests")
    args = p.parse_args(argv)

    import torch

    from tpu3dsis_torch import checkpoint as ckpt
    from tpu3dsis_torch.config import DetectorConfig
    from tpu3dsis_torch.infer.driver import run_scenes
    from tpu3dsis_torch.models.detector import Detector
    from tpu3dsis_torch.tools.visualization import visualize_result

    os.makedirs(args.out, exist_ok=True)
    print("[demo] fusing synthetic scene ...")
    scene_file = fuse_demo_scene(args.out)
    print(f"[demo] wrote {scene_file}")
    print(f"[demo] fused-TSDF mesh: {os.path.join(args.out, 'demo_fused.ply')}")

    cfg = demo_config(args.out, scene_file)
    det = Detector(DetectorConfig.from_cfg(cfg), device=args.device)
    det.init_params(torch.Generator().manual_seed(0))
    if args.checkpoint:
        pre = (ckpt.load_pth(args.checkpoint) if args.checkpoint.endswith(".pth")
               else ckpt.load_snapshot(args.checkpoint)[0])
        ckpt.load_jax_params(det, ckpt.partial_update(ckpt.module_params(det), pre, cfg))
    print("[demo] running whole-scene tiled inference ...")
    results = run_scenes(cfg, det, "test")

    scene_dir = os.path.join(cfg.TEST_SAVE_DIR, os.path.basename(scene_file)[:12])
    vis_dir = os.path.join(args.out, "vis")
    visualize_result(scene_dir, vis_dir)
    print(f"[demo] artifacts: {scene_dir}")
    print(f"[demo] plys:      {vis_dir}")
    print(f"[demo] metrics:   {results}")
    return results


if __name__ == "__main__":
    main()
