"""The closed color loop at the reference's scale, on the port
(``tools/color_loop_check.py``'s flow): generated data -> ENet color
training -> tiled color scene inference -> marching tets -> the ScanNet
export and its official evaluator.

  1. ``generate_data`` writes train and eval scenes with their frames to
     disk (``datagen/synthetic_color.py``: shaded RGB-D virtual scans, TSDF
     fusion, SceneSampler chunks and scenes);
  2. the ``Trainer`` trains from those ``.chunk`` files with
     ``FIX_ENET: False`` in bfloat16, reading the frames from disk;
  3. ``run_scenes`` runs test mode on the eval scenes, images from disk;
  4. ``benchmark_eval``: the fused TSDF's isosurface (marching tets) with
     per-vertex gt ids from the fused label and instance grids, the
     predictions exported onto it and ``evaluate``d.

Run from the repository root:

    python -m tpu3dsis_torch.tools.color_loop --steps 800 [--out data/color_loop] [--fixture path.npz]
        [--load path.npz] [--max-views 64]

on the CUDA card.

Scenes are cached under ``--out`` (delete it to regenerate). Trained
parameters are saved to ``--fixture`` (default ``<out>/color_loop_params.npz``,
float16, the JAX package's parameter names) with a provenance sidecar;
``--load`` skips training and serves such a file. Exits 0 when the trained
detector's AP@0.5 is finite and above 0.
"""

import argparse
import os
import pickle
import sys

W, H = 328, 256  # rendered frame resolution (the reference's IMAGE_SHAPE)
# generate_scene's settings for the loop's rooms (tools/color_loop_check.py:77-82)
SCENE = {"extent_m": (6.0, 2.4, 6.0), "n_objects": 12, "voxel_size": 0.046875, "image_wh": (W, H),
         "traj_wh": (64, 48), "sample_factor": 48, "num_nearest": 5}


def build_cfg(base_path, steps=800, lr=0.003):
    """``tools/color_loop_check.py::build_cfg``: benchmark.yml with frames
    under ``base_path``, the ENet trained from scratch, bfloat16."""
    from tpu3dsis_torch.config import cfg_from_file, finalize_config
    from tpu3dsis_torch.datagen.synthetic_color import scaled_intrinsic
    from tpu3dsis_torch.datagen.virtual_scan import intrinsic_from_fov

    cfg = cfg_from_file("experiments/cfgs/ScanNet/benchmark.yml")
    finalize_config(cfg)
    cfg.BASE_IMAGE_PATH = base_path
    cfg.INTRINSIC = scaled_intrinsic(intrinsic_from_fov(W, H), (W, H), tuple(cfg.DEPTH_SHAPE)).tolist()
    cfg.PRETRAINED_ENET_PATH = ""
    cfg.FIX_ENET = False  # no pretrained ENet: train it
    cfg.FIX_BACKBONE = cfg.FIX_RPN = cfg.FIX_CLASS = False
    cfg.LEARNING_RATE = lr
    cfg.STEPSIZE = [int(steps * 0.7)]
    cfg.VAL_TIME = 0.0
    cfg.DISPLAY = 50
    cfg.KEEP_THRESH = 0.0
    cfg.TRAIN.RPN_PRE_NMS_TOP_N = 512
    cfg.TRAIN.RPN_POST_NMS_TOP_N = 64
    cfg.TEST.RPN_PRE_NMS_TOP_N = 256
    cfg.TEST.RPN_POST_NMS_TOP_N = 32
    cfg.CLASS_THRESH = 0.3
    cfg.ROI_THRESH = 0.5
    cfg.MAP_THRESH = 0.5
    cfg.NUM_IMAGES = 5
    cfg.TPU_MAX_MASK_ROIS = 4
    cfg.TPU_DATA_PARALLEL = 1
    cfg.TPU_COMPUTE_DTYPE = "bfloat16"
    return cfg


def _tree_bytes(paths) -> int:
    """Bytes of the files at and under ``paths``."""
    total = 0
    for p in paths:
        if os.path.isdir(p):
            total += sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(p) for f in files)
        elif os.path.exists(p):
            total += os.path.getsize(p)
    return total


def _generate_one(job):
    """One scene of ``generate_data``, in a worker process: (its stats, its
    chunk paths, its eval record or None)."""
    import time

    import numpy as np

    from tpu3dsis_torch.datagen.synthetic_color import generate_scene

    out_root, name, rng_seed, max_views, chunks, settings = job
    t0 = time.perf_counter()
    out = generate_scene(np.random.RandomState(rng_seed), out_root, name, max_views=max_views, chunks=chunks,
                         **settings)
    stats = {"name": name, "seconds": time.perf_counter() - t0, "views": len(out["poses"]),
             "chunks": len(out["chunk_paths"]),
             "bytes": _tree_bytes([out["frames_dir"], out["scene_path"], out["scsdf"], out["aabbs"],
                                   *out["chunk_paths"]])}
    record = None if chunks else {"scene_path": out["scene_path"], "frames_dir": out["frames_dir"],
                                  "scsdf": out["scsdf"], "world_to_grid": out["world_to_grid"],
                                  "label": out["grid"].label, "instance": out["grid"].instance}
    return stats, out["chunk_paths"], record


def generate_data(out_root, n_train=5, n_eval=2, seed=11, max_views=64, scene=None):
    """Generate (and cache in ``out_root/manifest.pkl``) ``n_train`` scenes
    with chunks and ``n_eval`` without; returns (chunk paths, eval records,
    each scene's {name, seconds, views, chunks, bytes}). ``scene`` overrides
    ``SCENE``'s settings.

    Scene i draws from ``RandomState([seed, i])`` (the JAX tool draws every
    scene from one ``RandomState(seed)`` in turn), so the scenes are made at
    once, one process each up to the host's cores: the datagen is numpy on
    one core a scene."""
    import multiprocessing

    os.makedirs(out_root, exist_ok=True)
    manifest = os.path.join(out_root, "manifest.pkl")
    if os.path.exists(manifest):
        with open(manifest, "rb") as f:
            return pickle.load(f)  # this function's own file

    settings = {**SCENE, **(scene or {})}
    jobs = [(out_root, f"synth{i:02d}", [seed, i], max_views, i < n_train, settings) for i in range(n_train + n_eval)]
    print(f"[color-loop] generating scenes {[j[1] for j in jobs]} ...", flush=True)
    with multiprocessing.get_context("spawn").Pool(min(len(jobs), os.cpu_count() or 1)) as pool:
        done = pool.map(_generate_one, jobs)
    chunk_paths, eval_records, stats = [], [], []
    for scene_stats, chunks, record in done:
        stats.append(scene_stats)
        chunk_paths.extend(chunks)
        if record is not None:
            eval_records.append(record)
        print(f"[color-loop] {scene_stats['name']}: {scene_stats['seconds']:.1f} s, {scene_stats['views']} views, "
              f"{scene_stats['chunks']} chunks, {scene_stats['bytes']:,} bytes", flush=True)
    data = (chunk_paths, eval_records, stats)
    with open(manifest, "wb") as f:
        pickle.dump(data, f)
    return data


def benchmark_eval(rec, pred_dir, tmp_dir, tag=""):
    """vox2mesh and the official evaluator's inputs for one generated scene:
    the fused TSDF's isosurface with per-vertex gt ids (label * 1000 +
    instance) from the fused grids, the predictions of ``pred_dir`` exported
    onto it. Returns (prediction file, gt file) for ``evaluate``."""
    import numpy as np

    from tpu3dsis_torch.datagen.marching_tets import extract_isosurface
    from tpu3dsis_torch.datagen.tsdf_fusion import load_scsdf
    from tpu3dsis_torch.eval import scannet_benchmark as sb
    from tpu3dsis_torch.tools.ply import write_ply

    scene_id = os.path.basename(rec["scene_path"])[:12]
    sdf_grid, _, _, _ = load_scsdf(rec["scsdf"])
    verts_grid, faces = extract_isosurface(sdf_grid, band=2.0)
    vi = np.clip(np.floor(verts_grid).astype(int), 0, np.asarray(rec["label"].shape) - 1)
    vlabel = rec["label"][vi[:, 0], vi[:, 1], vi[:, 2]].astype(np.int64)
    vinst = rec["instance"][vi[:, 0], vi[:, 1], vi[:, 2]].astype(np.int64)
    gt_ids = np.where(vinst > 0, vlabel * 1000 + vinst, vlabel)
    homo = np.concatenate([verts_grid, np.ones((len(verts_grid), 1))], 1)
    verts_world = (np.linalg.inv(rec["world_to_grid"]) @ homo.T).T[:, :3]
    mesh_file = os.path.join(tmp_dir, f"{scene_id}.ply")
    write_ply(mesh_file, verts_world.astype(np.float32), faces=faces.tolist())

    bench_dir = os.path.join(tmp_dir, f"bench{tag}_{scene_id}")
    sb.export_scene(pred_dir, mesh_file, os.path.join(rec["frames_dir"], "world2grid.txt"), bench_dir, scene_id)
    sb.remap_benchmark_labels(bench_dir)
    gt_file = os.path.join(tmp_dir, f"gt_{scene_id}.txt")
    np.savetxt(gt_file, gt_ids, fmt="%d")
    return os.path.join(bench_dir, f"{scene_id}.txt"), gt_file


def write_oracle_predictions(sample, pred_dir):
    """A scene's gt (boxes, classes, masks) written as its predictions, at
    confidence 0.95: pushed through ``benchmark_eval`` they must score
    AP@0.5 of about 1 (``tests/test_color_loop.py``'s oracle leg)."""
    import numpy as np

    os.makedirs(pred_dir, exist_ok=True)
    np.save(os.path.join(pred_dir, "pred_box.npy"), sample.gt_box[:, :6])
    np.save(os.path.join(pred_dir, "pred_class.npy"), sample.gt_box[:, 6].astype(np.int64))
    np.save(os.path.join(pred_dir, "pred_conf.npy"), np.full(len(sample.gt_box), 0.95, np.float32))
    with open(os.path.join(pred_dir, "pred_mask"), "wb") as f:
        pickle.dump([m.astype(np.uint8) for m in sample.gt_mask], f)
    with open(os.path.join(pred_dir, "pred_mask_index"), "wb") as f:
        pickle.dump([True] * len(sample.gt_mask), f)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--lr", type=float, default=0.003)
    p.add_argument("--out", default="data/color_loop")
    p.add_argument("--fixture", default=None, help="where the trained parameters go (default <out>/color_loop_params.npz)")
    p.add_argument("--load", default="", help="serve a saved parameter file instead of training")
    p.add_argument("--max-views", type=int, default=64)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from tpu3dsis_torch import checkpoint as ckpt
    from tpu3dsis_torch.config import DetectorConfig
    from tpu3dsis_torch.eval import scannet_benchmark as sb
    from tpu3dsis_torch.infer.driver import run_scenes
    from tpu3dsis_torch.io.dataset import SceneDataset
    from tpu3dsis_torch.models.detector import Detector
    from tpu3dsis_torch.train.loop import Trainer
    from tpu3dsis_torch.utils.provenance import write_provenance

    # float32 computes in float32, as the JAX package does (main.py's setting)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = build_cfg(os.path.join(args.out, "frames_square"), args.steps, args.lr)
    chunk_paths, eval_records, _ = generate_data(args.out, max_views=args.max_views)
    print(f"[color-loop] {len(chunk_paths)} train chunks, {len(eval_records)} eval scenes")
    filelist = os.path.join(args.out, "train.txt")
    with open(filelist, "w") as f:
        f.write("".join(c + "\n" for c in chunk_paths))

    if args.load:
        params = {k: np.asarray(v, np.float32) for k, v in np.load(args.load).items()}
    else:
        cfg.TRAIN_FILELIST = filelist
        cfg.VAL_FILELIST = filelist
        cfg.TRAINVAL_FILELIST = ""
        trainer = Trainer(cfg, os.path.join(args.out, "run"))
        trainer.train(epochs=100_000, max_steps=args.steps)
        params = ckpt.module_params(trainer.detector)
        fixture = args.fixture or os.path.join(args.out, "color_loop_params.npz")
        os.makedirs(os.path.dirname(os.path.abspath(fixture)), exist_ok=True)
        np.savez_compressed(fixture, **{k: v.astype(np.float16) for k, v in params.items()})
        write_provenance(fixture, command=(f"python -m tpu3dsis_torch.tools.color_loop --steps {args.steps}"
                                           f" --lr {args.lr} --max-views {args.max_views}"),
                         cfg=cfg, args={"steps": args.steps, "lr": args.lr, "max_views": args.max_views, "seed": 0})
        print(f"[color-loop] parameters saved: {fixture}")

    # --- eval: tiled color scene inference and the chunk-style mAP ----------
    cfg_t = cfg.copy()
    cfg_t.MODE = "test"
    cfg_t.TEST_SAVE_DIR = os.path.join(args.out, "res")
    scene_list = os.path.join(args.out, "scenes.txt")
    with open(scene_list, "w") as f:
        f.write("".join(r["scene_path"] + "\n" for r in eval_records))
    cfg_t.TEST_FILELIST = scene_list
    det = Detector(DetectorConfig.from_cfg(cfg_t))
    ckpt.load_jax_params(det, params)
    results = run_scenes(cfg_t, det, "test", dataset=SceneDataset(scene_list, "scene", cfg_t))
    print(f"[color-loop] chunk-style eval: {results}")

    # --- the official benchmark on the generated meshes ---------------------
    pred_files, gt_files = [], []
    for rec in eval_records:
        scene_id = os.path.basename(rec["scene_path"])[:12]
        pf, gf = benchmark_eval(rec, os.path.join(cfg_t.TEST_SAVE_DIR, scene_id), args.out)
        pred_files.append(pf)
        gt_files.append(gf)
    avgs = sb.evaluate(pred_files, gt_files, verbose=True)
    ap50, ap25 = float(avgs["all_ap_50%"]), float(avgs["all_ap_25%"])
    print(f"[color-loop] official AP@0.5={ap50:.4f} AP@0.25={ap25:.4f}")
    ok = np.isfinite(ap50) and ap50 > 0
    print("[color-loop]", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
