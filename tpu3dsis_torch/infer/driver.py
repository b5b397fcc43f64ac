"""Whole-scene test and benchmark drivers with the reference's artifacts
(``tpu3dsis/infer/driver.py``).

Port of the reference's ``SolverWrapper.test``/``benchmark``
(``lib/model/trainval.py:640-941``): per scene, write into
``<TEST_SAVE_DIR>/<scene file name[:12]>/``
  pred_class.npy (int32), pred_conf.npy (float32), pred_box.npy (float32),
  scene.npy (occupancy: encoded |tsdf| <= 1),
  pred_mask (pickle: the kept boxes' box-crop uint8 masks, numpy),
  pred_mask_index (pickle: one True per mask),
  [test mode] gt_class.npy, gt_box.npy, gt_mask (pickle)
and, in test mode, accumulate classification and mask mAP. Benchmark mode
skips scenes whose pred_box.npy exists (a restarted run resumes,
``trainval.py:648-653``).

Scenes go through ``SceneInference`` (tiled, any size) or, with
``TPU_SCENE_MODE="single_shot"``, through ``SingleShotInference`` for the
boxes and the tiled path for the masks. One loader thread reads scene i+1
from disk and starts its upload (and, with frames, its color prep) while
scene i computes. ``TPU_SCENE_TILE_PARALLEL`` > 1 splits each of a scene's
tile batches and mask window calls over that many cards
(``tile_parallel_devices``).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpu3dsis_torch.config import Config, DetectorConfig
from tpu3dsis_torch.eval import DetectionMAP
from tpu3dsis_torch.infer.single_shot import SingleShotInference
from tpu3dsis_torch.infer.tiling import SceneInference
from tpu3dsis_torch.io.dataset import SceneDataset
from tpu3dsis_torch.models.detector import Detector
from tpu3dsis_torch.utils import tracing

STAGES = ("read", "infer", "write", "map")  # each scene's spans driver.<stage>


def _scene_dir(save_dir: str, scene_path: str) -> str:
    """The directory of one scene's artifacts."""
    return os.path.join(save_dir, os.path.basename(scene_path)[:12])


def _write_artifacts(out_dir, sample, det_out, masks, with_masks, test_mode):
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "pred_class.npy"), det_out["pred_class"])
    np.save(os.path.join(out_dir, "pred_conf.npy"), det_out["pred_conf"])
    np.save(os.path.join(out_dir, "pred_box.npy"), det_out["pred_box"])
    np.save(os.path.join(out_dir, "scene.npy"), np.where(sample.data[..., 0] <= 1, 1, 0))
    if with_masks:
        with open(os.path.join(out_dir, "pred_mask"), "wb") as f:
            pickle.dump(masks, f)
        with open(os.path.join(out_dir, "pred_mask_index"), "wb") as f:
            pickle.dump([True] * len(masks), f)
    if test_mode and sample.gt_box.shape[0]:
        np.save(os.path.join(out_dir, "gt_class.npy"), sample.gt_box[:, 6])
        np.save(os.path.join(out_dir, "gt_box.npy"), sample.gt_box[:, :6])
        with open(os.path.join(out_dir, "gt_mask"), "wb") as f:
            pickle.dump(sample.gt_mask, f)


def tile_parallel_devices(cfg: Config, det: Detector) -> list | None:
    """``TPU_SCENE_TILE_PARALLEL`` > 1: the devices each tile batch and mask
    window call of a scene is split over (``SceneInference``'s ``mesh``), the
    detector's card and the next ones, clamped to the cards visible (the JAX
    package clamps to ``jax.devices()``, ``driver.py:58-67``); on the CPU,
    the CPU that many times. None for one device."""
    n = int(dict.get(cfg, "TPU_SCENE_TILE_PARALLEL", 0))
    if det.device.type == "cuda":
        first, count = det.device.index, torch.cuda.device_count()
        n = min(n, count)
        return [torch.device("cuda", (first + i) % count) for i in range(n)] if n > 1 else None
    return [det.device] * n if n > 1 else None


def run_scenes(cfg: Config, det: Detector, mode: str, dataset: SceneDataset | None = None, max_scenes=None,
               with_masks=True, timings: dict | None = None) -> dict:
    """mode: 'test' (gt artifacts and mAP) or 'benchmark' (export only).
    ``det`` holds the weights, on its device. Returns the mAP dict in test
    mode, else {}. ``timings``, if given, gets the seconds each stage took
    summed over the scenes run ("read" in the loader thread, "infer",
    "write", "map": the recorder's ``driver.<stage>`` spans, recorded for
    the run) and the count of scenes ("scenes")."""
    if mode not in ("test", "benchmark"):
        raise ValueError(f"mode must be 'test' or 'benchmark', not {mode!r}")
    save_dir = cfg.TEST_SAVE_DIR
    os.makedirs(save_dir, exist_ok=True)
    if dataset is None:
        dataset = SceneDataset(cfg.TEST_FILELIST, "benchmark" if mode == "benchmark" else "scene", cfg)
    dcfg = DetectorConfig.from_cfg(cfg)
    si = SceneInference(det, dcfg, mesh=tile_parallel_devices(cfg, det))
    shot = SingleShotInference(det, dcfg) if str(dict.get(cfg, "TPU_SCENE_MODE", "tiled")) == "single_shot" else None

    map_cls = DetectionMAP(cfg.NUM_CLASSES, overlap_threshold=cfg.MAP_THRESH, ignore_class=[0])
    map_mask = DetectionMAP(cfg.NUM_CLASSES, overlap_threshold=cfg.MAP_THRESH, ignore_class=[0])
    scenes = 0

    n = len(dataset) if max_scenes is None else min(max_scenes, len(dataset))
    todo = [i for i in range(n)
            if not (mode == "benchmark"
                    and os.path.isfile(os.path.join(_scene_dir(save_dir, dataset.scenes[i]), "pred_box.npy")))]

    def fetch(i):
        with tracing.span("driver.read"):
            s = dataset[i]
        si.prefetch_scene(s.data)
        frames = None
        if cfg.USE_IMAGES and s.images is not None:
            frames = {"images": s.images, "depths": s.depths, "poses": s.poses, "world_to_grid": s.world_to_grid}
            si.prefetch_frames(frames, s.data.shape[:3])
        return s, frames

    since = time.time_ns()
    loader = ThreadPoolExecutor(max_workers=1, thread_name_prefix="scene-load")
    with tracing.recording() if timings is not None else contextlib.nullcontext():
        try:
            pending = loader.submit(fetch, todo[0]) if todo else None
            for pos, idx in enumerate(todo):
                sample, frames = pending.result()
                pending = loader.submit(fetch, todo[pos + 1]) if pos + 1 < len(todo) else None
                with tracing.span("driver.infer"):
                    if shot is None:
                        det_out, masks = (si.infer(sample.data, frames) if with_masks
                                          else (si.detect(sample.data, frames), []))
                    else:
                        det_out = shot.detect(sample.data, frames)
                        masks = si.predict_masks(sample.data, det_out, frames=frames) if with_masks else []
                with tracing.span("driver.write"):
                    _write_artifacts(_scene_dir(save_dir, dataset.scenes[idx]), sample, det_out, masks, with_masks,
                                     mode == "test")
                with tracing.span("driver.map"):
                    if mode == "test" and sample.gt_box.shape[0]:
                        gt_box, gt_cls = sample.gt_box[:, :6], sample.gt_box[:, 6]
                        map_cls.evaluate(det_out["pred_box"], det_out["pred_class"], det_out["pred_conf"], gt_box,
                                         gt_cls)
                        if with_masks:
                            map_mask.evaluate_mask(det_out["pred_box"], det_out["pred_class"], det_out["pred_conf"],
                                                   masks, gt_box, gt_cls, sample.gt_mask, sample.data.shape[:3])
                scenes += 1
        finally:
            loader.shutdown(wait=True)
            si.close()
    if timings is not None:
        timings.update({k: 0.0 for k in STAGES}, scenes=scenes)
        for s in tracing.spans(since):
            stage = s.name[len("driver."):]
            if s.name.startswith("driver.") and stage in STAGES:
                timings[stage] += s.duration_ns / 1e9
    if mode == "test":
        map_cls.finalize()
        results = {"mAP_CLASSIFICATION": map_cls.mAP()}
        if with_masks:
            map_mask.finalize()
            results["mAP_MASK"] = map_mask.mAP()
        print(results)
        return results
    return {}
