#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's chunk and whole-scene paths, its test and
benchmark drivers, its training (the ENet's and SUNCG's included) and the
closed color loop from generated files on disk on one NVIDIA card.

Run from the repository root, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero; without CUDA it exits 1 and prints no
result):
  0. environment: the card, its power limit, versions;
  1. build the CUDA kernels from ``tpu3dsis_torch/csrc``, one nvcc per source,
     all in parallel;
  2. each kernel against its plain PyTorch version, exactly (``torch.equal``):
     K1 at main-path shapes with the level maps passed separately, on levels
     of two spatial shapes, and with NaN voxels; K2 at N = 400 and 1024, and
     at a negative threshold;
  3. the main path: ``Detector`` with the trained geometry weights
     (``tests/fixtures/tiling_parity_params.npz``) on 32 synthetic 96x48x96
     chunks, in float32 and bfloat16, through ``build_inference_fn``; both
     kernels' launch counters must rise, and each call must be one launch;
  4. the card against the CPU on one chunk (float32, TF32 off), and bfloat16
     against float32 under the decision-stability contract of
     ``tests/test_bf16_stability.py``;
  5. timing: chunks/s at batch 32, per-stage ms, each kernel against its
     plain version and its bound, and a profile of the bf16 batch;
  6. the scene path: ``SceneInference.infer`` with the trained detector and
     the trained mask head (``mask_backbone.*`` of
     ``tests/fixtures/color_loop_params.npz``) on 240x48x240 scenes of 24
     objects (25 tiles each), as ``bench.py::bench_masked_scene`` runs it:
     every K1 and K2 call of one scene, recorded with its arguments in each
     dtype, against its plain version, and K2's class-aware mode on
     synthetic boxes; 4 scenes in float32 and bfloat16, each served by the
     fused path, with the kernels' launches counted (K2's from a device
     trace: the chain after the tiles replays as a CUDA graph); the card against the
     CPU on a 144x48x144 scene; bfloat16
     against float32; masked scenes/min over a prefetched stream of 8,
     ``device_seconds``, per-stage ms, K2 class-aware against its plain
     version and its bound, and a profile of one bf16 scene;
  7. the color scene path: ``SceneInference.infer(scene, frames)`` with the
     whole trained color detector (``tests/fixtures/color_loop_params.npz``,
     ENet included; ``bench.py::bench_color_scene``'s configuration) on
     240x48x240 rooms of 24 objects with 32, 96, 144 and 200 views (depth
     ray-cast, RGB shaded, made here with numpy): every kernel call of one
     scene recorded and held against its plain version (K3's resident
     volume, K1, K2), the share of (brick, view) pairs K3's cull keeps on
     the resident call, K3 on the per-tile path's calls and on its edge cases;
     the path in both dtypes, each scene served by the fused path, launches
     counted (K2's from a device trace, as in 6); the card against the CPU on a 144x48x144 room with 16 views;
     bfloat16 against float32; color masked scenes/min over a prefetched
     stream of 8, ``device_seconds``, prep ms by view count (upload, ENet,
     K3), per-stage ms, K3 against its plain version and its bound, and a
     profile of one bf16 scene with its prep;
  8. the test and benchmark drivers: three 240x48x240 scenes of 24 objects
     written as ``.scene`` files (nyu40 labels, masks), an overlay of
     ``experiments/cfgs/ScanNet/benchmark.yml`` without images and a
     ``param:`` snapshot of phase 6's weights; ``python -m
     tpu3dsis_torch.main --mode test`` in a process of its own (its launch
     counts start at 0 and are printed at its end: K1, K2 and K2
     class-aware must rise), then ``--mode benchmark`` twice (the second
     skips every scene); every artifact loaded in a process without torch;
     the first scene through ``run_scenes`` on the CPU (float32, TF32 off)
     gives the same detections within 1e-4 voxels as the entry module, and
     the same mAP as ``run_scenes`` on the card over it; the
     color stream through ``run_scenes`` on phase 7's rooms as in-memory
     samples with frames (every count set to 0 before, read after; K3's
     call of one room held against its plain version); driver scenes/min
     and ms per scene of read and encode, infer, artifact writes and mAP
     for both streams;
  9. training: one geometry step on the card against the CPU (float32,
     TF32 off, the same weights, batch and draws; losses within 1e-3, the
     updated parameters within 1e-4); ``build_train_step`` at full width,
     bf16, on a fixed batch of ``bench.py::bench_train``'s synthetic chunks,
     30 steps of ``scannet_train_config()`` at batch 8 and of its color
     variant (5 views a chunk, frozen ENet, K3) at batch 4, every count set
     to 0 before and read after (K1, K1b, K2, and K3 for color must rise),
     total_loss falling and every step finite; s/iter and chunks/s (the
     CUDA-event median), peak memory, ms by stage (forward, targets,
     backward, update) and the idle share of a profile; every kernel call
     of one step of each held against its plain version; K1b in float32
     and bf16 on the training calls, phase 2's rois and its edge cases
     (ties, empty bins, map edges, overlapping rois, 2,100 rois on one
     brick, rois covering the whole map; disjoint bins exactly), two
     launches bit for bit on the training calls and phase 2's rois, its
     time on both in both dtypes (and its two kernels' split) beside its
     bytes bound, its plain time, and what its bricks repeat; then ``python -m
     tpu3dsis_torch.main --mode train`` on a corpus of `.chunk` files
     (pretrained from phase 6's weights), a second run that resumes from
     its snapshot, and ``--mode test --step`` on that snapshot;
 10. training the ENet through the view fusion (``FIX_ENET: False``) and
     SUNCG: K3b against its plain version (autograd of ``fuse_views_plain``,
     within 1e-5 of the largest gradient) on every call of a recorded
     trainable-ENet step (bench_train's color batch, 5 views, 96x48x96x128,
     float32), on edge cases (tied duplicated views, exact zeros, an
     invalid view) and on a 32-view room of phase 7 with exact-zero
     features; its time beside its bound and its plain time, its kernels'
     microseconds from a profile, and whether two launches are
     ``torch.equal``; one float32 step card vs CPU (phase 9's contract, the
     ENet's parameters included); 30 bf16 steps of
     ``scannet_train_config(color=True)`` with ``FIX_ENET: False`` at batch
     4, counted (K3 and K3b every step), finite with a falling loss, with
     s/iter, stages, peak memory and the idle share; then
     ``suncg_train_config()`` (the shipped SUNCG yml): 10 bf16 steps at
     batch 4, finite, counted; its chunk detection with the color stream on
     one chunk's frames, card vs CPU in float32, and bf16 chunks/s at batch
     32;
 11. the mask FCN's color branch (``MASK_USE_IMAGES``, on
     ``scannet_color_scene_config()``; the fixture's weights where the
     shapes match, the new branches' from a seed): every K1, K2 and K3 call
     of one fused room against its plain version, and K3 on the per-window
     route's calls (each mask window fusing its own views with
     ``zero_floor``); phase 7's rooms in both dtypes through the fused
     route, counted, with peak memory per room; bfloat16 against float32
     under the color contract, mask agreement logged; on a 144x48x144 room
     of 16 views (no window meets more than the view cap), float32, the
     fused route, the host-planned route on the resident volume and the
     per-window route give the same masks, and the card agrees with the
     CPU; color masked scenes/min with and without the branch, stages;
     training with the branch and the ENet trained: a float32 step card vs
     CPU (phase 9's contract), 30 bf16 steps counted (K3 a sample and K3b
     once a step), the step's K3b call against its plain version; the
     color-only backbone (``ONLY_IMAGES``) serving two rooms and training 3
     steps with the ENet trained, counted; and the port's benchmark export
     (``export_scene``, ``evaluate``, ``remap_benchmark_labels``) of phase
     8's test-mode artifacts;
 12. several devices, on the one card: data-parallel training, two ranks
     spawned on cuda:0 over a gloo group of this script's own (NCCL takes
     one rank a device), each on 4 of phase 9's 8 chunks with its own
     draws, ``scannet_train_config()`` in float32 (TF32 off): 3 steps
     against one process at batch 8 with the same draws (losses within 1e-4
     relative, parameters within 1e-4 of their magnitude), the ranks'
     parameters equal, K1, K1b and K2 counted on each rank; then 10 bf16
     steps, finite with the loss falling, s/iter beside one process's; the
     entry module's train mode under ``torchrun --nproc_per_node 1`` (an
     NCCL group of one, its all-reduce on the card, rank 0's snapshot);
     ``USE_RPN: False`` training (3 bf16 steps, no RPN parameter, K1 and
     K1b counted); ``SceneInference`` with the device list [cuda:0, cuda:0]
     on phase 6's scenes in both dtypes (tile batches of 32 and 8) and on
     one of phase 7's rooms, ``torch.equal`` to one device's, every K1 and
     K2 call of one scene against its plain version, K1, K2, class-aware K2
     and K3 counted, scenes/min beside one device's; and
     ``spatial_single_shot`` on 2 and 4 shards of cuda:0 against the port's
     single-shot scene (float32, TF32 off: features within 1e-5 of their
     largest value, detections IoU-matched at 0.5 with the same class),
     K1 and K2 counted, each call of one run against its plain version.

 13. the closed color loop from files on disk (``python -m
     tpu3dsis_torch.tools.color_loop``'s flow at
     ``tools/color_loop_check.py``'s settings: benchmark.yml, 328x256 frames, 5
     images a chunk, 96x48x96 chunks, ``FIX_ENET: False``, bf16), in a fresh
     temporary directory: (a) the port's datagen on the host writes 2 train
     scenes with chunks and 1 eval scene with their frames, a process each
     (seconds, views, chunks and bytes a scene), and a small scene twice from
     one seed, every file's sha256 equal; (b) ``python -m tpu3dsis_torch.main
     --mode train`` for 20 steps from those chunks, frames read from disk
     (losses finite, a snapshot, K1, K1b, K2, K3 and K3b counted), then one
     step in process on a batch the loader read from disk, every kernel call
     recorded and held against its plain version (K3 exactly, K3b within
     ``K3B_TOL``); (c) ``--mode test`` from that snapshot on the eval scene
     with images from disk (``check_artifacts``, the mAP; K1, K2, class-aware
     K2, K3 counted), and ``run_scenes`` in process with every call recorded
     and held against its plain version; (d) marching tets, the ScanNet export
     and ``evaluate`` of the predictions (AP finite) and of the gt pushed
     through the same export (AP@0.5 above 0.5, the JAX package's test's bar);
     (e) ``python -m tpu3dsis_torch.tools.demo`` and its PLYs, run beside (a);
     (f) ``PrefetchLoader`` on the generated chunks with a geometry overlay,
     the numpy path and the native decoder (batches ``np.array_equal``),
     chunks/s of each beside phase 9's train step; (g) ``coord_conv3d`` (within
     1e-5) and one autoencoder ``train_step`` on (4, 256, 328, 3) (loss and
     parameters within 1e-4 of their magnitude), card against CPU in float32.

``--phases 9`` (a comma-separated list) runs only those phases after 0 and
1, for work on one phase, and prints no result line (``--phases 11`` runs
phase 8 first; 6, 7, 9, 10, 11, 12 and 13 can run so). The last three lines
of a whole run are the kernels' JSON, the card's name and power limit as
``nvidia-smi`` reports them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import contextlib
import importlib.util
import inspect
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from tpu3dsis_torch import (Detector, SceneInference, _build, build_inference_fn, load_jax_params,
                            scannet_chunk_config, scannet_color_scene_config, scannet_scene_config)
from tpu3dsis_torch.geometry import projection
from tpu3dsis_torch.geometry.boxes import nms_overlap
from tpu3dsis_torch.infer.color_volume import build_color_volume
from tpu3dsis_torch.models.backbones import FEAT_STRIDE
from tpu3dsis_torch.models.detector import device_anchors
from tpu3dsis_torch.models.rpn import select_proposals
from tpu3dsis_torch.ops import nms
from tpu3dsis_torch.ops import roi_pool3d as rp
from tpu3dsis_torch.utils import tracing
from tpu3dsis_torch.utils.profiling import cuda_ms, device_ms, host_ms

SHAPE = (96, 48, 96)
BATCH = 32
TRAINED = "tests/fixtures/tiling_parity_params.npz"
COLOR_FIXTURE = "tests/fixtures/color_loop_params.npz"  # the trained color detector, ENet included
MASK_HEAD = COLOR_FIXTURE  # its mask_backbone.* keys: the trained mask FCN
SCENE_EXTENT = (240, 48, 240)
SCENE_SMALL = (144, 48, 144)  # the card-vs-CPU scene, to bound the CPU's time
CARD = ""  # "<name>, <power limit>" from nvidia-smi, set in main()
CLOCK_MHZ = 0.0  # the card's highest SM clock from nvidia-smi, set in main()
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, float32 FLOP/s
# outside the tensor cores (the kernels' compares and IoUs run there)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0].strip()


# --- synthetic chunks (tools/tiling_parity_check.py:30-57, encoded inline) --


def _add_object(sdf, boxes, rng, kind, lo=(2, 2, 2), hi=(94, 46, 94)):
    if kind == "sofa":
        sx, sy, sz = 53, rng.randint(18, 23), rng.randint(20, 25)
        if rng.rand() < 0.5:
            sx, sz = sz, sx
    elif kind == "chair":
        sx, sy, sz = rng.randint(10, 15), rng.randint(9, 14), rng.randint(10, 15)
    else:
        sx, sy, sz = rng.randint(16, 22), rng.randint(4, 7), rng.randint(16, 22)
    for _ in range(50):
        x0 = rng.randint(lo[0], max(hi[0] - sx, lo[0] + 1))
        y0 = rng.randint(lo[1], max(hi[1] - sy, lo[1] + 1))
        z0 = rng.randint(lo[2], max(hi[2] - sz, lo[2] + 1))
        x1, y1, z1 = x0 + sx, y0 + sy, z0 + sz
        if np.any(sdf[x0:x1, y0:y1, z0:z1] < 1.0):
            continue  # overlap: retry
        sdf[x0:x1, y0:y1, z0:z1] = 0.3
        sdf[x0 + 1:x1 - 1, y0 + 1:y1 - 1, z0 + 1:z1 - 1] = -2.0
        boxes.append([x0, y0, z0, x1, y1, z1])
        return


def make_chunks(rng, n):
    """n chunks (n, 96, 48, 96, 2) encoded as io/dataset.py:41 encode_tsdf
    (TRUNCATED 3, no flip, no log), and each chunk's object boxes."""
    scenes, gts = [], []
    for _ in range(n):
        sdf = np.full(SHAPE, 8.0, np.float32)
        boxes = []
        for kind in ("sofa", "chair", "chair", "table"):
            _add_object(sdf, boxes, rng, kind)
        scenes.append(encode_tsdf(sdf))
        gts.append(np.asarray(boxes, np.float32))
    return np.stack(scenes).astype(np.float32), gts


def encode_tsdf(sdf):
    """io/dataset.py:41 encode_tsdf with TRUNCATED 3, no flip, no log."""
    return np.stack([np.abs(np.clip(sdf, -3.0, 3.0)), (sdf > -1).astype(np.float32)], -1).astype(np.float32)


def scene_objects(rng, extent=SCENE_EXTENT, n_objects=24):
    """A scene as tools/tiling_parity_check.py:89 make_scene draws it (about a
    third 53-voxel sofas): its raw sdf, its object boxes and each box's kind."""
    sdf = np.full(extent, 8.0, np.float32)
    boxes, placed = [], []
    kinds = ["sofa"] * (n_objects // 3)
    kinds += ["chair", "table"] * ((n_objects - len(kinds)) // 2 + 1)
    for kind in kinds[:n_objects]:
        n = len(boxes)
        _add_object(sdf, boxes, rng, kind, (2, 2, 2), tuple(e - 2 for e in extent))
        placed += [kind] * (len(boxes) - n)
    return sdf, np.asarray(boxes, np.float32), placed


def make_scene(rng, extent=SCENE_EXTENT, n_objects=24):
    """``scene_objects``' scene encoded, and its object boxes."""
    sdf, boxes, _ = scene_objects(rng, extent, n_objects)
    return encode_tsdf(sdf), boxes


def iou(a, b):
    """(N, 6) x (K, 6) plain-extent IoU (tpu3dsis/geometry/boxes.py:105)."""
    lo = np.maximum(a[:, None, :3], b[None, :, :3])
    hi = np.minimum(a[:, None, 3:], b[None, :, 3:])
    inter = np.clip(hi - lo, 0, None).prod(-1)
    va = (a[:, 3:] - a[:, :3]).prod(-1)
    vb = (b[:, 3:] - b[:, :3]).prod(-1)
    return inter / (va[:, None] + vb[None, :] - inter)


def detections(out, i, class_thresh=0.3, stitch_thresh=0.25):
    """Chunk i's detections as ``SceneInference.detect`` reports them
    (tpu3dsis/infer/tiling.py:907-960): valid, non-degenerate, not
    background, conf above CLASS_THRESH (0.3 in tools/tiling_parity_check.py),
    then class-aware greedy NMS at IoU 0.25 (+1 extents) by confidence."""
    o = {k: (v.float() if v.is_floating_point() else v)[i].cpu().numpy() for k, v in out.items()}
    keep = o["valid"] & ~o["degenerate"] & (o["cls_pred"] > 0) & (o["pred_conf"] > class_thresh)
    box, cls, conf = o["pred_box"][keep], o["cls_pred"][keep], o["pred_conf"][keep]
    ov = nms_overlap(torch.from_numpy(box), torch.from_numpy(box)).numpy()
    suppressed = np.zeros(len(box), bool)
    kept = []
    for j in np.argsort(-conf, kind="stable"):
        if not suppressed[j]:
            kept.append(j)
            suppressed |= (cls == cls[j]) & (ov[j] > stitch_thresh)
    return box[kept], cls[kept], conf[kept]


# --- bounds: the least time the card could take for a kernel's work --------


def k1_bound(feats, rois, batch_idx, level_idx, scales, pooled):
    """K1's bound in ms and its bytes: each covered voxel of the level maps
    read once (the voxels the rois' bins cover, a union over the batch), the
    rois and indices read once, the (M, C, P^3) output written once, over
    the HBM rate. Its compares (one per bin voxel and channel) take far
    less at the float32 rate, so bytes bound it."""
    r = rois.float().cpu().numpy()
    lv, bi = level_idx.cpu().numpy(), batch_idx.cpu().numpy()
    c, itemsize = feats[0].shape[-1], feats[0].element_size()
    covered = 0
    for level, (f, s) in enumerate(zip(feats, scales)):
        ext = np.asarray(f.shape[1:4])
        lo = np.floor(r[:, :3] * np.float32(s)).astype(np.int64)
        hi = np.ceil(r[:, 3:] * np.float32(s)).astype(np.int64)
        a = np.clip(lo, 0, ext)
        e = np.clip(lo + np.maximum(hi - lo, 1), 0, ext)  # the union of the roi's bins
        grid = np.zeros((f.shape[0], *ext), bool)
        for i in np.flatnonzero((lv == level) & (bi >= 0) & (bi < f.shape[0])):
            grid[bi[i], a[i, 0]:e[i, 0], a[i, 1]:e[i, 1], a[i, 2]:e[i, 2]] = True
        covered += int(grid.sum())
    m = len(r)
    nbytes = covered * c * itemsize + m * (6 * 4 + 2 * 4) + m * c * pooled**3 * itemsize
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def k1_loaded_bytes(feats, rois, batch_idx, level_idx, scales, pooled):
    """Bytes K1's loads ask of L1 and L2: each column of bins (px, py) loads
    its x-bin by y-bin rectangle once for every z of its z-bins' union, 16
    bytes of channels at a time, whatever of it L1 or L2 already holds."""
    r = rois.float().cpu()
    lv, bi = level_idx.cpu(), batch_idx.cpu()
    c, itemsize = feats[0].shape[-1], feats[0].element_size()
    voxels = 0
    for level, (f, s) in enumerate(zip(feats, scales)):
        sel = (lv == level) & (bi >= 0) & (bi < f.shape[0])
        if not bool(sel.any()):
            continue
        s = torch.tensor(s, dtype=torch.float32)
        lo = torch.floor(r[sel, :3] * s).to(torch.int32)
        hi = torch.ceil(r[sel, 3:] * s).to(torch.int32)
        ax = [rp._bin_bounds(lo[:, d], hi[:, d], pooled, e) for d, e in enumerate(f.shape[1:4])]
        nx, ny = ((e - st).clamp(min=0).sum(1).long() for st, e in ax[:2])
        nz = (ax[2][1][:, -1] - ax[2][0][:, 0]).clamp(min=0).long()
        voxels += int((nx * ny * nz).sum())
    return voxels * c * itemsize


def k2_bound(boxes, valid, classes=None):
    """K2's bound in ms, its bound_by, and its latency floor in steps: the
    boxes and valid flags (and classes) read and the keep mask written once
    (bytes), or the IoU tests of every valid pair i < j (of one class, when
    class-aware: the others need none) at 21 float32 operations each, after
    each box's volume, 8, at the float32 rate (operations); the greedy walk's
    N steps depend one on another besides."""
    b, n = valid.shape
    nv = valid.sum(1).double()
    if classes is None:
        pairs = nv * (nv - 1) / 2
    else:
        same = (classes[:, :, None] == classes[:, None, :]) & valid[:, :, None] & valid[:, None, :]
        pairs = (same.sum((1, 2)).double() - nv) / 2
    ops = float((pairs * 21 + nv * 8).sum())
    nbytes = b * n * (6 * 4 + 1 + 1 + (4 if classes is not None else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes"), n


# --- phase 2 ------------------------------------------------------------------


def _rois(rng, batch, per_chunk, extent=(96, 48, 96)):
    """Rois on a mix of levels: some past the volume (clamped and empty
    bins), some on its borders."""
    m = batch * per_chunk
    lo = rng.uniform(-8, 90, (m, 3)) * [1, 0.5, 1]
    hi = lo + rng.uniform(0.5, 60, (m, 3))
    rois = np.concatenate([lo, hi], 1)
    inside = rng.rand(m) < 0.7
    rois[inside] = np.clip(rois[inside], 0, [*extent, *extent])
    rois[::17, :3] = 0  # on the near borders
    rois[5::17, 3:] = extent  # on the far borders
    return dict(
        rois=torch.from_numpy(rois.astype(np.float32)),
        batch_idx=torch.arange(batch, dtype=torch.int32).repeat_interleave(per_chunk),
        level_idx=torch.from_numpy(rng.randint(0, 2, m).astype(np.int32)),
    )


def _boxes(rng, batch, n):
    """n score-ordered boxes per chunk, about 10% invalid."""
    lo = rng.uniform(0, 90, (batch, n, 3)) * [1, 0.5, 1]
    boxes = np.concatenate([lo, lo + rng.uniform(2, 50, (batch, n, 3))], -1)
    return dict(boxes=torch.from_numpy(boxes.astype(np.float32)), valid=torch.from_numpy(rng.rand(batch, n) > 0.1))


def kernel_inputs(dev, rng, batch=BATCH, rois_per_chunk=200, boxes_per_chunk=400):
    """Main-path shapes: two (batch, 24, 12, 24, 128) level maps, 200 rois
    per chunk, and 400 score-ordered boxes per chunk."""
    feats = torch.randn((2, batch, 24, 12, 24, 128), generator=torch.Generator().manual_seed(0))
    k1 = {k: v.to(dev) for k, v in _rois(rng, batch, rois_per_chunk).items()}
    k1.update(scales=[0.25, 0.25], pooled=4)
    k2 = {k: v.to(dev) for k, v in _boxes(rng, batch, boxes_per_chunk).items()}
    return feats.to(dev), k1, k2


def _k1_case(name, feats, k1, nan_ok=False, phase=2):
    """K1 against its plain version on one input; with NaN voxels, the NaN
    positions first, then the rest exactly."""
    got = rp.roi_pool3d_cuda(feats, **k1)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = rp.roi_pool3d_plain(feats, **k1)
    end.record()
    end.synchronize()
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    check(torch.equal(nan_got, nan_want), f"K1 {name}: NaN at other outputs than its plain version")
    check(nan_ok or not bool(nan_want.any()), f"K1 {name}: NaN in the output")
    same = torch.equal(got.masked_fill(nan_got, 0), want.masked_fill(nan_want, 0))
    err = float((got.float() - want.float()).abs().nan_to_num(0.0).max())
    n_empty = int((want == 0).flatten(1).all(1).sum())
    log(f"[{phase}] K1 {name} {tuple(got.shape)}: exact={same} max_abs_err={err} NaN outputs={int(nan_want.sum())} "
        f"all-zero rois={n_empty} plain {start.elapsed_time(end):.1f} ms [{CARD}]")
    check(same, f"K1 {name} differs from its plain version")
    return err, start.elapsed_time(end), int(nan_want.sum())


def phase_kernels(dev, rng, batch=BATCH):
    feats, k1, k2 = kernel_inputs(dev, rng, batch)
    res = {"roi_pool3d_cuda": {"err": 0.0}, "nms3d_cuda": {"err": 0.0}}
    r1 = res["roi_pool3d_cuda"]
    # the two level maps of the main path, passed as two tensors
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        err, plain_ms, _ = _k1_case(f"{name} main-path shapes", list(feats.to(dt).unbind(0)), k1)
        r1["err"] = max(r1["err"], err)
        r1[f"plain_ms_{name}"] = plain_ms
    # two levels of different spatial shapes and strides
    small = 8
    g = torch.Generator().manual_seed(1)
    shaped = [torch.randn((small, 24, 12, 24, 128), generator=g), torch.randn((small, 12, 6, 12, 128), generator=g)]
    k1s = {k: v.to(dev) for k, v in _rois(rng, small, 200).items()}
    k1s.update(scales=[0.25, 0.125], pooled=4)
    for dt in (torch.float32, torch.bfloat16):
        err, _, _ = _k1_case(f"{str(dt).split('.')[-1]} levels 24x12x24 + 12x6x12",
                             [f.to(dev, dt) for f in shaped], k1s)
        r1["err"] = max(r1["err"], err)
    # NaN voxels: one channel of some voxels, every channel of one voxel
    nanned = feats[:, :4].clone()
    nanned[0, 0, 5, 3, 7, 11] = nanned[1, 1, 20, 9, 2, 100] = nanned[0, 2, 12, 6, 12, 64] = float("nan")
    nanned[1, 3, 3, 1, 3, :] = float("nan")
    k1n = {k: v.to(dev) for k, v in _rois(rng, 4, 200).items()}
    k1n.update(scales=[0.25, 0.25], pooled=4)
    for dt in (torch.float32, torch.bfloat16):
        _, _, n_nan = _k1_case(f"{str(dt).split('.')[-1]} with NaN voxels", list(nanned.to(dt).unbind(0)), k1n,
                               nan_ok=True)
        check(n_nan > 0, "K1 NaN case: no roi covers a NaN voxel")

    r2 = res["nms3d_cuda"]
    cases = {400: k2, 1024: {k: v.to(dev) for k, v in _boxes(rng, batch, 1024).items()}}
    for n, boxes in cases.items():
        # a negative thresh sends non-overlapping pairs down K2's division path
        for thresh in (0.1, 0.5, -0.5) if n == 400 else (0.1, 0.5):
            got = nms.nms3d_cuda(boxes["boxes"], thresh, boxes["valid"])
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = nms.nms_mask_plain(boxes["boxes"], thresh, boxes["valid"])
            end.record()
            end.synchronize()
            err = float((got.int() - want.int()).abs().max())
            r2["err"] = max(r2["err"], err)
            r2[f"plain_ms_{n}_{thresh}"] = start.elapsed_time(end)
            log(f"[2] K2 nms3d N={n} thresh={thresh} {tuple(got.shape)}: kept={int(got.sum())} "
                f"mismatches={int((got != want).sum())} plain {start.elapsed_time(end):.1f} ms [{CARD}]")
            check(torch.equal(got, want), f"K2 at N={n}, {thresh} differs from its plain version")
    return res, (feats, k1, cases)


# --- phases 3 and 4 -------------------------------------------------------------


def load_detectors(dev):
    cfg32 = scannet_chunk_config()
    cfg16 = cfg32.replace(TPU_COMPUTE_DTYPE="bfloat16")
    det32 = load_jax_params(Detector(cfg32, device=dev), TRAINED)
    det16 = load_jax_params(Detector(cfg16, device=dev), TRAINED)
    return (cfg32, det32), (cfg16, det16)


def device_launches():
    lib = _build.load_library()
    return {"roi_pool3d_cuda": lib.tpu3dsis_roi_pool3d_launches(), "nms3d_cuda": lib.tpu3dsis_nms3d_launches(),
            "fuse_views_cuda": lib.tpu3dsis_fuse_views_launches(),
            "roi_pool3d_backward_cuda": lib.tpu3dsis_roi_pool3d_bwd_launches(),
            "fuse_views_backward_cuda": lib.tpu3dsis_fuse_views_bwd_launches()}


def traced_k2_launches(prof):
    """K2's kernels in a ``torch.profiler`` trace of the card: {nms3d_cuda:
    every K2 kernel, nms3d_cuda_class_aware: those with classes}. On a path
    whose chain after the tiles replays as a CUDA graph (``SceneInference``
    on one card without ``MASK_USE_IMAGES``) the stitch's class-aware K2
    launches on every replay without a wrapper call, and its capture calls
    the wrapper without a launch: there the wrapper's counts are calls, and
    the launches are read here."""
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"nms3d_cuda": sum("nms3d_kernel<" in n for n in names),
            "nms3d_cuda_class_aware": sum("nms3d_kernel<true>" in n for n in names)}


def reset_launch_counts():
    """Every wrapper's launch count to 0 (just before a path is driven)."""
    rp.roi_pool3d_cuda.launches = 0
    rp.roi_pool3d_backward_cuda.launches = 0
    nms.nms3d_cuda.launches = 0
    nms.nms3d_cuda.class_aware_launches = 0
    projection.fuse_views_cuda.launches = 0
    projection.fuse_views_backward_cuda.launches = 0


def phase_main_path(dev, scenes, gts, dets, batches=3):
    (cfg32, det32), (cfg16, det16) = dets
    infer32 = build_inference_fn(det32, cfg32, SHAPE)
    infer16 = build_inference_fn(det16, cfg16, SHAPE)
    x = torch.from_numpy(scenes).to(dev)
    reset_launch_counts()
    before = device_launches()
    outs = {}
    for name, infer in (("float32", infer32), ("bfloat16", infer16)):
        for _ in range(batches):
            outs[name] = infer(x)
    torch.cuda.synchronize()
    launches = {"roi_pool3d_cuda": rp.roi_pool3d_cuda.launches, "nms3d_cuda": nms.nms3d_cuda.launches}
    kernel_launches = {k: v - before[k] for k, v in device_launches().items() if k in launches}
    per_batch = {k: v / (2 * batches) for k, v in kernel_launches.items()}
    log(f"[3] main path: {2 * batches} batches of {len(scenes)} chunks; wrapper calls {launches}, "
        f"kernel launches {kernel_launches}, launches per batch {per_batch}")
    for name, out in outs.items():
        for k, v in out.items():
            check(v.shape[0] == len(scenes), f"{name} {k} has no batch dimension")
            if v.is_floating_point():
                check(bool(torch.isfinite(v).all()), f"{name} {k} is not finite")
        n_valid = out["valid"].sum(1).cpu().numpy()
        conf, recalls = [], []
        for i, gt in enumerate(gts):
            box, _, c = detections(out, i)
            confident = box[c >= 0.5]
            conf.append(len(confident))
            recalls.append((iou(gt, confident).max(1) >= 0.25).mean() if len(confident) else 0.0)
        n = len(scenes)
        log(f"[3] {name}: valid proposals per chunk min={n_valid.min()} mean={n_valid.mean():.1f}; "
            f"confident (conf>=0.5) detections per chunk mean={np.mean(conf):.2f}; "
            f"object recall at IoU 0.25 = {np.mean(recalls):.3f}")
        check((n_valid > 0).sum() >= 0.9 * n, f"{name}: too many chunks without proposals")
        check((np.asarray(conf) > 0).sum() >= 0.9 * n, f"{name}: too many chunks without confident detections")
        check(np.mean(recalls) >= 0.5, f"{name}: object recall below 0.5")
    for k, v in launches.items():
        check(v > 0, f"{k} was not launched on the main path")
        check(kernel_launches[k] == v, f"{k}: {kernel_launches[k]} kernel launches for {v} calls, not one each")
    return outs, launches, per_batch


def _match_rows(a_rois, a_lvl, b_rois, b_lvl, tol):
    """One-to-one match of valid rois, order-free (a swap of two near-tied
    scores reorders proposals without changing the set). Returns pairs."""
    used = np.zeros(len(b_rois), bool)
    pairs = []
    for i in range(len(a_rois)):
        d = np.abs(b_rois - a_rois[i]).max(1)
        d[used | (b_lvl != a_lvl[i])] = np.inf
        j = int(np.argmin(d)) if len(d) else -1
        check(j >= 0 and d[j] <= tol, f"roi {a_rois[i]} has no counterpart within {tol} voxels")
        used[j] = True
        pairs.append((i, j))
    return pairs


def compare_chunk_outputs(card, cpu, label, phase):
    """One chunk's detections on the card and the CPU, float32 with TF32
    off: the same valid proposals (order-free), rois and boxes within 1e-3
    voxels, class probabilities and confidences within 1e-4."""
    card = {k: v.cpu() for k, v in card.items()}
    vc, vp = card["valid"].numpy(), cpu["valid"].numpy()
    check(np.array_equal(vc, vp), f"valid differs: {vc.sum()} on the card, {vp.sum()} on the CPU")
    rc, rpu = card["rois"].numpy()[vc], cpu["rois"].numpy()[vp]
    lc, lp = card["level_inds"].numpy()[vc], cpu["level_inds"].numpy()[vp]
    in_order = np.array_equal(lc, lp) and np.abs(rc - rpu).max(initial=0) <= 1e-3
    pairs = _match_rows(rc, lc, rpu, lp, 1e-3)
    ic, ip = (np.array([p[k] for p in pairs], int) for k in (0, 1))
    errs = {}
    # float32 both sides, TF32 off: only the conv sum order differs
    for key, tol in (("rois", 1e-3), ("cls_prob", 1e-4), ("pred_box", 1e-3), ("pred_conf", 1e-4)):
        d = np.abs(card[key].numpy()[vc][ic] - cpu[key].numpy()[vp][ip]).max(initial=0)
        errs[key] = float(d)
        check(d <= tol, f"card vs CPU {key} differs by {d} > {tol}")
    log(f"[{phase}] card vs CPU, {label}, float32, TF32 off: {int(vc.sum())} valid proposals, "
        f"same order={in_order}, max abs diff {errs} [{CARD}]")
    return errs


def phase_card_vs_cpu(scene, dets, cpu_det, outs):
    cfg32, det32 = dets[0]
    card = build_inference_fn(det32, cfg32, SHAPE)(torch.from_numpy(scene))
    cpu = build_inference_fn(cpu_det, cfg32, SHAPE)(torch.from_numpy(scene))
    compare_chunk_outputs(card, cpu, "one chunk", phase=4)

    # bfloat16 against float32 on the card: the contract of
    # test_bf16_stability.py:53-88, over the batch as one scene (its slack,
    # n // 8, is sized for a scene of ~24 objects; a single chunk of 4 has
    # none to give, and the JAX package's own bf16 chunk path already turns
    # one split sofa into one whole on these chunks)
    worst = 0.0
    matched = n_hi = n_hi16 = 0
    for i in range(len(outs["float32"]["valid"])):
        b32, c32, p32 = detections(outs["float32"], i)
        b16, c16, p16 = detections(outs["bfloat16"], i)
        hi32, hi16 = p32 >= 0.9, p16 >= 0.9
        a, b = b32[hi32], b16[hi16]
        n_hi += len(a)
        n_hi16 += len(b)
        if not (len(a) and len(b)):
            continue
        ov = iou(a, b)
        used = np.zeros(len(b), bool)
        for r in range(len(a)):
            row = np.where(used, -1.0, ov[r])
            j = int(np.argmax(row))
            if row[j] >= 0.5:
                used[j] = True
                matched += 1
                check(c32[hi32][r] == c16[hi16][j], f"chunk {i}: class flipped in bf16")
                worst = max(worst, abs(float(p32[hi32][r]) - float(p16[hi16][j])))
    slack = max(1, n_hi // 8)
    check(matched >= n_hi - slack, f"only {matched}/{n_hi} confident detections matched in bf16")
    check(n_hi16 - matched <= slack, f"bf16 added {n_hi16 - matched} unmatched confident detections")
    check(worst <= 0.1, f"bf16 confidence drift {worst} > 0.1")
    log(f"[4] bf16 vs float32 decision stability over {len(outs['float32']['valid'])} chunks: "
        f"{matched}/{n_hi} confident float32 detections matched at IoU 0.5 with the same class "
        f"({n_hi16} confident in bf16, slack {slack}), max conf drift {worst:.4f} [{CARD}]")


# --- phase 5 --------------------------------------------------------------------


def main_path_rois(feats, prop):
    """K1's arguments on the main path: the two level maps and the batch's
    proposals, as ``roi_pool3d_multilevel`` passes them."""
    b, r = prop["rois"].shape[:2]
    dev = prop["rois"].device
    return [feats[1], feats[2]], dict(
        rois=prop["rois"].reshape(-1, 6).float().contiguous(),
        batch_idx=torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(r),
        level_idx=(prop["level_inds"].reshape(-1).to(torch.int32) - 1).contiguous(),
        scales=[0.25, 0.25], pooled=4)


def main_path_kernel_inputs(cfg, det, x):
    """(level maps, K1 arguments) of one batch on the main path."""
    t = cfg.TEST
    with torch.inference_mode():
        feats = det.features(x)
        prop = select_proposals(det.rpn_forward(feats), device_anchors(det, SHAPE), SHAPE, t.RPN_PRE_NMS_TOP_N,
                                t.RPN_POST_NMS_TOP_N, t.RPN_NMS_THRESH)
    return main_path_rois(feats, prop)


def profile_batch(infer, x, batches=3):
    """Device time per batch by kernel name, and the device's idle share,
    from torch.profiler over `batches` batches after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    infer(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(batches):
            infer(x)
        end.record()
        end.synchronize()
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / batches
    busy = sum(by_name.values())
    window = start.elapsed_time(end) / batches
    return busy, window, sorted(by_name.items(), key=lambda kv: -kv[1])


def phase_timing(dev, scenes, dets, kernel_data, iters=10):
    feats_k, k1, k2_cases = kernel_data
    x = torch.from_numpy(scenes).to(dev)
    kernels = {}
    for cfg, det in dets:
        name = cfg.TPU_COMPUTE_DTYPE
        infer = build_inference_fn(det, cfg, SHAPE)
        ms = cuda_ms(lambda: infer(x), iters, warmup=3)
        anchors = device_anchors(det, SHAPE)
        t = cfg.TEST
        with torch.inference_mode():
            feats = det.features(x)
            rpn = det.rpn_forward(feats)
            prop = select_proposals(rpn, anchors, SHAPE, t.RPN_PRE_NMS_TOP_N, t.RPN_POST_NMS_TOP_N, t.RPN_NMS_THRESH)
            levels, own = main_path_rois(feats, prop)
            pool = rp.roi_pool3d_multilevel(levels, prop["rois"], prop["level_inds"], 4, [0.25, 0.25])
            pool5 = pool.reshape(-1, *pool.shape[2:])

            def classifier():
                fc7 = det.classify(pool5)
                return det.classifier_cls_score_net(fc7), det.classifier_bbox_pred_net(fc7)

            stages = {
                "backbone": cuda_ms(lambda: det.features(x), iters),
                "rpn_heads": cuda_ms(lambda: det.rpn_forward(feats), iters),
                "proposals_incl_nms": cuda_ms(lambda: select_proposals(
                    rpn, anchors, SHAPE, t.RPN_PRE_NMS_TOP_N, t.RPN_POST_NMS_TOP_N, t.RPN_NMS_THRESH), iters),
                "roi_pool": cuda_ms(lambda: rp.roi_pool3d_multilevel(
                    levels, prop["rois"], prop["level_inds"], 4, [0.25, 0.25]), iters),
                "classifier_mlp": cuda_ms(classifier, iters),
            }
            bound, nbytes = k1_bound(levels, **own)
            k1_own = device_ms(lambda: rp.roi_pool3d_cuda(levels, **own), 20)
            loaded = k1_loaded_bytes(levels, **own)
        log(f"[5] {name} batch {len(scenes)}: {ms:.3f} ms/batch = {len(scenes) * 1000.0 / ms:.1f} chunks/s "
            f"(median of {iters}, TF32 off) [{CARD}]")
        log(f"[5] {name} per-stage ms: " + json.dumps({k: round(v, 4) for k, v in stages.items()}) + f" [{CARD}]")
        log(f"[5] {name} roi_pool stage on the main path's rois: {stages['roi_pool']:.4f} ms; K1 alone "
            f"{k1_own:.4f} ms device time, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s), "
            f"{bound / k1_own:.3f} of it; its loads ask {loaded / 1e9:.3f} GB of L1/L2, "
            f"{loaded / k1_own / 1e9:.2f} TB/s [{CARD}]")
        kernels[f"k1_{name}_main_path_rois"] = k1_own
        if name == "bfloat16":
            busy, window, top = profile_batch(infer, x)
            log(f"[5] {name} profile: device busy {busy:.3f} ms per batch of a {window:.3f} ms window, idle share "
                f"{1 - busy / window:.3f}; top kernels (ms per batch): "
                + json.dumps({k[:60]: round(v, 4) for k, v in top[:12]}) + f" [{CARD}]")

    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        f = list(feats_k.to(dt).unbind(0))
        kernels[f"k1_{name}"] = device_ms(lambda: rp.roi_pool3d_cuda(f, **k1), 20)
        kernels[f"k1_{name}_bound"] = k1_bound(f, **k1)[0]
        kernels[f"k1_{name}_load_tb_per_s"] = k1_loaded_bytes(f, **k1) / kernels[f"k1_{name}"] / 1e9
    for n, boxes in k2_cases.items():
        for thresh in (0.1, 0.5):
            kernels[f"k2_{n}_{thresh}"] = device_ms(lambda: nms.nms3d_cuda(boxes["boxes"], thresh, boxes["valid"]), 50)
        kernels[f"k2_{n}_0.1_events_per_call"] = cuda_ms(
            lambda: nms.nms3d_cuda(boxes["boxes"], 0.1, boxes["valid"]), 50)
        bound, bound_by, steps = k2_bound(boxes["boxes"], boxes["valid"])
        kernels[f"k2_{n}_bound"] = bound
        kernels[f"k2_{n}_bound_by"] = bound_by
        # N dependent steps of the walk, each at least 4 dependent integer
        # operations of 4 cycles, at the card's highest SM clock
        kernels[f"k2_{n}_latency_floor"] = steps * 16 / (CLOCK_MHZ * 1e3) if CLOCK_MHZ else "not measured"
    kernels["k2_plain_0.1"] = cuda_ms(lambda: nms.nms_mask_plain(k2_cases[400]["boxes"], 0.1, k2_cases[400]["valid"]),
                                      3, warmup=1)
    log("[5] kernel ms at main-path shapes (K1: phase 2's 6400 rois, and the main path's own, on 2x32x24x12x24x128; "
        "K2: 32x400 and 32x1024 boxes), device time of calls queued back to back, bounds from these inputs: "
        + json.dumps({k: (round(v, 5) if isinstance(v, float) else v) for k, v in kernels.items()}) + f" [{CARD}]")
    return kernels


# --- phase 6: the scene path -------------------------------------------------------


def scene_params():
    """The trained detector and the trained mask head, as one JAX param dict."""
    with np.load(TRAINED) as d:
        params = {k: d[k] for k in d.files}
    with np.load(MASK_HEAD) as d:
        params.update({k: d[k] for k in d.files if k.startswith("mask_backbone.")})
    return params


def scene_inference(dev, dtype, params):
    cfg = scannet_scene_config().replace(TPU_COMPUTE_DTYPE=dtype)
    return SceneInference(load_jax_params(Detector(cfg, device=dev), params), cfg)


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return [_copy(v) for v in x]
    return x


def recorded_kernel_calls(si, scene, frames=None, fused=True):
    """Every call that one ``si.infer(scene, frames)`` makes to K1's, K2's
    and K3's wrappers (``recording_kernel_calls``)."""
    with recording_kernel_calls() as calls:
        si.infer(scene, frames)
    check(si.last_fused == fused, f"the recorded scene was {'not ' * fused}served by the fused path")
    return calls


@contextlib.contextmanager
def recording_kernel_calls():
    """Within the block, every call to K1's, K1b's, K2's, K3's and K3b's wrappers, from any
    thread, with copies of its arguments, in call order: [(kind, {argument:
    value})], kind the wrapper's name or "class-aware" for K2 with classes.
    The wrappers are wrapped for the block only. A call made while the
    stream captures a CUDA graph (``SceneInference``'s chain after the
    tiles) is not recorded: its arguments hold no values yet."""
    calls = []
    wrapped = ((rp, "roi_pool3d_cuda"), (rp, "roi_pool3d_backward_cuda"), (nms, "nms3d_cuda"),
               (projection, "fuse_views_cuda"), (projection, "fuse_views_backward_cuda"))
    originals = [getattr(mod, name) for mod, name in wrapped]

    def recorder(fn):
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            kind = "class-aware" if bound.arguments.get("classes") is not None else fn.__name__
            calls.append((kind, {k: _copy(v) for k, v in bound.arguments.items()}))
            return fn(*args, **kwargs)

        call.__dict__ = fn.__dict__  # the wrapper counts its launches in fn's counters
        return call

    for (mod, name), fn in zip(wrapped, originals):
        setattr(mod, name, recorder(fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in zip(wrapped, originals):
            setattr(mod, name, fn)


def check_recorded_k1_k2(calls, label, phase):
    """Each recorded K1 and K2 call against its plain version; the largest
    error of each kind."""
    errs = {"k1_err": 0.0, "k2_err": 0.0, "class_aware_err": 0.0}
    for kind, args in calls:
        if kind == "roi_pool3d_cuda":
            args = dict(args)
            feats = args.pop("feats")
            err, _, _ = _k1_case(f"{label}, {args['rois'].shape[0]} rois on levels {[tuple(f.shape) for f in feats]}",
                                 feats, args, phase=phase)
            errs["k1_err"] = max(errs["k1_err"], err)
        elif kind == "nms3d_cuda":
            errs["k2_err"] = max(errs["k2_err"], _k2_case(f"{label} proposals", **args, phase=phase))
        elif kind == "class-aware":
            errs["class_aware_err"] = max(errs["class_aware_err"], _k2_case(f"{label} stitch", **args, phase=phase))
    return errs


def _k2_case(name, boxes, thresh, valid, classes=None, phase=6):
    """K2 against its plain version on one input, class-aware given classes."""
    got = nms.nms3d_cuda(boxes, thresh, valid, classes)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = nms.nms_mask_plain(boxes, thresh, valid, classes)
    end.record()
    end.synchronize()
    kind = "class-agnostic" if classes is None else "class-aware"
    other = "" if classes is None else f" (class-agnostic would keep {int(nms.nms_mask_plain(boxes, thresh, valid).sum())})"
    log(f"[{phase}] K2 {kind} {name} {tuple(got.shape)} thresh {thresh}: kept={int(got.sum())}{other} of "
        f"{int(valid.sum())} valid, mismatches={int((got != want).sum())}, plain {start.elapsed_time(end):.1f} ms "
        f"[{CARD}]")
    check(torch.equal(got, want), f"K2 {kind} {name} differs from its plain version")
    return float((got.int() - want.int()).abs().max())


def mask_agreement(box_a, mask_a, box_b, mask_b):
    """Share of voxels that differ between two boxes' masks, over their
    overlap in scene coords (None without overlap)."""
    ra, rb = np.round(box_a).astype(int), np.round(box_b).astype(int)
    lo, hi = np.maximum(ra[:3], rb[:3]), np.minimum(ra[3:], rb[3:])
    if np.any(hi <= lo):
        return None
    a = mask_a[tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, ra[:3]))]
    b = mask_b[tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, rb[:3]))]
    return float((a != b).mean())


def match_detections(a, b, iou_thresh=0.5):
    """Greedy one-to-one IoU match of detection dicts a -> b (plain extents)."""
    if not (len(a["pred_box"]) and len(b["pred_box"])):
        return []
    ov = iou(a["pred_box"], b["pred_box"])
    used = np.zeros(len(b["pred_box"]), bool)
    pairs = []
    for r in range(len(a["pred_box"])):
        row = np.where(used, -1.0, ov[r])
        j = int(np.argmax(row))
        if row[j] >= iou_thresh:
            used[j] = True
            pairs.append((r, j))
    return pairs


def bf16_vs_fp32(outs, n_scenes, phase, iou_thresh=0.5, max_drift=0.1, slack_div=8):
    """bfloat16 against float32, scene by scene: test_bf16_stability.py's
    contract on the detections (its defaults; its color-trained case
    loosens them to IoU 0.25, drift 0.3 and a quarter of the set churning,
    test_bf16_stability.py:190-200); mask agreement on matched pairs is
    printed."""
    flips, matched_all, n_hi_all, drift = [], 0, 0, 0.0
    for (d32, m32), (d16, m16) in zip(outs["float32"], outs["bfloat16"]):
        hi32, hi16 = d32["pred_conf"] >= 0.9, d16["pred_conf"] >= 0.9
        a = {k: v[hi32] for k, v in d32.items()}
        b = {k: v[hi16] for k, v in d16.items()}
        pairs = match_detections(a, b, iou_thresh)
        n_hi = int(hi32.sum())
        slack = max(1, n_hi // slack_div)
        check(len(pairs) >= n_hi - slack, f"bf16 matched only {len(pairs)}/{n_hi} confident detections")
        check(int(hi16.sum()) - len(pairs) <= slack, "bf16 added unmatched confident detections")
        i32, i16 = np.nonzero(hi32)[0], np.nonzero(hi16)[0]
        for i, j in pairs:
            check(a["pred_class"][i] == b["pred_class"][j], "class flipped in bf16")
            drift = max(drift, abs(float(a["pred_conf"][i]) - float(b["pred_conf"][j])))
            f = mask_agreement(a["pred_box"][i], m32[i32[i]], b["pred_box"][j], m16[i16[j]])
            if f is not None:
                flips.append(f)
        matched_all += len(pairs)
        n_hi_all += n_hi
    check(drift <= max_drift, f"bf16 confidence drift {drift} > {max_drift}")
    log(f"[{phase}] bf16 vs float32 over {n_scenes} scenes: {matched_all}/{n_hi_all} confident detections matched at "
        f"IoU {iou_thresh} with the same class (slack n // {slack_div} per scene), max conf drift {drift:.4f}; masks "
        f"of matched pairs differ in "
        f"{np.mean(flips) if flips else 0.0:.4f} of their voxels on average (max "
        f"{np.max(flips) if flips else 0.0:.4f}; printed, not gated) [{CARD}]")


def phase_scene(dev, params, n_scenes=4):
    from torch.profiler import ProfilerActivity, profile

    sis = {dt: scene_inference(dev, dt, params) for dt in ("float32", "bfloat16")}
    scenes, gts = zip(*[make_scene(np.random.RandomState(7 + i)) for i in range(n_scenes)])
    res = {"err": 0.0, "k1_err": 0.0, "k2_err": 0.0}

    # K1 and K2 on the scene path's own arguments: every call one infer() of
    # scene 0 makes, in each dtype, against its plain version
    with torch.inference_mode():
        for dt, si in sis.items():
            calls = recorded_kernel_calls(si, scenes[0])
            kinds = [kind for kind, _ in calls]
            check(sorted(set(kinds)) == ["class-aware", "nms3d_cuda", "roi_pool3d_cuda"],
                  f"{dt}: the scene path called {kinds}")
            errs = check_recorded_k1_k2(calls, f"{dt} scene path", phase=6)
            for k in ("k1_err", "k2_err"):
                res[k] = max(res[k], errs[k])
            res["err"] = max(res["err"], errs["class_aware_err"])
            if dt == "float32":
                args = next(a for kind, a in calls if kind == "class-aware")
                res["stitch_input"] = (args["boxes"], args["valid"], args["classes"])

        # K2 class-aware on score-ordered synthetic boxes of 18 classes
        rng = np.random.RandomState(3)
        for b in (1, 4):
            bx = _boxes(rng, b, 1024)
            case = (bx["boxes"].to(dev), bx["valid"].to(dev),
                    torch.from_numpy(rng.randint(1, 19, (b, 1024)).astype(np.int32)).to(dev))
            res["err"] = max(res["err"], _k2_case(f"synthetic {b}x1024", case[0], 0.25, case[1], case[2]))
            if b == 1:
                res["synthetic_1x1024"] = case

    # the path: every count set to 0 just before, read just after. The
    # stitch's class-aware K2 runs in the chain after the tiles, which a
    # bucket's rooms after its second replay as a CUDA graph: its wrapper is
    # called once for each eager chain and once for each capture, and the
    # device trace holds one class-aware K2 kernel a scene
    reset_launch_counts()
    before = device_launches()
    outs = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof, tracing.recording():
        tracing.clear()
        for dt, si in sis.items():
            outs[dt] = []
            for s in scenes:
                det, masks = si.infer(s)
                check(si.last_fused, f"{dt}: a scene fell back to the host-planned path")
                outs[dt].append((det, masks))
        torch.cuda.synchronize()
    names = [sp.name for sp in tracing.spans()]
    tracing.clear()
    calls = {"roi_pool3d_cuda": rp.roi_pool3d_cuda.launches, "nms3d_cuda": nms.nms3d_cuda.launches,
             "nms3d_cuda_class_aware": nms.nms3d_cuda.class_aware_launches}
    library_calls = {k: v - before[k] for k, v in device_launches().items() if k in calls}
    launches = {"roi_pool3d_cuda": calls["roi_pool3d_cuda"], **traced_k2_launches(prof)}  # the tiles stay eager
    runs = len(sis) * n_scenes
    per_scene = {k: v / runs for k, v in launches.items()}
    host_path = {dt: si.host_path_scenes for dt, si in sis.items()}
    replays, captures = names.count("si.replay"), names.count("si.capture")
    log(f"[6] scene path: {runs} scenes ({n_scenes} x float32, bfloat16) of {SCENE_EXTENT}, 25 tiles each, all "
        f"served by the fused path (host-path scenes so far {host_path}); wrapper calls {calls}, the library's own "
        f"count of them {library_calls}; chains replayed {replays}, captured {captures}; kernel launches (K2 from the "
        f"device trace) {launches}, per scene {per_scene}")
    for k in ("roi_pool3d_cuda", "nms3d_cuda"):
        check(calls[k] > 0, f"{k} was not launched on the scene path")
        check(library_calls[k] == calls[k], f"{k}: the library counted {library_calls[k]} calls of {calls[k]}")
    check(calls["nms3d_cuda_class_aware"] == runs - replays + captures,
          f"{calls['nms3d_cuda_class_aware']} class-aware K2 calls for {runs - replays} eager chains and "
          f"{captures} captures")
    check(launches["nms3d_cuda_class_aware"] == runs,
          f"{launches['nms3d_cuda_class_aware']} class-aware K2 kernels in the device trace for {runs} scenes")
    check(launches["nms3d_cuda"] - launches["nms3d_cuda_class_aware"]
          == calls["nms3d_cuda"] - calls["nms3d_cuda_class_aware"], "the plain K2's kernels are not its calls")
    res["wrapper_calls"] = calls

    for dt, per in outs.items():
        n_det, n_vox, recalls = [], [], []
        for (det, masks), gt in zip(per, gts):
            check(len(det["pred_box"]) > 0, f"{dt}: a scene without detections")
            check(np.isfinite(det["pred_box"]).all() and np.isfinite(det["pred_conf"]).all(), f"{dt}: not finite")
            check(len(masks) == len(det["pred_box"]), f"{dt}: one mask per detection")
            for box, m in zip(det["pred_box"], masks):
                r = np.round(box).astype(int)
                check(m.shape == tuple(r[3:] - r[:3]) and m.dtype == np.uint8, f"{dt}: mask shape {m.shape}")
            n_det.append(len(masks))
            n_vox.append(int(sum(m.sum() for m in masks)))
            confident = det["pred_box"][det["pred_conf"] >= 0.5]
            recalls.append((iou(gt, confident).max(1) >= 0.25).mean() if len(confident) else 0.0)
        fill = [float(m.mean()) for det, masks in per for m in masks if m.size]
        log(f"[6] {dt}: detections per scene {n_det}, mask voxels per scene {n_vox}, mean mask fill "
            f"{np.mean(fill):.3f}, object recall at IoU 0.25 (conf >= 0.5) {np.mean(recalls):.3f}")
        check(min(n_vox) > 0, f"{dt}: a scene whose masks are all empty")
        check(np.mean(recalls) >= 0.25, f"{dt}: object recall below 0.25")

    bf16_vs_fp32(outs, n_scenes, phase=6)
    return sis, scenes, launches, per_scene, res


def phase_scene_card_vs_cpu(sis, params):
    """float32, TF32 off: the same detections (order-free, same class, boxes
    within 1e-3 voxels, conf within 1e-4) and masks within 0.005 flips."""
    scene, _ = make_scene(np.random.RandomState(11), SCENE_SMALL, n_objects=10)
    card = sis["float32"].infer(scene)
    cpu_si = scene_inference("cpu", "float32", params)
    t0 = time.time()
    cpu = cpu_si.infer(scene)
    cpu_s = time.time() - t0
    check(cpu_si.last_fused and sis["float32"].last_fused, "card or CPU fell back to the host-planned path")
    compare_card_cpu(card, cpu, f"one {SCENE_SMALL} scene", cpu_s, phase=6)


def compare_card_cpu(card, cpu, label, cpu_s, phase, box_tol=1e-3, tie_stride=None, tie_tol=1e-3):
    """float32 card against CPU: the same detections (order-free, same class,
    boxes within ``box_tol`` voxels, conf within 1e-4), masks within 0.005
    flips per box; the flipped voxels are counted.

    With ``tie_stride``, a card detection that has no such counterpart may
    pair with a tied copy: the same class, a confidence within 1e-6, the
    same size and a shift by a nonzero multiple of ``tie_stride`` voxels
    (both within ``tie_tol``). On a uniform region (the truncated free
    space) the detector scores its shifted copies alike, up to the context
    of their tiles' borders, and which copies the proposal NMS and the
    greedy stitch keep rests on the last bit of each sum, on the card as on
    the CPU. Such pairs are counted and printed; their masks are not
    compared."""
    (dc, mc), (dp, mp) = card, cpu
    check(len(dc["pred_box"]) == len(dp["pred_box"]) > 0,
          f"{len(dc['pred_box'])} detections on the card, {len(dp['pred_box'])} on the CPU")
    used = np.zeros(len(dp["pred_box"]), bool)
    worst_box = worst_conf = worst_flip = 0.0
    flipped = 0
    deferred, tied = [], []
    for i in range(len(dc["pred_box"])):
        d = np.abs(dp["pred_box"] - dc["pred_box"][i]).max(1)
        d[used | (dp["pred_class"] != dc["pred_class"][i])] = np.inf
        j = int(np.argmin(d))
        if d[j] > box_tol:
            check(tie_stride is not None,
                  f"card detection {dc['pred_box'][i]} (class {dc['pred_class'][i]}, conf {dc['pred_conf'][i]:.8f}) "
                  f"has no CPU counterpart within {box_tol} voxels: the nearest of its class is {d[j]:.6g} away")
            deferred.append(i)
            continue
        used[j] = True
        worst_box = max(worst_box, float(d[j]))
        worst_conf = max(worst_conf, abs(float(dc["pred_conf"][i]) - float(dp["pred_conf"][j])))
        check(mc[i].shape == mp[j].shape, "mask shapes differ")
        if mc[i].size:
            worst_flip = max(worst_flip, float((mc[i] != mp[j]).mean()))
            flipped += int((mc[i] != mp[j]).sum())
    for i in deferred:
        box = dc["pred_box"][i]
        shift = dp["pred_box"][:, :3] - box[:3]
        steps = np.round(shift / tie_stride)
        ok = (~used & (dp["pred_class"] == dc["pred_class"][i])
              & (np.abs(dp["pred_conf"].astype(np.float64) - float(dc["pred_conf"][i])) <= 1e-6)
              & (np.abs((dp["pred_box"][:, 3:] - dp["pred_box"][:, :3]) - (box[3:] - box[:3])).max(1) <= tie_tol)
              & (np.abs(shift - steps * tie_stride).max(1) <= tie_tol) & (np.abs(steps).max(1) > 0))
        check(bool(ok.any()), f"card detection {box} (class {dc['pred_class'][i]}, conf {dc['pred_conf'][i]:.8f}) "
              f"has no CPU counterpart within {box_tol} voxels and no tied copy shifted by multiples of {tie_stride}")
        j = int(np.argmin(np.where(ok, np.abs(shift).max(1), np.inf)))
        used[j] = True
        tied.append((box.round(3).tolist(), dp["pred_box"][j].round(3).tolist(), float(dc["pred_conf"][i])))
    check(worst_conf <= 1e-4, f"card vs CPU conf differs by {worst_conf}")
    check(worst_flip < 0.005, f"card vs CPU masks differ in {worst_flip} of a box's voxels")
    log(f"[{phase}] card vs CPU, {label}, float32, TF32 off: {len(dc['pred_box'])} detections on both, "
        f"max abs diff box {worst_box:.3g} voxels, conf {worst_conf:.3g}; mask voxels flipped {flipped} of "
        f"{sum(m.size for m in mc)}, worst box {worst_flip:.4g} (CPU infer {cpu_s:.1f} s) [{CARD}]"
        + (f"; {len(tied)} tied copies kept at other shifts (card box, CPU box, conf): {tied}" if tied else ""))
    return len(tied)


def profile_scene(si, scene, runs=2, frames=None):
    """Device time per scene by kernel name, and the idle share, from
    torch.profiler over `runs` infer() calls after a warm-up; the window is
    the host clock around them. Each call gets a fresh copy of `frames`, so
    a color scene's window holds its prep too (not prefetched)."""
    from torch.profiler import ProfilerActivity, profile

    def fresh():
        return None if frames is None else dict(frames)

    si.infer(scene, fresh())
    torch.cuda.synchronize()
    # the card's activity only: tracing every host op slows the host's
    # enqueue, which this path is bound by
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            si.infer(scene, fresh())
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3 / runs
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / runs
    return sum(by_name.values()), window, sorted(by_name.items(), key=lambda kv: -kv[1])


def k2_class_aware_timing(name, boxes, valid, classes, thresh=0.25):
    """K2 class-aware: device time, plain version's time, bound and latency
    floor (N dependent steps of 16 cycles at the highest SM clock)."""
    k2 = device_ms(lambda: nms.nms3d_cuda(boxes, thresh, valid, classes), 50)
    bound, bound_by, steps = k2_bound(boxes, valid, classes)
    floor = f"{steps * 16 / (CLOCK_MHZ * 1e3):.5f} ms" if CLOCK_MHZ else "not measured"
    plain = cuda_ms(lambda: nms.nms_mask_plain(boxes, thresh, valid, classes), 3, warmup=1)
    log(f"[6] K2 class-aware on {name} {tuple(boxes.shape)} ({int(valid.sum())} valid): {k2:.5f} ms device time; "
        f"plain {plain:.3f} ms; bound {bound:.6f} ms ({bound_by}); latency floor of {steps} dependent steps "
        f"{floor} [{CARD}]")
    return {"ms": k2, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by}


def scene_stages(si, scene, prep=None):
    """Per-stage ms of one scene's fused program (CUDA events; the color
    crops alone too, with a color prep) and the host's paste. Returns
    (stages, kept detections per slot, valid windows per queue)."""
    from tpu3dsis_torch.infer.tiling import _to_host

    with torch.inference_mode():
        data, scene_dev = si._device_scene(scene)
        origins = si._bucket(data.shape[:3])["origins"]
        extent = torch.tensor(scene.shape[:3], dtype=torch.float32, device=si.device)
        tiles = si._tile_outputs(scene_dev, origins, prep)
        det = si._stitch(tiles, origins, extent)
        plans = si._plan_queues(det, scene_dev.shape[:3])

        def crops(name):  # the mask windows' color crops (MASK_USE_IMAGES)
            return si._crops(prep["color"], plans[name]["starts"], si._queue_canvas[name])

        def fcn(name):
            q = plans[name]
            return si._window_masks(scene_dev, q["starts"], q["locals6"], det["pred_class"][q["roi_idx"].long()],
                                    si._queue_canvas[name], crops(name) if si._mask_color else None)

        stages = {"tiles": cuda_ms(lambda: si._tile_outputs(scene_dev, origins, prep), 5)}
        if prep is not None:
            stages["color_crops_of_tiles"] = cuda_ms(lambda: si._tile_color(prep, origins, si.device), 5)
        stages.update({
            "stitch_nms": cuda_ms(lambda: si._stitch(tiles, origins, extent), 10),
            "planning": cuda_ms(lambda: si._plan_queues(det, scene_dev.shape[:3]), 10),
            "mask_fcn_small": cuda_ms(lambda: fcn("mask_small"), 5),
            "mask_fcn_large": cuda_ms(lambda: fcn("mask_large"), 5),
        })
        if si._mask_color:  # included in mask_fcn_*
            stages.update({f"color_crops_of_{k}": cuda_ms(lambda k=k: crops(k), 5) for k in ("mask_small", "mask_large")})
        host = _to_host(si._fused(scene_dev, origins, scene.shape[:3], prep))
        kv = host["det_valid"].astype(bool)
        t0 = time.perf_counter()
        for _ in range(5):
            si._paste(host, kv)
        stages["host_paste"] = (time.perf_counter() - t0) * 1e3 / 5
        n_windows = {k: int(host[k]["valid"].sum()) for k in ("mask_small", "mask_large")}
    return stages, kv, n_windows


def phase_scene_timing(sis, scenes, res, passes=3):
    out = {}
    for dt, si in sis.items():
        # a stream of 8 distinct arrays (bench.py:195-204): scene i+1 uploads
        # while scene i computes
        def one_pass():
            stream = [s.copy() for _ in range(2) for s in scenes]
            t0 = time.perf_counter()
            si.prefetch_scene(stream[0])
            for j, s in enumerate(stream):
                if j + 1 < len(stream):
                    si.prefetch_scene(stream[j + 1])
                det, masks = si.infer(s)
                check(len(masks) == len(det["pred_box"]) and si.last_fused, "stream scene not served fused")
            return (time.perf_counter() - t0) / len(stream)

        times = sorted(one_pass() for _ in range(passes))
        dev_s = si.device_seconds(scenes[0], iters=6)
        stages, kv, n_windows = scene_stages(si, scenes[0])
        log(f"[6] {dt}: {60.0 / times[len(times) // 2]:.2f} masked scenes/min (median of {passes} passes of a "
            f"prefetched stream of 8; per-scene s {[round(t, 4) for t in times]}), device_seconds {dev_s:.4f} s "
            f"= {60.0 / dev_s:.1f} scenes/min device-bound; {int(kv.sum())} detections, valid windows {n_windows} "
            f"of 64 small and 12 large slots; host-path scenes {si.host_path_scenes} [{CARD}]")
        log(f"[6] {dt} per-stage ms: " + json.dumps({k: round(v, 4) for k, v in stages.items()}) + f" [{CARD}]")
        out[dt] = {"scenes_per_min": 60.0 / times[len(times) // 2], "device_s": dev_s, "stages": stages}
        if dt == "bfloat16":
            busy, window, top = profile_scene(si, scenes[0])
            log(f"[6] bfloat16 scene profile: device busy {busy:.3f} ms of a {window:.3f} ms window per scene, "
                f"idle share {1 - busy / window:.3f}; top kernels (ms per scene): "
                + json.dumps([[k[:60], round(v, 4)] for k, v in top[:12]]) + f" [{CARD}]")

    out["k2_class_aware"] = k2_class_aware_timing("the stitch's own input", *res["stitch_input"])
    k2_class_aware_timing("synthetic boxes of 18 classes", *res["synthetic_1x1024"])
    return out


# --- phase 7: the color scene path --------------------------------------------------
# Rooms as tpu3dsis/datagen/synthetic_color.py:73 room_mesh builds them, in the
# scene grid the scene loader gives them (scene voxel = world / VOXEL +
# ROOM_OFFSET): a floor at y = 0, four walls 6 voxels in from the grid's x and
# z borders, furniture boxes standing on the floor. The TSDF is the boxes',
# floor's and walls' signed distance; depth is ray-cast against the same
# solids at 41x32 and RGB is shaded as MeshRenderer shades it (per-face albedo,
# headlight Lambert), rendered at 41x32 and upsampled x8 to 328x256.

VOXEL = 0.046875  # benchmark.yml:66
ROOM_OFFSET = np.array([6.0, 0.0, 6.0])  # synthetic_color.py:283-285, the pad-16 -> crop-10 offset
WALL_HEIGHT_M = 2.4
COLOR_VIEWS = (32, 96, 144, 200)  # bench.py:253-260's range of view counts
CARD_VS_CPU_VIEWS = 16
KIND_DIMS_M = {"sofa": ((2.2, 2.6), (0.8, 1.1), (0.9, 1.2)), "chair": ((0.45, 0.7), (0.4, 0.65), (0.45, 0.7)),
               "table": ((0.75, 1.05), (0.18, 0.33), (0.75, 1.05))}  # synthetic_color.py:37-44
FLOOR_RGB, WALL_RGB = (90, 80, 70), (120, 120, 120)
# K3's float32 operations per (voxel, view) projection, FMAs off: 18 for the
# camera coordinates, a multiply, a division, an add and a rounding per pixel
# coordinate
K3_OPS_PER_PROJECTION = 26


def room_objects(rng, room_m, n_objects):
    """room_mesh's furniture (synthetic_color.py:97-126): about a third sofas,
    then chairs and tables, each on the floor, 0.1 m apart. Returns (lo, hi)
    world boxes in metres."""
    ex, _, ez = room_m
    kinds = ["sofa"] * max(1, n_objects // 3)
    kinds += ["chair", "table"] * (n_objects - len(kinds))
    placed = []
    for kind in kinds[:n_objects]:
        (dx0, dx1), (dy0, dy1), (dz0, dz1) = KIND_DIMS_M[kind]
        sx, sy, sz = rng.uniform(dx0, dx1), rng.uniform(dy0, dy1), rng.uniform(dz0, dz1)
        if rng.rand() < 0.5:
            sx, sz = sz, sx
        for _ in range(60):
            x0, z0 = rng.uniform(0.2, max(ex - sx - 0.2, 0.3)), rng.uniform(0.2, max(ez - sz - 0.2, 0.3))
            box = (x0, 0.0, z0, x0 + sx, sy, z0 + sz)
            if any(not (box[3] + 0.1 <= b[0] or b[3] + 0.1 <= box[0] or box[5] + 0.1 <= b[2] or b[5] + 0.1 <= box[2])
                   for b in placed):
                continue
            placed.append(box)
            break
    return np.asarray(placed, np.float64).reshape(-1, 6)


def room_tsdf(extent, room_m, boxes_m):
    """The encoded TSDF of the room on the scene grid: the signed distance in
    voxels to the union of the boxes, the floor and the walls (positive in
    the room's free space)."""
    g = [np.arange(n, dtype=np.float64) for n in extent]
    x, y, z = g[0][:, None, None], g[1][None, :, None], g[2][None, None, :]
    hi_x, hi_z = (ROOM_OFFSET[[0, 2]] + np.asarray(room_m)[[0, 2]] / VOXEL)
    sdf = np.minimum(np.minimum(x - ROOM_OFFSET[0], hi_x - x), np.minimum(z - ROOM_OFFSET[2], hi_z - z))
    sdf = np.minimum(sdf, y)  # the floor
    for b in boxes_m:
        lo, hi = b[:3] / VOXEL + ROOM_OFFSET, b[3:] / VOXEL + ROOM_OFFSET
        q = [np.maximum(lo[0] - x, x - hi[0]), np.maximum(lo[1] - y, y - hi[1]), np.maximum(lo[2] - z, z - hi[2])]
        outside = np.sqrt(sum(np.maximum(a, 0.0) ** 2 for a in q))
        inside = np.minimum(np.maximum(np.maximum(q[0], q[1]), q[2]), 0.0)
        sdf = np.minimum(sdf, outside + inside)
    return encode_tsdf(sdf.astype(np.float32))


def camera_pose(eye, yaw_deg, pitch_deg):
    """tpu3dsis/datagen/virtual_scan.py:94: camera-to-world with look =
    Ry(yaw) Rx(pitch) ez, columns right, up, look (positive pitch looks
    down)."""
    yaw, pitch = np.radians(yaw_deg), np.radians(pitch_deg)
    ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
    rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)], [0, np.sin(pitch), np.cos(pitch)]])
    r = ry @ rx
    look, up = r[:, 2], r[:, 1]
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = np.cross(up, look), up, look, eye
    return pose


def room_cameras(rng, n_views, room_m, boxes_m):
    """ViewStats' cameras (virtual_scan.py:48-54): 1.55 +- 0.15 m high,
    pitched down 11 +- 8 degrees; most look toward a piece of furniture,
    the rest at a random yaw."""
    ex, _, ez = room_m
    poses = []
    for _ in range(n_views):
        eye = np.array([rng.uniform(0.5, ex - 0.5), np.clip(rng.normal(1.55, 0.15), 1.25, 1.85),
                        rng.uniform(0.5, ez - 0.5)])
        yaw = rng.uniform(0.0, 360.0)
        if len(boxes_m) and rng.rand() < 0.75:
            c = boxes_m[rng.randint(len(boxes_m))]
            d = (c[:3] + c[3:]) / 2 - eye
            yaw = np.degrees(np.arctan2(d[0], d[2])) + rng.normal(0, 10)
        poses.append(camera_pose(eye, yaw, rng.normal(11.0, 8.0)))
    return np.asarray(poses, np.float32)


def render_views(poses, intrinsic, room_m, boxes_m, colors, depth_wh=(41, 32), far=6.0):
    """Ray-cast every view at the depth maps' resolution: (V, H, W) z-depth
    in metres (0 where nothing is hit within `far`, as MeshRenderer) and
    (V, H, W, 3) uint8 RGB. colors: per solid and face (n_boxes + 5, 6, 3)
    albedo; the solids are the boxes, the floor and the four walls."""
    w, h = depth_wh
    fx, fy, cx, cy = intrinsic[0][0], intrinsic[1][1], intrinsic[0][2], intrinsic[1][2]
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    rays = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, dtype=np.float64)], -1).reshape(-1, 3)
    ex, ey, ez = room_m
    depths, images = [], []
    for pose in poses.astype(np.float64):
        o, d = pose[:3, 3], rays @ pose[:3, :3].T  # world ray o + t d, t = camera z
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
            best = np.full(len(d), np.inf)
            solid = np.full(len(d), -1)
            face = np.zeros(len(d), np.int64)
            for i, b in enumerate(boxes_m):  # slabs
                t1, t2 = (b[:3] - o) * inv, (b[3:] - o) * inv
                tn, tf = np.minimum(t1, t2), np.maximum(t1, t2)
                t_near, t_far = tn.max(1), tf.min(1)
                hit = (t_near <= t_far) & (t_near > 0) & (t_near < best)
                best[hit], solid[hit] = t_near[hit], i
                axis = tn.argmax(1)
                face[hit] = 2 * axis[hit] + (d[hit, axis[hit]] > 0)
            # the room's floor and four walls, (axis, position), seen from the inside
            for k, (axis, at) in enumerate(((1, 0.0), (0, 0.0), (0, ex), (2, 0.0), (2, ez))):
                t = (at - o[axis]) * inv[:, axis]
                p = o + t[:, None] * d
                inside = (p[:, 0] >= -1e-9) & (p[:, 0] <= ex + 1e-9) & (p[:, 2] >= -1e-9) & (p[:, 2] <= ez + 1e-9)
                if axis != 1:
                    inside &= (p[:, 1] >= 0) & (p[:, 1] <= ey)
                hit = (t > 0) & inside & (t < best)
                best[hit], solid[hit], face[hit] = t[hit], len(boxes_m) + k, 2 * axis
        seen = np.isfinite(best) & (best <= far)
        depth = np.where(seen, best, 0.0)
        normal = np.zeros((len(d), 3))
        normal[np.arange(len(d)), face // 2] = 1.0
        shade = 0.3 + 0.7 * np.abs(normal @ pose[:3, 2])  # mesh_render.py:123-129
        rgb = colors[np.clip(solid, 0, None), face] * shade[:, None]
        rgb[~seen] = 0.0
        depths.append(depth.reshape(h, w))
        images.append(np.clip(rgb, 0, 255).astype(np.uint8).reshape(h, w, 3))
    return np.asarray(depths, np.float32), np.asarray(images)


def make_color_scene(rng, n_views, extent=SCENE_EXTENT, n_objects=24, intrinsic=None):
    """A room scene with its frames: (encoded TSDF (X, Y, Z, 2), object boxes
    in scene voxels (N, 6), frames {images (V, 256, 328, 3) uint8, depths
    (V, 32, 41), poses (V, 4, 4), world_to_grid (4, 4)})."""
    if intrinsic is None:
        intrinsic = scannet_color_scene_config().INTRINSIC
    room_m = ((extent[0] - 2 * ROOM_OFFSET[0]) * VOXEL, WALL_HEIGHT_M, (extent[2] - 2 * ROOM_OFFSET[2]) * VOXEL)
    boxes_m = room_objects(rng, room_m, n_objects)
    colors = np.empty((len(boxes_m) + 5, 6, 3))
    colors[:len(boxes_m)] = rng.randint(60, 220, (len(boxes_m), 1, 3))
    colors[len(boxes_m)] = FLOOR_RGB
    colors[len(boxes_m) + 1:] = WALL_RGB
    colors = np.clip(colors + rng.randint(-25, 26, colors.shape), 0, 255)  # room_mesh's face jitter
    poses = room_cameras(rng, n_views, room_m, boxes_m)
    depths, small = render_views(poses, intrinsic, room_m, boxes_m, colors)
    w2g = np.eye(4, dtype=np.float32)
    w2g[[0, 1, 2], [0, 1, 2]] = 1.0 / VOXEL
    w2g[:3, 3] = ROOM_OFFSET
    frames = {"images": np.repeat(np.repeat(small, 8, axis=1), 8, axis=2), "depths": depths, "poses": poses,
              "world_to_grid": w2g}
    gt = np.concatenate([boxes_m[:, :3] / VOXEL + ROOM_OFFSET, boxes_m[:, 3:] / VOXEL + ROOM_OFFSET], 1)
    return room_tsdf(extent, room_m, boxes_m), gt.astype(np.float32), frames


def color_params():
    """The trained color fixture, every key (the ENet's included)."""
    with np.load(COLOR_FIXTURE) as d:
        return {k: d[k] for k in d.files}


def color_scene_inference(dev, dtype, params, **changes):
    cfg = scannet_color_scene_config().replace(TPU_COMPUTE_DTYPE=dtype, **changes)
    return SceneInference(load_jax_params(Detector(cfg, device=dev), params), cfg)


def k3_kept(args):
    """The (brick, view) pairs K3's cull keeps on one call's arguments, by
    its plain version: (n_bricks, V) bool."""
    return projection.brick_view_candidates_plain(
        args["depths"], args["poses"], args["world_to_grid"], args["intrinsic"], args["volume_dims"],
        args["depth_min"], args["depth_max"], args["voxel_size"], view_valid=args["view_valid"])


def k3_bound(args):
    """K3's bound in ms, its bound_by and its bytes: the (X, Y, Z, C) output
    written once and the feature maps, depths, matrices and flags read once
    (bytes), or K3_OPS_PER_PROJECTION float32 operations for each voxel of a
    brick and each view the cull keeps for it (operations: the projections
    these inputs need, not one per voxel and valid view)."""
    feats2d, depths = args["feats2d"], args["depths"]
    v, c, itemsize = feats2d.shape[0], feats2d.shape[-1], feats2d.element_size()
    n = int(np.prod(args["volume_dims"]))
    lo, hi = projection.brick_bounds(args["volume_dims"], depths.device)
    projections = int(((hi - lo + 1).prod(1) * k3_kept(args).sum(1)).sum())
    nbytes = n * c * itemsize + feats2d.numel() * itemsize + depths.numel() * 4 + v * (12 * 4 + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, projections * K3_OPS_PER_PROJECTION / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes"), nbytes


def _k3_case(name, args, quiet=False, phase=7):
    """K3 against its plain version on one call's arguments, with
    ``torch.equal`` (NaN positions first, then the rest). Returns (max abs
    err, plain ms, the share of voxels it fills, the plain result)."""
    got = projection.fuse_views_cuda(**args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = projection.fuse_views_plain(**{k: v for k, v in args.items() if k not in ("mats", "out")})
    end.record()
    end.synchronize()
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    same = torch.equal(nan_got, nan_want) and torch.equal(got.masked_fill(nan_got, 0), want.masked_fill(nan_want, 0))
    err = float((got.float() - want.float()).abs().nan_to_num(0.0).max())
    filled = float((want != 0).any(-1).float().mean())
    if not quiet or not same:
        log(f"[{phase}] K3 {name}: {tuple(got.shape)} {got.dtype}, {args['feats2d'].shape[0]} views: exact={same} "
            f"max_abs_err={err} filled {filled:.4f} of the voxels, NaN outputs {int(nan_want.sum())}, plain "
            f"{start.elapsed_time(end):.1f} ms [{CARD}]")
    check(same, f"K3 {name} differs from its plain version")
    return err, start.elapsed_time(end), filled, want


def k3_edge_cases(args):
    """K3 against its plain version where its semantics or its cull have
    edges, on the path's own features and views: invalid views skipped
    whole, a single valid view with negative features (they pass through as
    they are, and the bricks that cull it floor at 0), no valid view (0
    everywhere), ``zero_floor``, NaN feature rows (the max propagates them),
    a camera inside the volume, ragged volume dims, a single valid view whose
    depths are all 0 or all NaN, and a single valid view that covers no
    brick at all (each culls everywhere: 0 everywhere)."""
    feats, v = args["feats2d"], args["feats2d"].shape[0]
    dev = feats.device
    err = 0.0
    only = lambda i: torch.arange(v, device=dev) == i  # noqa: E731
    coverage = [float((d > 0).float().mean()) for d in args["depths"]]
    k = int(np.argmax(coverage))
    negative = -feats.abs() - 0.5
    nanned = feats.clone()
    nanned[k, ::3, ::3, :] = float("nan")
    nanned[(k + 1) % v, 7, 9, 5] = float("nan")
    poses = np.array(torch.as_tensor(args["poses"]).cpu(), np.float32)
    g2w = np.linalg.inv(np.asarray(torch.as_tensor(args["world_to_grid"]).cpu(), np.float64))
    inside = poses.copy()  # view k moved to the volume's centre, its rotation kept
    inside[k, :3, 3] = (g2w @ np.array([*(np.asarray(args["volume_dims"]) / 2.0), 1.0]))[:3]
    away = poses.copy()  # view k 20 m outside the volume, looking away from it
    corner = (g2w @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]
    away[k] = camera_pose(corner - 20.0, 225.0, 0.0)
    flat_depths = {}
    for name, value in (("zero", 0.0), ("NaN", float("nan"))):
        d = args["depths"].clone()
        d[k] = value
        flat_depths[name] = d
    cases = {
        "every third view invalid": dict(args, view_valid=torch.arange(v, device=dev) % 3 != 0),
        "no valid view": dict(args, view_valid=torch.zeros(v, dtype=torch.bool, device=dev)),
        "zero_floor": dict(args, zero_floor=True),
        "one valid view, negative features": dict(args, feats2d=negative, view_valid=only(k)),
        "NaN feature rows": dict(args, feats2d=nanned),
        "a camera inside the volume": dict(args, poses=inside),
        "a camera inside the volume, its view alone, negative features": dict(args, poses=inside, feats2d=negative,
                                                                             view_valid=only(k)),
        "ragged volume dims (237, 45, 233)": dict(args, volume_dims=(237, 45, 233)),
        "one valid view, its depths all 0": dict(args, depths=flat_depths["zero"], view_valid=only(k)),
        "one valid view, its depths all NaN": dict(args, depths=flat_depths["NaN"], view_valid=only(k)),
        "one valid view covering no brick, negative features": dict(args, poses=away, feats2d=negative,
                                                                    view_valid=only(k)),
    }
    for name, case in cases.items():
        e, _, filled, want = _k3_case(name, case)
        err = max(err, e)
        if name in ("no valid view", "one valid view, its depths all 0", "one valid view, its depths all NaN",
                    "one valid view covering no brick, negative features"):
            check(not bool(want.any()), f"K3 {name}: not all 0")
        if name.endswith("negative features") and "covering no brick" not in name:
            check(bool((want < 0).any()), f"K3 {name}: no negative feature passed through")
            kept = k3_kept(case)[:, k]
            check(bool(kept.any()) and not bool(kept.all()), f"K3 {name}: the cull kept the view in no brick or "
                  f"in every brick ({float(kept.float().mean()):.4f})")
        if name == "NaN feature rows":
            check(bool(torch.isnan(want).any()), "no voxel read a NaN feature row")
        if name.startswith("a camera inside") or name.startswith("ragged"):
            check(filled > 0, f"K3 {name}: no voxel filled")
        if "covering no brick" in name:
            check(not bool(k3_kept(case).any()), f"K3 {name}: the cull kept it somewhere")
    return err


def phase_color(dev, params):
    """Phase 7: the color scene path's kernel calls against their plain
    versions, then the path itself, counted."""
    sis = {dt: color_scene_inference(dev, dt, params) for dt in ("float32", "bfloat16")}
    t0 = time.time()
    made = [make_color_scene(np.random.RandomState(20 + i), v) for i, v in enumerate(COLOR_VIEWS)]
    scenes, gts, frames = (list(x) for x in zip(*made))
    log(f"[7] {len(scenes)} color scenes of {SCENE_EXTENT} with {list(COLOR_VIEWS)} views, "
        f"{[len(g) for g in gts]} objects, made in {time.time() - t0:.1f} s; depth hits per view "
        f"{[round(float((f['depths'] > 0).mean()), 3) for f in frames]}")
    res = {"err": 0.0, "k1_err": 0.0, "k2_err": 0.0, "recorded": {}}
    with torch.inference_mode():
        # every kernel call of one infer() of the 96-view scene, in each
        # dtype: K3's resident volume, K1, K2 (a fresh frames dict, so that
        # the prep runs inside the call)
        for dt, si in sis.items():
            calls = recorded_kernel_calls(si, scenes[1], dict(frames[1]))
            k3 = [a for kind, a in calls if kind == "fuse_views_cuda"]
            check(len(k3) == 1, f"{dt}: the resident path made {len(k3)} K3 calls, not 1")
            err, plain_ms, filled, _ = _k3_case(f"{dt} resident volume of the {COLOR_VIEWS[1]}-view scene (the path's "
                                                f"call)", k3[0])
            check(filled > 0, "K3 filled no voxel of the scene's volume")
            res["err"] = max(res["err"], err)
            res["recorded"][dt] = (k3[0], plain_ms)
            kept = k3_kept(k3[0])
            res["kept_share"] = float(kept.float().mean())
            log(f"[7] K3's cull on the path's call: keeps {int(kept.sum())} of {kept.numel()} (brick, view) pairs, "
                f"{res['kept_share']:.4f}; candidates per brick mean {float(kept.sum(1).float().mean()):.2f}, max "
                f"{int(kept.sum(1).max())}; bricks with none {int((kept.sum(1) == 0).sum())} of {kept.shape[0]}")
            errs = check_recorded_k1_k2(calls, f"{dt} color scene path", phase=7)
            res["k1_err"] = max(res["k1_err"], errs["k1_err"])
            res["k2_err"] = max(res["k2_err"], errs["k2_err"], errs["class_aware_err"])
            res["err"] = max(res["err"], k3_edge_cases(k3[0]))

        # the per-tile path (TPU_SCENE_COLOR_RESIDENT="never"): one K3 call per
        # tile of the 200-view scene, each over the first 16 views whose
        # frusta meet the tile, zero_floor where a view was left out
        for dt in sis:
            never = color_scene_inference(dev, dt, params, TPU_SCENE_COLOR_RESIDENT="never")
            calls = recorded_kernel_calls(never, scenes[3], dict(frames[3]), fused=False)
            k3 = [a for kind, a in calls if kind == "fuse_views_cuda"]
            floors = sum(bool(a["zero_floor"]) for a in k3)
            views = [a["feats2d"].shape[0] for a in k3]
            fills = []
            for i, a in enumerate(k3):
                e, _, f, _ = _k3_case(f"{dt} per-tile call {i}", a, quiet=True)
                res["err"] = max(res["err"], e)
                fills.append(f)
            n_tiles = len(never._origins_np(never._bucket_shape(scenes[3].shape[:3])))
            log(f"[7] K3 {dt} per-tile path of the {COLOR_VIEWS[3]}-view scene: {len(k3)} calls, all exact; views "
                f"per tile {views}; zero_floor on {floors}; filled share per tile min {min(fills):.4f} max "
                f"{max(fills):.4f} [{CARD}]")
            check(len(k3) == n_tiles and 0 < floors, f"{dt}: {len(k3)} per-tile K3 calls for {n_tiles} tiles, "
                  f"{floors} with zero_floor")
            check(max(views) <= never.cfg.TPU_MAX_TILE_VIEWS, "a tile took more views than the cap")
            del never

    # the path: every count set to 0 just before, read just after; K2's
    # launches from the device trace (the chain after the tiles replays)
    from torch.profiler import ProfilerActivity, profile

    reset_launch_counts()
    before = device_launches()
    outs, filled = {}, {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for dt, si in sis.items():
            outs[dt], filled[dt] = [], []
            for s, f in zip(scenes, frames):
                det, masks = si.infer(s, f)
                check(si.last_fused, f"{dt}: a color scene was not served by the fused path")
                outs[dt].append((det, masks))
                filled[dt].append(float((si._color_cache[1]["color"] != 0).any(-1).float().mean()))
        torch.cuda.synchronize()
    calls = {"roi_pool3d_cuda": rp.roi_pool3d_cuda.launches, "nms3d_cuda": nms.nms3d_cuda.launches,
             "nms3d_cuda_class_aware": nms.nms3d_cuda.class_aware_launches,
             "fuse_views_cuda": projection.fuse_views_cuda.launches}
    library_calls = {k: v - before[k] for k, v in device_launches().items() if k in calls}
    launches = {**calls, **traced_k2_launches(prof)}
    runs = len(sis) * len(scenes)
    per_scene = {k: v / runs for k, v in launches.items()}
    host_path = {dt: si.host_path_scenes for dt, si in sis.items()}
    log(f"[7] color scene path: {runs} scenes ({len(scenes)} x float32, bfloat16), views {list(COLOR_VIEWS)}, all "
        f"served by the fused path (host-path scenes {host_path}); wrapper calls {calls}, the library's own count "
        f"of them {library_calls}; kernel launches (K2 from the device trace) {launches}, per scene {per_scene}")
    log(f"[7] share of the volume's voxels K3 fills, per scene: {json.dumps(filled)}")
    for k in ("roi_pool3d_cuda", "nms3d_cuda", "fuse_views_cuda"):
        check(calls[k] > 0, f"{k} was not launched on the color scene path")
        check(library_calls[k] == calls[k], f"{k}: the library counted {library_calls[k]} calls of {calls[k]}")
    check(launches["fuse_views_cuda"] == runs, "K3 did not launch once per color scene")
    check(launches["nms3d_cuda_class_aware"] == runs, "the class-aware K2 did not launch once per color scene")
    res["wrapper_calls"] = calls
    check(min(min(v) for v in filled.values()) > 0, "a color scene whose volume K3 left empty")
    check(all(n == 0 for n in host_path.values()), f"color scenes on the host path: {host_path}")

    for dt, per in outs.items():
        n_det, n_vox, recalls = [], [], []
        for (det, masks), gt in zip(per, gts):
            check(np.isfinite(det["pred_box"]).all() and np.isfinite(det["pred_conf"]).all(), f"{dt}: not finite")
            check(len(masks) == len(det["pred_box"]), f"{dt}: one mask per detection")
            for box, m in zip(det["pred_box"], masks):
                r = np.round(box).astype(int)
                check(m.shape == tuple(r[3:] - r[:3]) and m.dtype == np.uint8, f"{dt}: mask shape {m.shape}")
            n_det.append(len(masks))
            n_vox.append(int(sum(m.sum() for m in masks)))
            confident = det["pred_box"][det["pred_conf"] >= 0.5]
            recalls.append((iou(gt, confident).max(1) >= 0.25).mean() if len(confident) else 0.0)
        log(f"[7] {dt}: detections per scene {n_det} (views {list(COLOR_VIEWS)}), mask voxels per scene {n_vox}, "
            f"object recall at IoU 0.25 (conf >= 0.5) per scene {[round(float(r), 3) for r in recalls]}")
        check(max(n_det) >= 5, f"{dt}: no color scene with 5 detections, so the mask FCN ran on few windows")
        check(max(n_vox) > 0, f"{dt}: every color scene's masks are empty")
    bf16_vs_fp32(outs, len(scenes), phase=7, iou_thresh=0.25, max_drift=0.3, slack_div=4)
    return sis, scenes, gts, frames, launches, per_scene, res


def phase_color_card_vs_cpu(sis, params):
    """One 144x48x144 room with 16 views through infer on the card and on
    the CPU, float32, TF32 off; the two resident color volumes are compared
    too."""
    scene, _, frames = make_color_scene(np.random.RandomState(31), CARD_VS_CPU_VIEWS, SCENE_SMALL, n_objects=10)
    card = sis["float32"].infer(scene, frames)
    vol_card = sis["float32"]._color_cache[1]["color"].cpu()
    cpu_si = color_scene_inference("cpu", "float32", params)
    t0 = time.time()
    cpu = cpu_si.infer(scene, frames)
    cpu_s = time.time() - t0
    vol_cpu = cpu_si._color_cache[1]["color"]
    check(cpu_si.last_fused and sis["float32"].last_fused, "card or CPU fell back to the host-planned path")
    # K3 and its plain version decide every (voxel, view) pair alike (held
    # exactly above); the features differ by ENet's rounding, so a voxel
    # whose max is a feature within rounding of 0 may be 0 on one side only
    diff = (vol_card - vol_cpu).abs()
    one_side = (vol_card != 0) != (vol_cpu != 0)
    err, top = float(diff.max()), float(vol_cpu.abs().max())
    near_zero = float(diff[one_side].max()) if bool(one_side.any()) else 0.0
    log(f"[7] card vs CPU color volume {tuple(vol_card.shape)}: max abs diff {err:.3g} (largest value {top:.3g}); "
        f"{int(one_side.sum())} values nonzero on one side only, the largest {near_zero:.3g} [{CARD}]")
    check(err <= 1e-5 * top, f"card and CPU color volumes differ by {err}")
    compare_card_cpu(card, cpu, f"one {SCENE_SMALL} color scene with {CARD_VS_CPU_VIEWS} views", cpu_s, phase=7)


def phase_color_timing(sis, scenes, frames, res, passes=3):
    out = {}
    for dt, si in sis.items():
        # a stream of 8 scenes (the 4 twice, fresh arrays and frames dicts) as
        # bench.py:305-320 streams them: scene i+1 uploads and its views go
        # through ENet and K3 in the upload thread while scene i computes
        def one_pass():
            stream = [(s.copy(), dict(f)) for _ in range(2) for s, f in zip(scenes, frames)]
            t0 = time.perf_counter()
            si.prefetch_scene(stream[0][0])
            si.prefetch_frames(stream[0][1], stream[0][0].shape)
            for j, (s, f) in enumerate(stream):
                if j + 1 < len(stream):
                    si.prefetch_scene(stream[j + 1][0])
                    si.prefetch_frames(stream[j + 1][1], stream[j + 1][0].shape)
                det, masks = si.infer(s, f)
                check(len(masks) == len(det["pred_box"]) and si.last_fused, "stream color scene not served fused")
            return (time.perf_counter() - t0) / len(stream)

        times = sorted(one_pass() for _ in range(passes))
        dev_s = si.device_seconds(scenes[1], frames[1], iters=6)
        prep = si._device_color(frames[1], scenes[1].shape[:3])
        stages, kv, n_windows = scene_stages(si, scenes[1], prep)
        log(f"[7] {dt}: {60.0 / times[len(times) // 2]:.2f} color masked scenes/min (median of {passes} passes of a "
            f"prefetched stream of 8, views {list(COLOR_VIEWS)} twice; per-scene s {[round(t, 4) for t in times]}), "
            f"device_seconds of the {COLOR_VIEWS[1]}-view scene {dev_s:.4f} s = {60.0 / dev_s:.1f} scenes/min device-bound (prep "
            f"excluded); {int(kv.sum())} detections, valid windows {n_windows}; host-path scenes "
            f"{si.host_path_scenes} [{CARD}]")
        log(f"[7] {dt} per-stage ms of the {COLOR_VIEWS[1]}-view scene: " + json.dumps({k: round(v, 4) for k, v in stages.items()})
            + f" [{CARD}]")

        # the prep by view count: upload, ENet, K3, and the whole prep
        proj = si.det.color_projector
        preps = {}
        with torch.inference_mode():
            for s, f in zip(scenes, frames):
                images, depths = torch.from_numpy(f["images"]).pin_memory(), torch.from_numpy(f["depths"]).pin_memory()
                dev = si.device
                upload = cuda_ms(lambda: (images.to(dev, non_blocking=True), depths.to(dev, non_blocking=True)), 5)
                img_d, dep_d = images.to(dev), depths.to(dev)
                enet = cuda_ms(lambda: proj.image_features(img_d).to(si._dtype), 5)
                feats = proj.image_features(img_d).to(si._dtype)
                bucket = si._bucket_shape(s.shape[:3])
                k3 = device_ms(lambda: build_color_volume(proj, feats, dep_d, f["poses"], f["world_to_grid"], bucket,
                                                          si._dtype), 5)
                whole = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    si._prepare_color(dict(f), s.shape[:3])
                    torch.cuda.synchronize()  # every stream: the prep runs on the upload stream
                    whole.append((time.perf_counter() - t0) * 1e3)
                preps[len(f["poses"])] = {"upload": upload, "enet": enet, "k3": k3, "prep_host_clock":
                                          statistics.median(whole)}
        log(f"[7] {dt} prep ms per scene by view count (upload and ENet by CUDA events, K3 device time, the whole "
            f"prep by the host clock): " + json.dumps({v: {k: round(x, 4) for k, x in p.items()}
                                                      for v, p in preps.items()}) + f" [{CARD}]")
        args, plain_ms = res["recorded"][dt]
        k3_ms = device_ms(lambda: projection.fuse_views_cuda(**args), 10)
        bound, bound_by, nbytes = k3_bound(args)
        log(f"[7] K3 {dt} on the path's call (96 views into {tuple(args['volume_dims'])} x "
            f"{args['feats2d'].shape[-1]}): {k3_ms:.4f} ms device time; plain {plain_ms:.1f} ms; bound {bound:.4f} ms "
            f"({bound_by}, {nbytes / 1e9:.3f} GB), {bound / k3_ms:.3f} of it [{CARD}]")
        out[dt] = {"scenes_per_min": 60.0 / times[len(times) // 2], "device_s": dev_s, "stages": stages,
                   "prep": preps, "k3_ms": k3_ms, "k3_plain_ms": plain_ms, "k3_bound_ms": bound,
                   "k3_bound_by": bound_by}
        if dt == "bfloat16":
            busy, window, top = profile_scene(si, scenes[1], frames=frames[1])
            log(f"[7] bfloat16 color scene profile (the {COLOR_VIEWS[1]}-view scene with its prep, not prefetched): device busy "
                f"{busy:.3f} ms of a {window:.3f} ms window per scene, idle share {1 - busy / window:.3f}; top kernels "
                f"(ms per scene): " + json.dumps([[k[:60], round(v, 4)] for k, v in top[:14]]) + f" [{CARD}]")
    return out


# --- phase 8: the test and benchmark drivers ------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
DRIVER_SCENES = 3  # 4 until PR 12: cut to keep the whole run inside its time limit with phase 13
CPU_DRIVER_SCENES = 1  # of them run again on the CPU (each takes it 36-46 s)
KIND_NYU40 = {"sofa": 6, "chair": 5, "table": 7}  # tools/tiling_parity_check.py:27
PRED_FILES = ("pred_box.npy", "pred_class.npy", "pred_conf.npy", "pred_mask", "pred_mask_index", "scene.npy")
GT_FILES = ("gt_box.npy", "gt_class.npy", "gt_mask")
# ``python -m tpu3dsis_torch.main <args>`` as runpy runs it for -m, with every
# launch count set to 0 first and printed after
_ENTRY = """
import json, runpy, sys
from tpu3dsis_torch.ops import nms, roi_pool3d as rp
from tpu3dsis_torch.geometry import projection
rp.roi_pool3d_cuda.launches = nms.nms3d_cuda.launches = nms.nms3d_cuda.class_aware_launches = 0
projection.fuse_views_cuda.launches = rp.roi_pool3d_backward_cuda.launches = 0
projection.fuse_views_backward_cuda.launches = 0
sys.argv = ["tpu3dsis_torch.main", *json.loads(sys.argv[1])]
runpy.run_module("tpu3dsis_torch.main", run_name="__main__", alter_sys=True)
print("LAUNCHES " + json.dumps({"roi_pool3d_cuda": rp.roi_pool3d_cuda.launches, "nms3d_cuda": nms.nms3d_cuda.launches,
                                "nms3d_cuda_class_aware": nms.nms3d_cuda.class_aware_launches,
                                "fuse_views_cuda": projection.fuse_views_cuda.launches,
                                "roi_pool3d_backward_cuda": rp.roi_pool3d_backward_cuda.launches,
                                "fuse_views_backward_cuda": projection.fuse_views_backward_cuda.launches}))
"""
# every artifact loaded by a process in which torch cannot be imported
_LOAD_WITHOUT_TORCH = """
import json, os, pickle, sys
sys.modules["torch"] = None
import numpy as np
root, out = sys.argv[1], {}
for scene in sorted(os.listdir(root)):
    files = {}
    for name in sorted(os.listdir(os.path.join(root, scene))):
        path = os.path.join(root, scene, name)
        if name.endswith(".npy"):
            a = np.load(path)
            files[name] = [str(a.dtype), list(a.shape), bool(np.isfinite(a).all())]
        else:
            with open(path, "rb") as f:
                v = pickle.load(f)
            files[name] = [type(v).__name__, len(v), sorted({type(x).__module__ + "." + type(x).__name__
                                                              + ("/" + str(x.dtype) if hasattr(x, "dtype") else "")
                                                              for x in v})]
    out[scene] = files
print(json.dumps(out))
"""


def write_driver_scenes(tmp):
    """DRIVER_SCENES 240x48x240 scenes of 24 objects (make_scene's draws,
    seeds 40..), as ``.scene`` files with nyu40 labels and full box masks,
    as tools/tiling_parity_check.py writes its chunks; the filelist's path."""
    from tpu3dsis_torch.io import write_chunk_file

    paths = []
    for i in range(DRIVER_SCENES):
        sdf, boxes, kinds = scene_objects(np.random.RandomState(40 + i))
        path = os.path.join(tmp, f"scene{i:04d}_00__synthetic.scene")
        write_chunk_file(path, sdf, boxes, np.asarray([KIND_NYU40[k] for k in kinds], np.uint32),
                         [np.ones(tuple((b[3:] - b[:3]).astype(int)), np.uint16) for b in boxes],
                         np.ones(len(boxes), np.float32), np.eye(4, dtype=np.float32), np.zeros(0, np.uint32))
        paths.append(path)
    filelist = os.path.join(tmp, "scenes.txt")
    with open(filelist, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    return filelist


def write_overlay(path, **changes):
    """benchmark.yml with ``changes``, written where ``--cfg`` can name it."""
    from tpu3dsis_torch import yaml_subset

    with open(os.path.join(ROOT, "experiments", "cfgs", "ScanNet", "benchmark.yml")) as f:
        cfg = yaml_subset.load(f.read())
    cfg.update(changes)
    with open(path + ".yml", "w") as f:
        f.write(yaml_subset.dump(cfg))
    return path


def run_entry(args, timeout=600, stdout=None, torchrun=False):
    """The entry module in a process of its own: (its launch counts, the mAP
    dict it printed or None, wall seconds); its output's lines are added to
    the list ``stdout`` where one is given. With ``torchrun``, launched by
    ``torchrun --standalone --nproc_per_node 1`` (one rank, its rendezvous
    on a free local port)."""
    t0 = time.time()
    with tempfile.NamedTemporaryFile("w", suffix=".py", dir=ROOT, prefix=".entry_") as script:
        script.write(_ENTRY)
        script.flush()
        launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1"]
                    if torchrun else [sys.executable])
        res = subprocess.run([*launcher, script.name, json.dumps(args)], cwd=ROOT, capture_output=True, text=True,
                             timeout=timeout)
    wall = time.time() - t0
    if res.returncode != 0:
        log(res.stderr[-4000:])
    check(res.returncode == 0, f"python -m tpu3dsis_torch.main {' '.join(args)} exited {res.returncode}")
    lines = res.stdout.splitlines()
    if stdout is not None:
        stdout.extend(lines)
    launches = json.loads(next(l for l in lines if l.startswith("LAUNCHES "))[len("LAUNCHES "):])
    maps = [ast.literal_eval(l) for l in lines if l.startswith("{'mAP_")]
    return launches, (maps[0] if maps else None), wall


def artifacts_without_torch(save_dir):
    res = subprocess.run([sys.executable, "-c", _LOAD_WITHOUT_TORCH, save_dir], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"the artifacts do not load without torch: {res.stderr[-2000:]}")
    return json.loads(res.stdout)


def check_artifacts(listing, n_scenes, test_mode, extent=SCENE_EXTENT):
    """Each scene's files, their dtypes and shapes (``scene.npy`` of
    ``extent``), and pickles of numpy uint8 masks and bools only."""
    check(len(listing) == n_scenes, f"{len(listing)} scene directories for {n_scenes} scenes")
    n_det = []
    for scene, files in listing.items():
        want = sorted(PRED_FILES + (GT_FILES if test_mode else ()))
        check(sorted(files) == want, f"{scene}: files {sorted(files)}")
        n = files["pred_box.npy"][1][0]
        check(files["pred_box.npy"][:2] == ["float32", [n, 6]] and files["pred_box.npy"][2], f"{scene}: pred_box")
        check(files["pred_class.npy"][:2] == ["int32", [n]], f"{scene}: pred_class {files['pred_class.npy']}")
        check(files["pred_conf.npy"][:2] == ["float32", [n]] and files["pred_conf.npy"][2], f"{scene}: pred_conf")
        numpy_int = str(np.where(np.zeros(1) <= 1, 1, 0).dtype)  # the driver's np.where(data <= 1, 1, 0)
        check(files["scene.npy"][:2] == [numpy_int, list(extent)],
              f"{scene}: scene.npy {files['scene.npy']}")
        check(files["pred_mask"][:2] == ["list", n] and files["pred_mask"][2] in ([], ["numpy.ndarray/uint8"]),
              f"{scene}: pred_mask {files['pred_mask']}")
        check(files["pred_mask_index"][:2] == ["list", n] and files["pred_mask_index"][2] in ([], ["builtins.bool"]),
              f"{scene}: pred_mask_index {files['pred_mask_index']}")
        if test_mode:
            check(files["gt_mask"][2] == ["numpy.ndarray/uint8"], f"{scene}: gt_mask {files['gt_mask']}")
        n_det.append(n)
    return n_det


def driver_artifacts(dev):
    """Phase 8's scenes through ``run_scenes`` in test mode with phase 6's
    weights, in this process: the artifacts' directory (in a directory of
    its own that the caller removes). For ``--phases 11`` alone."""
    from tpu3dsis_torch.config import DetectorConfig, cfg_from_file, finalize_config
    from tpu3dsis_torch.infer.driver import run_scenes

    keep = tempfile.mkdtemp()
    filelist = write_driver_scenes(keep)
    cfg_path = write_overlay(os.path.join(keep, "overlay"), USE_IMAGES=False, TEST_FILELIST=filelist,
                             TEST_SAVE_DIR=os.path.join(keep, "test"))
    cfg = finalize_config(cfg_from_file(cfg_path + ".yml"))
    run_scenes(cfg, load_jax_params(Detector(DetectorConfig.from_cfg(cfg), device=dev), scene_params()), "test")
    return cfg.TEST_SAVE_DIR


def load_scene_artifacts(scene_dir):
    det = {k: np.load(os.path.join(scene_dir, f"{k}.npy")) for k in ("pred_box", "pred_class", "pred_conf")}
    with open(os.path.join(scene_dir, "pred_mask"), "rb") as f:
        masks = pickle.load(f)
    return det, masks


class MemoryScenes:
    """A dataset of ``Sample``s held in memory, named for their artifacts'
    directories, as ``run_scenes`` reads a ``SceneDataset``."""

    def __init__(self, names, samples):
        self.scenes, self._samples = list(names), list(samples)

    def __len__(self):
        return len(self._samples)

    def __getitem__(self, i):
        return self._samples[i]


def room_samples(scenes, gts, frames):
    """Phase 7's rooms as the scene loader would give them: gt boxes rounded
    out (floor, ceil) with their class (chair, sofa or table by size, mapped
    as the ScanNet label map maps nyu40 5, 6, 7), full box masks, frames."""
    from tpu3dsis_torch.io import Sample

    samples = []
    for scene, gt, f in zip(scenes, gts, frames):
        lo, hi = np.floor(gt[:, :3]), np.ceil(gt[:, 3:])
        size_m = (gt[:, 3:] - gt[:, :3]) * VOXEL
        cls = np.where(size_m[:, 1] <= 0.35, 5, np.where(np.maximum(size_m[:, 0], size_m[:, 2]) >= 2.0, 4, 3))
        gt_box = np.concatenate([lo, hi, cls[:, None]], 1).astype(np.float32)
        masks = [np.ones(tuple((h - l).astype(int)), np.uint8) for l, h in zip(lo, hi)]
        samples.append(Sample(sample_id=f"room with {len(f['poses'])} views", data=scene, gt_box=gt_box, gt_mask=masks,
                              world_to_grid=f["world_to_grid"], frame_ids=np.arange(len(f["poses"]), dtype=np.uint32),
                              images=f["images"], depths=f["depths"], poses=f["poses"]))
    return MemoryScenes([f"room{i:04d}_00_{len(f['poses'])}v" for i, f in enumerate(frames)], samples)


def stage_ms(timings):
    n = max(timings["scenes"], 1)
    return {k: round(timings[k] * 1e3 / n, 3) for k in ("read", "infer", "write", "map")}


def phase_drivers(dev, params, cparams, cscenes, cgts, cframes, scene_t, color_t):
    """Phase 8: the entry module on files, then the color stream through
    ``run_scenes``, each path's launches counted; the timings."""
    from tpu3dsis_torch import checkpoint as ckpt
    from tpu3dsis_torch.config import DetectorConfig, cfg_from_file, finalize_config
    from tpu3dsis_torch.infer.driver import run_scenes

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the entry module at full width: test mode, then benchmark twice
        t0 = time.time()
        filelist = write_driver_scenes(tmp)
        snapshot = os.path.join(tmp, "step_0.npz")
        np.savez(snapshot, **{f"param:{k}": v for k, v in params.items()})
        test_dir, bench_dir = os.path.join(tmp, "test"), os.path.join(tmp, "bench")
        test_cfg = write_overlay(os.path.join(tmp, "test_overlay"), USE_IMAGES=False, TEST_FILELIST=filelist,
                                 TEST_SAVE_DIR=test_dir)
        bench_cfg = write_overlay(os.path.join(tmp, "bench_overlay"), USE_IMAGES=False, TEST_FILELIST=filelist,
                                  TEST_SAVE_DIR=bench_dir)
        log(f"[8] {DRIVER_SCENES} scenes of {SCENE_EXTENT} written as .scene files, a param: snapshot of the trained "
            f"geometry and mask weights ({len(params)} keys) and overlays of benchmark.yml (USE_IMAGES False) in "
            f"{time.time() - t0:.1f} s")
        common = ["--step", snapshot, "--output_dir", os.path.join(tmp, "out")]
        launches, card_map, wall = run_entry(["--cfg", test_cfg, "--mode", "test", *common])
        log(f"[8] python -m tpu3dsis_torch.main --mode test: {wall:.1f} s with start-up; launches {launches}; "
            f"{card_map} [{CARD}]")
        check(card_map is not None and all(np.isfinite(v) for v in card_map.values()), f"mAP {card_map}")
        for k in ("roi_pool3d_cuda", "nms3d_cuda", "nms3d_cuda_class_aware"):
            check(launches[k] > 0, f"{k} was not launched by the entry module")
        res["launches"] = launches
        bench_runs = [run_entry(["--cfg", bench_cfg, "--mode", "benchmark", *common]) for _ in range(2)]
        stamps = {s: os.stat(os.path.join(bench_dir, s, "pred_box.npy")).st_mtime_ns for s in os.listdir(bench_dir)}
        log(f"[8] --mode benchmark twice: {bench_runs[0][2]:.1f} s, launches {bench_runs[0][0]}; then "
            f"{bench_runs[1][2]:.1f} s, launches {bench_runs[1][0]} [{CARD}]")
        check(bench_runs[0][0]["roi_pool3d_cuda"] > 0, "the first benchmark run launched no K1")
        check(not any(bench_runs[1][0].values()), "the second benchmark run did not skip every scene")
        check(stamps == {s: os.stat(os.path.join(bench_dir, s, "pred_box.npy")).st_mtime_ns for s in stamps},
              "the second benchmark run rewrote a scene")

        # (b) the artifacts without torch, and the same scenes on the CPU
        n_det = check_artifacts(artifacts_without_torch(test_dir), DRIVER_SCENES, True)
        check_artifacts(artifacts_without_torch(bench_dir), DRIVER_SCENES, False)
        log(f"[8] artifacts of both modes load without torch (numpy uint8 masks, bool index); detections per scene "
            f"{n_det}")
        cfg = finalize_config(cfg_from_file(test_cfg + ".yml"))
        cfg.TEST_SAVE_DIR = os.path.join(tmp, "cpu")
        cpu_det = Detector(DetectorConfig.from_cfg(cfg), device="cpu").init_params(torch.Generator().manual_seed(0))
        ckpt.load_jax_params(cpu_det, ckpt.partial_update(ckpt.module_params(cpu_det), params, cfg))
        t0 = time.time()
        cpu_map = run_scenes(cfg, cpu_det, "test", max_scenes=CPU_DRIVER_SCENES)
        cpu_s = time.time() - t0
        # the card's mAP over the same scenes, from run_scenes in this process
        card_cfg = finalize_config(cfg_from_file(test_cfg + ".yml"))
        card_cfg.TEST_SAVE_DIR = os.path.join(tmp, "card_first")
        card_det = load_jax_params(Detector(DetectorConfig.from_cfg(card_cfg), device=dev), params)
        card_first_map = run_scenes(card_cfg, card_det, "test", max_scenes=CPU_DRIVER_SCENES)
        log(f"[8] mAP of the first {CPU_DRIVER_SCENES} scene(s): card {card_first_map}, CPU {cpu_map} (CPU {cpu_s:.1f} s); "
            f"the entry module's over all {DRIVER_SCENES} {card_map}")
        res["tied_copies"] = 0
        for scene in sorted(os.listdir(cfg.TEST_SAVE_DIR)):
            res["tied_copies"] += compare_card_cpu(
                load_scene_artifacts(os.path.join(test_dir, scene)),
                load_scene_artifacts(os.path.join(cfg.TEST_SAVE_DIR, scene)),
                f"{scene}'s artifacts, the entry module against run_scenes", cpu_s / CPU_DRIVER_SCENES, phase=8,
                box_tol=1e-4, tie_stride=FEAT_STRIDE[0])
        check(len(os.listdir(cfg.TEST_SAVE_DIR)) == CPU_DRIVER_SCENES, "the CPU did not run its scenes")
        check(cpu_map == card_first_map, "the card's and the CPU's mAP differ")
        del card_det
        res["map"] = card_map
        # the test mode's artifacts, kept for phase 11's benchmark export (which removes them)
        res["test_artifacts"] = shutil.copytree(test_dir, os.path.join(tempfile.mkdtemp(), "test"))

        # (d) the geometry driver in this process: read and encode, infer,
        # writes and mAP per scene; test mode (the first pass of this
        # detector), then benchmark mode (no gt, no mAP) into a fresh
        # directory
        cfg = finalize_config(cfg_from_file(test_cfg + ".yml"))
        det = Detector(DetectorConfig.from_cfg(cfg), device=dev)
        ckpt.load_jax_params(det, params)
        res["geometry"] = {}
        for i, mode in enumerate(("test", "benchmark")):
            cfg.TEST_SAVE_DIR = os.path.join(tmp, f"timed{i}")
            timings = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_scenes(cfg, det, mode, timings=timings)
            wall = time.perf_counter() - t0
            res["geometry"][mode] = {"scenes_per_min": 60.0 * timings["scenes"] / wall, "stage_ms": stage_ms(timings)}
        for mode, r in res["geometry"].items():
            log(f"[8] geometry driver, {mode} mode (benchmark.yml: float32, proposals 400 -> 200 per tile, "
                f"CLASS_THRESH 0.5): {r['scenes_per_min']:.2f} scenes/min from .scene files to artifacts"
                f"{' and mAP' if mode == 'test' else ''}; ms per scene " + json.dumps(r["stage_ms"])
                + " (read and encode in the loader thread, overlapped with infer); phase 6's SceneInference float32 "
                f"{scene_t['float32']['scenes_per_min']:.2f} masked scenes/min (proposals 256 -> 32, CLASS_THRESH "
                f"0.3) [{CARD}]")
        del det, cpu_det

        # (c) the color stream: phase 7's rooms with their frames through
        # run_scenes (bf16, ENet, K3), one scene's K3 calls against the plain
        # version, then the path with its launches counted
        ccfg = finalize_config(cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "ScanNet", "benchmark.yml")))
        want = scannet_color_scene_config()
        ccfg.TEST.RPN_PRE_NMS_TOP_N, ccfg.TEST.RPN_POST_NMS_TOP_N = want.TEST.RPN_PRE_NMS_TOP_N, want.TEST.RPN_POST_NMS_TOP_N
        ccfg.CLASS_THRESH, ccfg.TPU_COMPUTE_DTYPE = want.CLASS_THRESH, want.TPU_COMPUTE_DTYPE
        ccfg.INTRINSIC = [list(r) for r in want.INTRINSIC]
        check(DetectorConfig.from_cfg(ccfg) == want, "the color driver's config is not phase 7's")
        cdet = load_jax_params(Detector(want, device=dev), cparams)
        rooms = room_samples(cscenes, cgts, cframes)
        ccfg.TEST_SAVE_DIR = os.path.join(tmp, "color_recorded")
        with recording_kernel_calls() as calls:
            run_scenes(ccfg, cdet, "test", dataset=MemoryScenes(rooms.scenes[1:2], [rooms[1]]))
        k3 = [a for kind, a in calls if kind == "fuse_views_cuda"]
        check(len(k3) == 1, f"the driver made {len(k3)} K3 calls for one color scene, not 1")
        err = max(_k3_case(f"the driver's call, {rooms.scenes[1]}", a, phase=8)[0] for a in k3)
        ccfg.TEST_SAVE_DIR = os.path.join(tmp, "color")
        reset_launch_counts()
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        color_map = run_scenes(ccfg, cdet, "test", dataset=rooms, timings=timings)
        wall = time.perf_counter() - t0
        launches = {"roi_pool3d_cuda": rp.roi_pool3d_cuda.launches, "nms3d_cuda": nms.nms3d_cuda.launches,
                    "nms3d_cuda_class_aware": nms.nms3d_cuda.class_aware_launches,
                    "fuse_views_cuda": projection.fuse_views_cuda.launches}
        log(f"[8] color driver: {len(rooms)} rooms ({[len(f['poses']) for f in cframes]} views), launches {launches}, "
            f"{color_map}")
        for k in launches:
            check(launches[k] > 0, f"{k} was not launched on the color driver path")
        check(launches["fuse_views_cuda"] >= len(rooms), "K3 did not launch for every color scene")
        check(all(np.isfinite(v) for v in color_map.values()), f"color mAP {color_map}")
        check_artifacts(artifacts_without_torch(ccfg.TEST_SAVE_DIR), len(rooms), True)
        res["color"] = {"launches": launches, "k3_err": err, "map": color_map,
                        "scenes_per_min": 60.0 * timings["scenes"] / wall, "stage_ms": stage_ms(timings)}
        log(f"[8] color driver (bf16, views {[len(f['poses']) for f in cframes]}): "
            f"{res['color']['scenes_per_min']:.2f} scenes/min from in-memory samples to artifacts and mAP (first pass); "
            f"ms per scene " + json.dumps(res["color"]["stage_ms"]) + f"; phase 7's SceneInference bfloat16 "
            f"{color_t['bfloat16']['scenes_per_min']:.2f} color masked scenes/min [{CARD}]")
    return res


# --- phase 9: training --------------------------------------------------------------

TRAIN_STEPS = 30
TRAIN_BATCH = {"geometry": 8, "color": 4}  # bench.py:bench_train's batches


def train_batch(rng, n, cfg, color=False):
    """``bench.py:bench_train``'s make_batch, copied: n chunks of noise, four
    gt boxes each with their canvas filled; with color, NUM_IMAGES views a
    chunk of random images (floats in [0, 1), taken as normalised) and
    depths, identity cameras 1 m in front of the grid."""
    max_gt = int(cfg.TPU_MAX_GT)
    gt = np.full((n, max_gt, 7), -1e4, np.float32)
    gt[..., 3:6] = gt[..., :3] + 1.0
    gt[..., 6] = 0.0
    valid = np.zeros((n, max_gt), bool)
    canvas = np.zeros((n, *SHAPE), np.float32)
    for i in range(n):
        for j in range(4):
            x0 = rng.randint(8, SHAPE[0] - 22)
            y0 = rng.randint(4, SHAPE[1] - 14)
            z0 = rng.randint(8, SHAPE[2] - 22)
            sx, sy, sz = rng.randint(6, 14, 3)
            gt[i, j] = [x0, y0, z0, x0 + sx, y0 + sy, z0 + sz, 3 + (j % 4) * 4]
            valid[i, j] = True
            canvas[i, x0:x0 + sx, y0:y0 + sy, z0:z0 + sz] = 1.0
    batch = {"data": rng.randn(n, *SHAPE, 2).astype(np.float32), "gt_box": gt, "gt_valid": valid,
             "mask_canvas": canvas}
    if color:
        v = int(cfg.NUM_IMAGES)
        w_img, h_img = cfg.IMAGE_SHAPE
        w_d, h_d = cfg.DEPTH_SHAPE
        batch["images"] = rng.randint(0, 255, (n, v, h_img, w_img, 3)).astype(np.float32) / 255.0
        batch["depths"] = rng.uniform(0.4, 4.0, (n, v, h_d, w_d)).astype(np.float32)
        poses = np.tile(np.eye(4, dtype=np.float32), (n, v, 1, 1))
        poses[..., 2, 3] = -1.0
        batch["poses"] = poses
        batch["view_valid"] = np.ones((n, v), bool)
        vs = float(cfg.VOXEL_SIZE)
        w2g = np.diag([1 / vs] * 3 + [1.0]).astype(np.float32)
        w2g[:3, 3] = [SHAPE[0] / 2, 0.0, SHAPE[2] / 2]
        batch["world_to_grid"] = np.tile(w2g, (n, 1, 1))
    return batch


def train_detector(dev, cfg, seed=0):
    """A detector with float32 master weights from a seeded generator; an
    ENet that trains (FIX_ENET False) starts, as the shipped configs'
    PRETRAINED_ENET_PATH has it, from a trained ENet: the color fixture's
    (its BatchNorm statistics and biases are not the zeros of a fresh
    init, whose one-step values would be their gradients alone)."""
    from tpu3dsis_torch.config import DetectorConfig

    det = Detector(DetectorConfig.from_cfg(cfg), device=dev, param_dtype=torch.float32)
    det.init_params(torch.Generator().manual_seed(seed))
    if det.enet is not None and not bool(cfg.FIX_ENET):
        load_jax_params(det.enet, {k[len("enet."):]: v for k, v in color_params().items() if k.startswith("enet.")})
    return det


def k1b_bound(feats, rois, batch_idx, level_idx, scales, pooled):
    """K1b's bound in ms, its bytes and their arithmetic: the gradient maps
    written once in the maps' dtype, and what K1 reads and writes read once
    (the covered voxels, the rois and indices, the (M, C, P^3) cotangent),
    over the HBM rate. A compare per covered voxel and channel and an add
    per share take far less at the float32 rate, so bytes bound it."""
    _, k1_bytes = k1_bound(feats, rois, batch_idx, level_idx, scales, pooled)
    itemsize = feats[0].element_size()
    grads = sum(f.numel() for f in feats) * itemsize
    nbytes = k1_bytes + grads
    m, c = rois.shape[0], feats[0].shape[-1]
    cot = m * c * pooled**3 * itemsize
    text = (f"grad maps {' + '.join('x'.join(map(str, f.shape)) for f in feats)} x {itemsize} B = {grads:,} B "
            f"written; cotangent {m}x{c}x{pooled}^3 x {itemsize} B = {cot:,} B, covered voxels, rois and indices "
            f"{k1_bytes - cot:,} B read; {nbytes:,} B / 3.35e12 B/s")
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes, text


def _k1b_case(name, feats, args, grad_out, exact=False, phase=9):
    """K1b against its plain version on one input. The tolerance: 1e-6 of
    the largest gradient in float32, where only the order of the float32
    sums can differ (the kernel sums in autograd's order where the plain
    version's reductions run in index order); one bf16 ulp of each rounded
    result in bfloat16;
    ``torch.equal`` where no voxel lies in two bins (``exact``). Returns
    (max abs error, plain ms)."""
    got = rp.roi_pool3d_backward_cuda(feats, **args, grad_out=grad_out)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = rp.roi_pool3d_backward_plain(feats, **args, grad_out=grad_out)
    end.record()
    end.synchronize()
    err, ok, shares = 0.0, True, 0
    for a, w in zip(got, want):
        a32, w32 = a.float(), w.float()
        diff = (a32 - w32).abs()
        err = max(err, float(diff.max()))
        shares += int((w32 != 0).sum())
        if exact:
            ok &= torch.equal(a, w)
        elif w.dtype == torch.float32:
            ok &= float(diff.max()) <= 1e-6 * float(w32.abs().max())
        else:
            mag = torch.maximum(a32.abs(), w32.abs()).clamp(min=torch.finfo(torch.float32).tiny)
            ok &= bool((diff <= torch.exp2(torch.floor(torch.log2(mag)) - 7)).all())
    scale = max(float(w.float().abs().max()) for w in want)
    rule = "torch.equal" if exact else ("1e-6 relative" if feats[0].dtype == torch.float32 else "one bf16 ulp")
    log(f"[{phase}] K1b {name} {str(feats[0].dtype).split('.')[-1]}, {args['rois'].shape[0]} rois on "
        f"{[tuple(f.shape) for f in feats]}: max_abs_err={err} of max |grad| {scale:.4g} ({rule}: "
        f"{'ok' if ok else 'FAILED'}), nonzero grads {shares}, plain {start.elapsed_time(end):.1f} ms [{CARD}]")
    check(ok, f"K1b {name} differs from its plain version beyond {rule}")
    return err, start.elapsed_time(end)


def k1b_edge_cases(dev, rng):
    """K1b's edges on (4, 24, 12, 24, 128) maps: ties (post-ReLU zeros and
    plateaus of 0.5), empty bins (rois past the volume or thinner than a
    voxel), rois at the map's edges, overlapping rois (one roi and copies of
    it shifted by 1-4 voxels), and rois whose bins share no voxel, one per
    map (exact), 2,100 rois of one sample on one brick (more than a block's
    window of rois, in either dtype) and rois covering the whole map and
    beyond it. Yields (name, feats, args, exact)."""
    g = torch.Generator().manual_seed(3)
    base = torch.randn((2, 4, 24, 12, 24, 128), generator=g)
    ties = torch.relu(torch.round(base * 2) / 2)

    def args(rois, bidx, lidx):
        return {"rois": torch.tensor(np.asarray(rois, np.float32)).to(dev),
                "batch_idx": torch.tensor(np.asarray(bidx, np.int32)).to(dev),
                "level_idx": torch.tensor(np.asarray(lidx, np.int32)).to(dev), "scales": [0.25, 0.25], "pooled": 4}

    mixed = _rois(rng, 4, 32)
    yield "ties (ReLU zeros, 0.5 plateaus)", ties, {**{k: v.to(dev) for k, v in mixed.items()},
                                                    "scales": [0.25, 0.25], "pooled": 4}, False
    edge = [[100, 50, 100, 140, 80, 140], [90, 40, 90, 140, 80, 140], [-20, -8, -20, 6, 3, 6],
            [10.5, 3.2, 7.9, 10.6, 3.3, 8.0], [17, 9, 33, 17, 9, 33], [0, 0, 0, 96, 48, 96], [95, 47, 95, 96, 48, 96],
            [0, 40, 0, 12, 48, 96], [84, 0, 84, 96, 48, 96]]
    yield "empty bins and map edges", base, args(edge * 2, [0] * 9 + [3] * 9, [0] * 9 + [1] * 9), False
    one = np.array([20, 8, 20, 52, 30, 60], np.float32)
    shifted = [one + [dx, dy, dz, dx, dy, dz] for dx, dy, dz in
               [(0, 0, 0), (0, 0, 0), (1, 0, 0), (0, 1, 2), (4, 4, 4), (-2, 0, 3), (3, 2, 1), (0, 0, 4)]]
    yield "overlapping rois", ties, args(shifted, [1] * 8, [0, 1] * 4), False
    yield "disjoint bins", base, args([[0, 0, 0, 64, 32, 64]] * 4 + [[32, 16, 32, 96, 48, 96]] * 4,
                                      [0, 1, 2, 3] * 2, [0] * 4 + [1] * 4), True
    lo = rng.uniform(0, 12, (2100, 3))  # level voxels [0, 3]: every roi meets the brick at the origin
    yield "many rois on one brick", ties, args(np.concatenate([lo, lo + rng.uniform(16, 60, (2100, 3))], 1),
                                               [0] * 2100, [0] * 2100), False
    yield "rois covering the whole map", ties, args([[0, 0, 0, 96, 48, 96], [-40, -20, -40, 140, 70, 140]] * 4,
                                                    [0, 0, 1, 1, 2, 2, 3, 3], [0, 1] * 4), False


def k1b_repeatable(name, feats, args, grad_out, phase=9):
    """Two launches of K1b on the same inputs give the same bits: each
    voxel sums its shares in one fixed order, with no atomics."""
    first = rp.roi_pool3d_backward_cuda(feats, **args, grad_out=grad_out)
    second = rp.roi_pool3d_backward_cuda(feats, **args, grad_out=grad_out)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"[{phase}] K1b {name} {str(feats[0].dtype).split('.')[-1]}: two launches torch.equal: {same} [{CARD}]")
    check(same, f"K1b {name}: two launches on the same inputs differ")


def k1b_kernel_split(fn):
    """Device microseconds per call of each of K1b's two kernels (the column
    pass and the brick pass), from torch.profiler over 10 calls, or over 100
    or 1000 where a shorter window brought back no kernel (as can happen in a
    process that has profiled before); {} if none did."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for calls in (10, 100, 1000):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = defaultdict(float)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and "roi_pool3d_bwd" in e.name:
                split["columns" if "columns" in e.name else "bricks"] += e.time_range.elapsed_us() / calls
        if split:
            return dict(split)
    return {}


def profile_steps(fn, steps=3):
    """Device busy ms per step, the window's ms per step and the top kernels,
    from torch.profiler over `steps` calls of fn (after the caller's
    warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        end.synchronize()
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / steps
    return sum(by_name.values()), start.elapsed_time(end) / steps, sorted(by_name.items(), key=lambda kv: -kv[1])


def train_card_vs_cpu(dev, name="geometry", cfg=None, phase=9):
    """One step on the card and on the CPU, float32 with TF32 off, the same
    weights, batch and draws: every loss term within 1e-3 relative, every
    updated parameter within 1e-4 of its largest magnitude. Geometry, or
    another config (the color stream's batch where it has one; a trained
    ENet starts from the pretrained one). Batch 2 and 4 mask rois a chunk
    (not 8), to bound the CPU's time."""
    from tpu3dsis_torch.checkpoint import module_params
    from tpu3dsis_torch.config import scannet_train_config
    from tpu3dsis_torch.train.trainstep import anchor_count, build_train_step, make_draws

    cfg = scannet_train_config() if cfg is None else cfg
    cfg.TPU_COMPUTE_DTYPE = "float32"
    cfg.TPU_MAX_MASK_ROIS = 4
    n = 2
    card = train_detector(dev, cfg, seed=3)
    cpu = load_jax_params(train_detector("cpu", cfg), module_params(card))
    batch = train_batch(np.random.RandomState(11), n, cfg, color=bool(cfg.USE_IMAGES))
    draws = make_draws(n, anchor_count(card, SHAPE), int(cfg.TRAIN.RPN_POST_NMS_TOP_N) + int(cfg.TPU_MAX_GT),
                       torch.Generator().manual_seed(5), "cpu")
    out = {}
    for where, det in (("card", card), ("cpu", cpu)):
        opt_init, step = build_train_step(det, cfg, SHAPE)
        opt = opt_init()
        t0 = time.time()
        m = step(opt, batch, draws=draws)
        out[where] = ({k: float(v) for k, v in m.items()}, time.time() - t0)
    (mc, t_card), (mp, t_cpu) = out["card"], out["cpu"]
    rel = {k: abs(mc[k] - v) / max(abs(v), 1e-6) for k, v in mp.items()}
    pc, pp = module_params(card), module_params(cpu)
    prel = {k: float(np.abs(pc[k] - v).max() / max(np.abs(v).max(), 1e-30)) for k, v in pp.items()}
    worst = max(prel, key=prel.get)
    log(f"[{phase}] one {name} step, card vs CPU (float32, TF32 off, batch {n}, 4 mask rois): losses card "
        + json.dumps({k: round(v, 6) for k, v in mc.items()}) + f"; largest relative difference "
        f"{max(rel.values()):.3g} ({max(rel, key=rel.get)}); updated parameters: largest max-norm relative "
        f"difference {prel[worst]:.3g} ({worst}); card {t_card:.2f} s (first step), CPU {t_cpu:.2f} s [{CARD}]")
    check(mc["step_finite"] == 1.0 and mp["step_finite"] == 1.0, "a card-vs-CPU step was not finite")
    check(all(v <= 1e-3 for v in rel.values()), f"card and CPU losses differ beyond 1e-3: {rel}")
    check(prel[worst] <= 1e-4, f"card and CPU updated {worst} differ by {prel[worst]:.3g} of its max")
    return {"loss_rel": max(rel.values()), "param_rel": prel[worst]}


def train_run(dev, name, cfg, n, steps=TRAIN_STEPS, phase=9):
    """The training main path: ``build_train_step`` on a fixed batch of n
    synthetic chunks for `steps` steps, every wrapper's count set to 0 just
    before and read just after; then the timings. Every step must be finite
    and the loss fall; K1, K1b and K2 must launch, K3 with the color stream
    and K3b where the ENet trains."""
    from tpu3dsis_torch.train.trainstep import StageTimer, build_train_step

    color = bool(cfg.USE_IMAGES)
    train_enet = color and not bool(cfg.FIX_ENET)
    det = train_detector(dev, cfg)
    opt_init, step = build_train_step(det, cfg, SHAPE)
    opt = opt_init()
    batch = train_batch(np.random.RandomState(7), n, cfg, color)
    # on the card once, as bench_train keeps its batch (the poses and
    # world-to-grid matrices stay on the host, where the view fusion reads them)
    batch = {k: (v if k in ("poses", "world_to_grid") else torch.from_numpy(v).to(dev)) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.time()
    step(opt, batch, generator=gen)  # warm-up: cuDNN's plans, the allocator
    torch.cuda.synchronize()
    first = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    before = device_launches()
    events, metrics = [], []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(step(opt, batch, generator=gen))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    launches = {"roi_pool3d_cuda": rp.roi_pool3d_cuda.launches,
                "roi_pool3d_backward_cuda": rp.roi_pool3d_backward_cuda.launches,
                "nms3d_cuda": nms.nms3d_cuda.launches, "fuse_views_cuda": projection.fuse_views_cuda.launches,
                "fuse_views_backward_cuda": projection.fuse_views_backward_cuda.launches}
    kernel_launches = {k: v - before[k] for k, v in device_launches().items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["total_loss"]) for m in metrics]
    finite = [float(m["step_finite"]) for m in metrics]
    ms = [s.elapsed_time(e) for s, e in events]
    s_iter = statistics.median(ms[5:]) / 1e3
    stages = []
    for _ in range(3):
        timer = StageTimer(det.device)
        step(opt, batch, generator=gen, timer=timer)
        stages.append(timer.ms())
    stage_ms = {k: statistics.median(t[k] for t in stages) for k in stages[0]}
    stage_ms["forward_without_targets"] = stage_ms["forward"] - stage_ms.get("targets", 0.0)
    busy, window, top = profile_steps(lambda: step(opt, batch, generator=gen))
    res = {"s_per_iter": s_iter, "chunks_per_s": n / s_iter, "peak_gb": peak / 1e9, "first_step_s": first,
           "stage_ms": stage_ms, "idle_share": 1 - busy / window, "busy_ms": busy, "window_ms": window,
           "launches": launches, "kernel_launches": kernel_launches, "first_loss": losses[0], "last_loss": losses[-1]}
    log(f"[{phase}] {name} training, bf16, batch {n}, {steps} steps on one batch: total_loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f} (first five {np.mean(losses[:5]):.5f}, last five {np.mean(losses[-5:]):.5f}), "
        f"step_finite {sum(finite):.0f}/{steps}; wrapper calls {launches}, kernel launches {kernel_launches} "
        f"[{CARD}]")
    log(f"[{phase}] {name} training: {s_iter:.4f} s/iter, {n / s_iter:.2f} chunks/s (CUDA-event median of steps 6-{steps}; "
        f"first step {first:.1f} s), peak memory {peak / 1e9:.2f} GB; ms per step by stage (median of 3, "
        f"forward includes the targets) " + json.dumps({k: round(v, 3) for k, v in stage_ms.items()})
        + f"; profile of 3 steps: device busy {busy:.3f} ms of a {window:.3f} ms window, idle share "
        f"{1 - busy / window:.3f}; top kernels (ms per step): "
        + json.dumps({k[:60]: round(v, 3) for k, v in top[:10]}) + f" [{CARD}]")
    check(all(f == 1.0 for f in finite), f"{name}: a training step was not finite")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]), f"{name}: total_loss did not fall: {losses}")
    want = ["roi_pool3d_cuda", "roi_pool3d_backward_cuda", "nms3d_cuda"] + (["fuse_views_cuda"] if color else [])
    want += ["fuse_views_backward_cuda"] if train_enet else []
    for k in want:
        check(launches[k] > 0 and kernel_launches[k] > 0, f"{name} training did not launch {k}")
    return res, det, opt, step, batch, gen


def write_train_chunks(tmp, n=6):
    """n 96x48x96 chunks of four objects (make_chunks' draws), as `.chunk`
    files with nyu40 labels and full box masks; the filelist's path."""
    from tpu3dsis_torch.io import write_chunk_file

    paths = []
    rng = np.random.RandomState(60)
    for i in range(n):
        sdf = np.full(SHAPE, 8.0, np.float32)
        boxes, kinds = [], []
        for kind in ("sofa", "chair", "chair", "table"):
            placed = len(boxes)
            _add_object(sdf, boxes, rng, kind)
            kinds += [kind] * (len(boxes) - placed)
        boxes = np.asarray(boxes, np.float32)
        path = os.path.join(tmp, f"scene{i:04d}_00__{i}__.chunk")
        write_chunk_file(path, sdf, boxes, np.asarray([KIND_NYU40[k] for k in kinds], np.uint32),
                         [np.ones(tuple((b[3:] - b[:3]).astype(int)), np.uint16) for b in boxes],
                         np.ones(len(boxes), np.float32), np.eye(4, dtype=np.float32), np.zeros(0, np.uint32))
        paths.append(path)
    filelist = os.path.join(tmp, "train.txt")
    with open(filelist, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    return filelist


def phase_train_entry(params):
    """``python -m tpu3dsis_torch.main --mode train`` on a small `.chunk`
    corpus (bf16; pretrained from a ``param:`` snapshot of phase 6's
    weights through ``partial_update``): a snapshot is written; a second run
    resumes from it; ``--mode test --step <that snapshot>`` loads it and
    runs a scene."""
    from tpu3dsis_torch.io import write_chunk_file

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        filelist = write_train_chunks(tmp)
        sdf, boxes, kinds = scene_objects(np.random.RandomState(70), extent=(144, 48, 144), n_objects=8)
        scene = os.path.join(tmp, "scene0100_00__synthetic.scene")
        write_chunk_file(scene, sdf, boxes, np.asarray([KIND_NYU40[k] for k in kinds], np.uint32),
                         [np.ones(tuple((b[3:] - b[:3]).astype(int)), np.uint16) for b in boxes],
                         np.ones(len(boxes), np.float32), np.eye(4, dtype=np.float32), np.zeros(0, np.uint32))
        scenes = os.path.join(tmp, "scenes.txt")
        with open(scenes, "w") as f:
            f.write(scene + "\n")
        pretrained = os.path.join(tmp, "pretrained.npz")
        np.savez(pretrained, **{f"param:{k}": v for k, v in params.items()})
        cfg = write_overlay(os.path.join(tmp, "train_overlay"), USE_IMAGES=False, TRAIN_FILELIST=filelist,
                            VAL_FILELIST="", TRAINVAL_FILELIST="", VAL_TIME=0.0, DISPLAY=1, SNAPSHOT_KEPT=0,
                            TPU_COMPUTE_DTYPE="bfloat16", TPU_MASK_CANVAS=[64, 48, 64], TEST_FILELIST=scenes,
                            TEST_SAVE_DIR=os.path.join(tmp, "test"))
        out_root = os.path.join(tmp, "out")
        ckpt_dir = os.path.join(out_root, cfg, "checkpoints")  # main.py joins --output_dir and --cfg
        common = ["--cfg", cfg, "--output_dir", out_root]
        lines = []
        launches, _, wall = run_entry([*common, "--mode", "train", "--max_steps", "3", "--step", pretrained],
                                      stdout=lines)
        losses = [l for l in lines if l.startswith("epoch ")]
        log(f"[9] python -m tpu3dsis_torch.main --mode train --max_steps 3 --step <phase 6 weights>: {wall:.1f} s "
            f"with start-up; launches {launches}; {losses}; snapshots {sorted(os.listdir(ckpt_dir))} [{CARD}]")
        check(os.path.isfile(os.path.join(ckpt_dir, "step_3.npz")), "--mode train wrote no step_3.npz")
        for k in ("roi_pool3d_cuda", "roi_pool3d_backward_cuda", "nms3d_cuda"):
            check(launches[k] > 0, f"--mode train did not launch {k}")
        res["launches"] = launches
        lines = []
        launches2, _, wall = run_entry([*common, "--mode", "train", "--max_steps", "2"], stdout=lines)
        restored = [l for l in lines if l.startswith("restored from")]
        log(f"[9] a second --mode train --max_steps 2: {wall:.1f} s; {restored}; snapshots "
            f"{sorted(os.listdir(ckpt_dir))} [{CARD}]")
        check(restored and restored[0].endswith("step_3.npz at step 3"), f"the second run did not resume: {restored}")
        check(os.path.isfile(os.path.join(ckpt_dir, "step_5.npz")), "the resumed run wrote no step_5.npz")
        launches3, test_map, wall = run_entry([*common, "--mode", "test", "--step",
                                               os.path.join(ckpt_dir, "step_5.npz")])
        log(f"[9] --mode test --step step_5.npz on one {(144, 48, 144)} scene: {wall:.1f} s; launches {launches3}; "
            f"{test_map} [{CARD}]")
        check(test_map is not None and all(np.isfinite(v) for v in test_map.values()), f"test mode mAP {test_map}")
        check(launches3["roi_pool3d_cuda"] > 0 and launches3["nms3d_cuda"] > 0, "test mode launched no K1 or K2")
    return res


def phase_train(dev, kernel_data, params):
    """Phase 9: K1b against its plain version, one step card vs CPU, the
    geometry and color training paths at full width, the entry module."""
    from tpu3dsis_torch.config import scannet_train_config

    t_phase = time.time()
    rng = np.random.RandomState(9)
    res = {"k1b_err": 0.0}
    card_cpu = train_card_vs_cpu(dev)

    runs = {}
    for name in ("geometry", "color"):
        cfg = scannet_train_config(color=name == "color")
        runs[name] = train_run(dev, name, cfg, TRAIN_BATCH[name])
        _, det, opt, step, batch, gen = runs[name]
        # every kernel call of one step, held against its plain version
        with recording_kernel_calls() as calls:
            step(opt, batch, generator=gen)
        torch.cuda.synchronize()
        kinds = [k for k, _ in calls]
        errs = check_recorded_k1_k2(calls, f"{name} training step", phase=9)
        res["k1_err"] = max(res.get("k1_err", 0.0), errs["k1_err"])
        res["k2_err"] = max(res.get("k2_err", 0.0), errs["k2_err"])
        for kind, args in calls:
            if kind == "fuse_views_cuda":
                res["k3_err"] = max(res.get("k3_err", 0.0), _k3_case(f"{name} training step", args, quiet=True,
                                                                      phase=9)[0])
            if kind == "roi_pool3d_backward_cuda":
                args = dict(args)
                feats, g = args.pop("feats"), args.pop("grad_out")
                if name == "geometry":
                    res["training_call"] = (feats, args, g)
                for dt in (torch.bfloat16, torch.float32):
                    err, plain_ms = _k1b_case(f"{name} training call", [f.to(dt) for f in feats], args, g.to(dt))
                    res["k1b_err"] = max(res["k1b_err"], err)
                    k1b_repeatable(f"{name} training call", [f.to(dt) for f in feats], args, g.to(dt))
                    if name == "geometry":
                        res[f"k1b_plain_ms_{str(dt).split('.')[-1]}"] = plain_ms
        log(f"[9] {name} step's kernel calls: {kinds}")
        runs[name] = runs[name][0]

    feats_k, k1, _ = kernel_data
    g = torch.Generator().manual_seed(4)
    cases = {"training call": res.pop("training_call")}
    for dt in (torch.float32, torch.bfloat16):
        f = list(feats_k.to(dt).unbind(0))
        cot = torch.randn((k1["rois"].shape[0], 128, 4, 4, 4), generator=g).to(dev, dt)
        err, plain_ms = _k1b_case("phase 2's rois", f, k1, cot)
        res["k1b_err"] = max(res["k1b_err"], err)
        res[f"k1b_plain_ms_phase2_{str(dt).split('.')[-1]}"] = plain_ms
        k1b_repeatable("phase 2's rois", f, k1, cot)
        cases["phase 2's rois"] = (f, k1, cot)
        for case, feats, args, exact in k1b_edge_cases(dev, rng):
            cot = torch.randn((args["rois"].shape[0], 128, 4, 4, 4), generator=g).to(dev, dt)
            err, _ = _k1b_case(case, list(feats.to(dev, dt).unbind(0)), args, cot, exact=exact)
            res["k1b_err"] = max(res["k1b_err"], err)

    # K1b's time and bound on the geometry training call and on phase 2's
    # rois, in both dtypes (the wrapper: maps from torch.empty and the kernel)
    per_step = runs["geometry"]["launches"]["roi_pool3d_backward_cuda"] / TRAIN_STEPS
    res["k1b_times"] = {}
    for case, (feats, args, g) in cases.items():
        for dt in (torch.bfloat16, torch.float32):
            f, gd, name = [x.to(dt) for x in feats], g.to(dt), str(dt).split(".")[-1]
            call = lambda: rp.roi_pool3d_backward_cuda(f, **args, grad_out=gd)  # noqa: E731
            ms = device_ms(call, 20)
            split = k1b_kernel_split(call)
            bound, nbytes, arithmetic = k1b_bound(f, **args)
            plain = res[f"k1b_plain_ms_{name}" if case == "training call" else f"k1b_plain_ms_phase2_{name}"]
            res["k1b_times"][f"{case} {name}"] = {"ms": ms, "bound_ms": bound, "plain_ms": plain, "us_by_kernel": split}
            log(f"[9] K1b on the {case}, {name} ({args['rois'].shape[0]} rois on {[tuple(x.shape) for x in f]}): "
                f"{ms:.5f} ms device time (maps from torch.empty, the kernels; us by kernel from a profile "
                f"{ {k: round(v, 2) for k, v in split.items()} if split else 'not captured'}), plain {plain:.1f} ms, "
                f"bound {bound:.5f} ms "
                f"({arithmetic}), {bound / ms:.3f} of it; calls per training step {per_step:.0f} [{CARD}]")
    train_call = res["k1b_times"]["training call bfloat16"]
    res["k1b_ms"], res["k1b_bound_ms"], res["k1b_plain_ms"] = (train_call["ms"], train_call["bound_ms"],
                                                               train_call["plain_ms"])
    res["entry"] = phase_train_entry(params)
    res.update(runs=runs, card_vs_cpu=card_cpu)
    log(f"[9] phase 9 in {time.time() - t_phase:.1f} s")
    return res


# --- phase 10: ENet training through the view fusion (K3b), and SUNCG --------------------

ENET_STEPS = 30
SUNCG_STEPS = 10
K3B_TOL = 1e-5  # of the largest gradient: a pixel's float32 shares summed in another order (atomics)


def enet_train_config():
    """``scannet_train_config(color=True)`` with the ENet trained (FIX_ENET False)."""
    from tpu3dsis_torch.config import scannet_train_config

    cfg = scannet_train_config(color=True)
    cfg.FIX_ENET = False
    return cfg


def k3b_samples(args):
    """One batched K3b call's arguments as each sample's arguments of
    ``fuse_views_backward_plain`` (no kernel operands)."""
    n = args["feats2d"].shape[0]
    valid = args.get("view_valid")
    return [dict(grad_out=args["grad_out"][i], feats2d=args["feats2d"][i], depths=args["depths"][i],
                 poses=args["poses"][i], world_to_grid=args["world_to_grid"][i], intrinsic=args["intrinsic"],
                 volume_dims=args["volume_dims"], depth_min=args["depth_min"], depth_max=args["depth_max"],
                 voxel_size=args["voxel_size"], view_valid=None if valid is None else valid[i]) for i in range(n)]


def k3b_bound(args):
    """K3b's bound in ms on one batched call, its bound_by, its bytes, the
    voxels that some valid view accepts and the (view, pixel) rows that
    accept some voxel, summed over the samples, and the bound in ms were
    every feature row read: the cotangent rows of those voxels and the
    feature rows of those pixels (the only rows the gradient depends on)
    read once, the depths, matrices and flags read once and the (B, V, H,
    W, C) float32 gradient written once (bytes), or K3's projections for
    the (brick, view) pairs its cull keeps (operations, at
    K3_OPS_PER_PROJECTION a projection)."""
    nbytes = projections = touched = rows = every_row = 0
    for one in k3b_samples(args):
        feats2d, depths = one["feats2d"], one["depths"]
        v, h, w, c = feats2d.shape
        mats, intr, bounds, coords, depths32, valid = projection._plain_setup(
            feats2d, depths, one["poses"], one["world_to_grid"], one["intrinsic"], one["volume_dims"],
            one["depth_min"], one["depth_max"], one["voxel_size"], one["view_valid"])
        accepted = torch.zeros(coords[0].numel(), dtype=torch.bool, device=feats2d.device)
        for i in range(v):
            if not bool(valid[i]):
                continue
            accept, pix = projection._project(mats[i], depths32[i], *intr, coords, *bounds)
            accepted |= accept
            rows += int(torch.zeros(h * w, dtype=torch.bool, device=feats2d.device).index_fill_(
                0, pix[accept], True).sum())
        n = int(accepted.sum())
        lo, hi = projection.brick_bounds(one["volume_dims"], depths.device)
        projections += int(((hi - lo + 1).prod(1) * k3_kept(one).sum(1)).sum())
        fixed = feats2d.numel() * 4 + depths.numel() * 4 + v * (12 * 4 + 1) + n * c * 4
        nbytes += fixed
        every_row += fixed + feats2d.numel() * 4
        touched += n
    rows_bytes = rows * args["feats2d"].shape[-1] * 4
    nbytes += rows_bytes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, projections * K3_OPS_PER_PROJECTION / FP32_OPS_PER_S * 1e3
    every_ms = max(every_row / HBM_BYTES_PER_S * 1e3, t_ops)
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes"), nbytes, touched, rows, every_ms


def _k3b_case(name, args, phase=10):
    """K3b on one batched call against its plain version (autograd of
    ``fuse_views_plain``, per sample, stacked): max abs error within K3B_TOL
    of the largest gradient. Returns (max abs err, plain ms, the plain
    gradient)."""
    got = projection.fuse_views_backward_cuda(**args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = projection.fuse_views_backward_batch_plain(**{k: v for k, v in args.items()
                                                         if k not in ("mats", "rank", "margins")})
    end.record()
    end.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    ok = err <= K3B_TOL * scale
    valid = args.get("view_valid")
    n_valid = (torch.as_tensor(valid).bool().sum(1).tolist() if valid is not None
               else [args["feats2d"].shape[1]] * args["feats2d"].shape[0])
    log(f"[{phase}] K3b {name}: {tuple(args['feats2d'].shape)} from {tuple(args['grad_out'].shape)}, valid views "
        f"per sample {n_valid}: max_abs_err={err} of max |grad| {scale:.4g} ({K3B_TOL:g} relative: "
        f"{'ok' if ok else 'FAILED'}), nonzero grads {int((want != 0).sum())}, plain {start.elapsed_time(end):.1f} ms "
        f"[{CARD}]")
    check(scale > 0, f"K3b {name}: the gradient is all 0")
    check(ok, f"K3b {name} differs from its plain version beyond {K3B_TOL:g} of its largest gradient")
    return err, start.elapsed_time(end), want


def k3b_edge_cases(args, rng):
    """K3b's edges on a training step's batched call, its operands made anew
    from the poses: exact ties (views 1 and 2 copies of view 0, view 4 of
    view 3, in every sample), features exactly 0 and plateaus (ReLU of values
    rounded to halves), invalid views (view 1 of sample 0, every view of
    sample 2), and all at once. Yields (name, args)."""
    feats, depths = args["feats2d"], args["depths"]
    poses = np.array(torch.as_tensor(args["poses"]).cpu().numpy())
    dup_f, dup_d, dup_p = feats.clone(), depths.clone(), poses.copy()
    for i, j in ((1, 0), (2, 0), (4, 3)):
        dup_f[:, i], dup_d[:, i], dup_p[:, i] = feats[:, j], depths[:, j], poses[:, j]
    zeros = torch.relu(torch.round(feats * 2) / 2)
    b, v = feats.shape[:2]
    invalid = torch.ones((b, v), dtype=torch.bool, device=feats.device)
    invalid[0, 1] = False
    invalid[min(2, b - 1)] = False
    base = dict(args, mats=None, rank=None, margins=None)
    yield "duplicated views (ties of 3 and 2)", dict(base, feats2d=dup_f, depths=dup_d, poses=dup_p)
    yield "exact zeros and plateaus", dict(base, feats2d=zeros)
    yield "invalid views, a sample with none valid", dict(base, view_valid=invalid)
    yield "duplicated views, exact zeros, invalid views", dict(base, feats2d=torch.relu(torch.round(dup_f * 2) / 2),
                                                               depths=dup_d, poses=dup_p, view_valid=invalid)


def k3b_room_case(dev, rng, n_views=32):
    """K3b's arguments on one of phase 7's rooms, a batch of one (cameras
    standing in it, so the cull drops most (brick, view) pairs), its whole
    240x48x240 volume: features of exact zeros and plateaus (ties at 0
    between views that accept a voxel and views culled for its brick), a
    random cotangent."""
    _, _, frames = make_color_scene(rng, n_views)
    cfg = scannet_color_scene_config()
    g = torch.Generator(device=dev).manual_seed(5)
    feats = torch.relu(torch.round(torch.randn((1, n_views, 32, 41, 128), generator=g, device=dev) * 2) / 2)
    return dict(grad_out=torch.randn((1, *SCENE_EXTENT, 128), generator=g, device=dev), feats2d=feats,
                depths=torch.from_numpy(frames["depths"]).to(dev)[None], poses=frames["poses"][None],
                world_to_grid=frames["world_to_grid"][None], intrinsic=cfg.INTRINSIC, volume_dims=SCENE_EXTENT,
                depth_min=cfg.PROJ_DEPTH_MIN, depth_max=cfg.PROJ_DEPTH_MAX, voxel_size=cfg.VOXEL_SIZE,
                view_valid=torch.ones((1, n_views), dtype=torch.bool, device=dev))


def k3b_kernel_split(fn):
    """Device microseconds per call of each kernel a K3b call runs (pass 1
    with the gradient's zero fill, pass 2, the memset of the list's length
    and bitmap), from torch.profiler over 10 calls, or 100 where 10 brought
    back none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    names = {"k3b_list_pass": "pass 1 (zero fill, list)", "k3b_grad_pass": "pass 2 (gradient)"}
    for calls in (10, 100):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = defaultdict(float)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = next((v for k, v in names.items() if k in e.name), e.name[:40])
                split[name] += e.time_range.elapsed_us() / calls
        if split:
            return dict(split)
    return {}


@contextlib.contextmanager
def counting_view_matrices():
    """Within the block, the calls of ``projection.view_matrices`` (the host's
    matrix work), as a list of the shapes of their poses."""
    calls, original = [], projection.view_matrices

    def counted(poses, world_to_grid):
        calls.append(tuple(np.shape(poses)))
        return original(poses, world_to_grid)

    projection.view_matrices = counted
    try:
        yield calls
    finally:
        projection.view_matrices = original


def phase_suncg(dev):
    """SUNCG (``suncg_train_config()``, the shipped yml): 10 bf16 training
    steps at batch 4, finite, the loss falling; chunk detection with the color stream on one
    chunk with its frames, card against CPU in float32 (TF32 off), on the
    trained weights; bf16 chunks/s at batch 32 on the card."""
    from tpu3dsis_torch.checkpoint import module_params
    from tpu3dsis_torch.config import DetectorConfig, suncg_train_config

    cfg = suncg_train_config()
    run, det, _, _, batch, _ = train_run(dev, "SUNCG", cfg, TRAIN_BATCH["color"], steps=SUNCG_STEPS, phase=10)
    params = module_params(det)
    dcfg = DetectorConfig.from_cfg(cfg)
    cfg32 = dcfg.replace(TPU_COMPUTE_DTYPE="float32")
    det32 = load_jax_params(Detector(cfg32, device=dev), params)
    cpu = load_jax_params(Detector(cfg32, device="cpu"), params)
    scenes, _ = make_chunks(np.random.RandomState(12), BATCH)
    frames = {k: (batch[k][0].cpu().numpy() if torch.is_tensor(batch[k]) else batch[k][0])
              for k in ("images", "depths", "poses", "world_to_grid", "view_valid")}
    card = build_inference_fn(det32, cfg32, SHAPE)(torch.from_numpy(scenes[:1]), frames=frames)
    t0 = time.time()
    want = build_inference_fn(cpu, cfg32, SHAPE)(torch.from_numpy(scenes[:1]), frames=frames)
    cpu_s = time.time() - t0
    errs = compare_chunk_outputs(card, want, "one SUNCG chunk with its 5 views (ENet, K3)", phase=10)
    det16 = load_jax_params(Detector(dcfg, device=dev), params)
    infer16 = build_inference_fn(det16, dcfg, SHAPE)
    with torch.inference_mode():
        vol = det16.project_frames(frames, SHAPE)  # one chunk's fused volume, bf16, for every chunk of the batch
    x = torch.from_numpy(scenes).to(dev)
    imageft = vol[None].expand(BATCH, *vol.shape).contiguous()
    reset_launch_counts()
    out = infer16(x, imageft=imageft)
    torch.cuda.synchronize()
    check(bool(out["valid"].any()), "SUNCG detection kept no proposal")
    launches = {"roi_pool3d_cuda": rp.roi_pool3d_cuda.launches, "nms3d_cuda": nms.nms3d_cuda.launches}
    check(all(v > 0 for v in launches.values()), f"SUNCG detection did not launch K1 and K2: {launches}")
    ms = cuda_ms(lambda: infer16(x, imageft=imageft), 5)
    log(f"[10] SUNCG chunk detection, bf16, batch {BATCH} (one chunk's fused color volume for each): {ms:.3f} ms a "
        f"batch, {BATCH / ms * 1e3:.1f} chunks/s (median of 5, CUDA events); launches {launches}; card vs CPU "
        f"{errs}, CPU {cpu_s:.1f} s [{CARD}]")
    return {"train": run, "chunks_per_s_bf16": BATCH / ms * 1e3, "batch_ms": ms, "card_vs_cpu": errs}


def phase_enet(dev):
    """Phase 10: one float32 step with the ENet trained, card against CPU;
    30 bf16 steps with the ENet trained (K3 four launches a step, K3b one);
    the step's one batched K3b call, edge cases and a room against the plain
    version per sample; K3b's time, host time, bound and two passes; SUNCG."""
    t_phase = time.time()
    rng = np.random.RandomState(10)
    res = {"k3b_err": 0.0}
    res["card_vs_cpu"] = train_card_vs_cpu(dev, "trainable-ENet color", enet_train_config(), phase=10)

    run, det, opt, step, batch, gen = train_run(dev, "trainable-ENet color", enet_train_config(),
                                                TRAIN_BATCH["color"], steps=ENET_STEPS, phase=10)
    per_step = {k: run["launches"][k] / ENET_STEPS for k in ("fuse_views_cuda", "fuse_views_backward_cuda")}
    check(per_step == {"fuse_views_cuda": TRAIN_BATCH["color"], "fuse_views_backward_cuda": 1}
          and run["kernel_launches"]["fuse_views_backward_cuda"] == ENET_STEPS,
          f"a trainable-ENet step of {TRAIN_BATCH['color']} launches K3 once a sample and K3b once: {per_step}, "
          f"library launches {run['kernel_launches']}")
    with recording_kernel_calls() as calls, counting_view_matrices() as matrix_calls:
        step(opt, batch, generator=gen)
    torch.cuda.synchronize()
    errs = check_recorded_k1_k2(calls, "trainable-ENet training step", phase=10)
    res["k1_err"], res["k2_err"] = errs["k1_err"], errs["k2_err"]
    k3b_calls = []
    for kind, args in calls:
        if kind == "fuse_views_cuda":
            check(args["mats"] is not None and args["mats"].is_cuda, "a step's K3 call made its own matrices")
            res["k3_err"] = max(res.get("k3_err", 0.0), _k3_case("trainable-ENet training step", args, quiet=True,
                                                                  phase=10)[0])
        if kind == "fuse_views_backward_cuda":
            k3b_calls.append(args)
    log(f"[10] trainable-ENet step's kernel calls: {[k for k, _ in calls]}; view_matrices calls (poses' shapes): "
        f"{matrix_calls}")
    check(len(k3b_calls) == 1, f"{len(k3b_calls)} K3b calls in a step of {TRAIN_BATCH['color']}, not one")
    check(matrix_calls == [(TRAIN_BATCH["color"], int(enet_train_config().NUM_IMAGES), 4, 4)],
          f"a step made its view matrices other than once for the batch: {matrix_calls}")
    training = k3b_calls[0]
    check(all(torch.is_tensor(training[k]) and training[k].is_cuda for k in ("mats", "rank", "view_valid", "margins")),
          "the step's K3b call did not take the forward's operands on the card")
    torch.cuda.set_sync_debug_mode("error")  # the backward's call waits for nothing on the host
    try:
        projection.fuse_views_backward_cuda(**training)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    res["k3b_err"], res["k3b_plain_ms"], _ = _k3b_case("the training step's batched call", training)
    for name, case in k3b_edge_cases(training, rng):
        res["k3b_err"] = max(res["k3b_err"], _k3b_case(name, case)[0])
    room = k3b_room_case(dev, rng)
    err, room_plain_ms, _ = _k3b_case("a 32-view room, exact zeros and plateaus", room)
    res["k3b_err"] = max(res["k3b_err"], err)

    # time, host time, bound, the two passes, repeatability on the training call and the room
    res["k3b_times"] = {}
    for case, args in (("training call", training), ("32-view room", room)):
        if case == "32-view room":  # the wrapper's own operands, then the forward's, as the step gives them
            args = dict(args, **dict(zip(("mats", "view_valid", "rank", "margins"), projection.batch_operands(
                args["poses"], args["world_to_grid"], args["view_valid"], *args["feats2d"].shape[:2], dev))))
        call = lambda: projection.fuse_views_backward_cuda(**args)  # noqa: E731
        first, second = call(), call()
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        del first, second
        ms = device_ms(call, 20)
        events_ms = cuda_ms(call, 20)
        wrapper_ms = host_ms(call, 20)
        split = k3b_kernel_split(call)
        bound, bound_by, nbytes, touched, rows, every_row_ms = k3b_bound(args)
        full_cot = int(np.prod(args["grad_out"].shape)) * 4
        plain = res["k3b_plain_ms"] if case == "training call" else room_plain_ms
        res["k3b_times"][case] = {"ms": ms, "ms_events": events_ms, "host_ms": wrapper_ms, "bound_ms": bound,
                                  "bound_by": bound_by, "bound_share": bound / ms, "plain_ms": plain,
                                  "us_by_kernel": split, "launches_equal": same, "touched_voxels": touched,
                                  "accepting_rows": rows, "every_row_bound_ms": every_row_ms,
                                  "every_row_bound_share": every_row_ms / ms}
        log(f"[10] K3b on the {case} ({tuple(args['feats2d'].shape)} float32 from {tuple(args['grad_out'].shape)}, "
            f"one call): {ms:.5f} ms device time (20 calls queued behind a device sleep: the memset of the list's "
            f"length and bitmap, pass 1, pass 2); {events_ms:.5f} ms the median of CUDA events around each call; the wrapper's host "
            f"time {wrapper_ms:.5f} ms (the host's clock around the call); us by kernel "
            f"{ {k: round(v, 2) for k, v in split.items()} if split else 'not captured'}; plain {plain:.1f} ms, "
            f"bound {bound:.5f} ms by {bound_by} ({nbytes:,} B: the cotangent rows of the {touched:,} voxels some "
            f"view accepts and the feature rows of the {rows:,} (view, pixel) rows that accept some voxel read, the "
            f"gradient written, depths; the whole cotangent would add "
            f"{(full_cot - touched * args['feats2d'].shape[-1] * 4) / HBM_BYTES_PER_S * 1e3:.5f} ms), "
            f"{bound / ms:.3f} of it; with every feature row read the bound would be {every_row_ms:.5f} ms "
            f"({every_row_ms / ms:.3f} of it); two launches torch.equal: {same}; K3b launches per training step "
            f"{per_step['fuse_views_backward_cuda']:.0f} [{CARD}]")
    train_call = res["k3b_times"]["training call"]
    res["k3b_ms"], res["k3b_bound_ms"], res["k3b_bound_by"] = (train_call["ms"], train_call["bound_ms"],
                                                               train_call["bound_by"])
    res.update(run=run, per_step=per_step)
    del det, opt, step, batch, calls, k3b_calls, training, room
    torch.cuda.empty_cache()
    res["suncg"] = phase_suncg(dev)
    log(f"[10] phase 10 in {time.time() - t_phase:.1f} s")
    return res


# --- phase 11: the mask FCN's color branch, the color-only backbone, the benchmark export ---------

MASK_COLOR_STEPS = 30
ONLY_IMAGES_STEPS = 3
MASK_FLIPS = 0.005  # the share of a box's mask voxels that may flip at the threshold (compare_card_cpu's)


def matching_params(cfg, seed=11):
    """Weights for a detector of ``cfg``: the trained color fixture's where
    the shapes match, the rest (the branches no shipped config has: the mask
    FCN's color and combine branches and its geometry branch's last conv,
    the color-only stream's last convs) from a seeded generator."""
    from tpu3dsis_torch.checkpoint import module_params

    own = module_params(Detector(cfg, device="cpu").init_params(torch.Generator().manual_seed(seed)))
    fixture = color_params()
    return {k: (fixture[k] if k in fixture and fixture[k].shape == v.shape else v) for k, v in own.items()}


def mask_routes_agree(routes, det, label, phase=11):
    """Each route's masks against the first's: the same boxes, each within
    MASK_FLIPS of its voxels. Returns the flips per route."""
    names = list(routes)
    want = routes[names[0]]
    out = {}
    for name in names[1:]:
        got = routes[name]
        check(len(got) == len(want) == len(det["pred_box"]), f"{label}: {name} gave {len(got)} masks")
        worst, flipped = 0.0, 0
        for a, b in zip(got, want):
            check(a.shape == b.shape and a.dtype == np.uint8, f"{label}: {name} mask shape {a.shape} vs {b.shape}")
            if a.size:
                worst = max(worst, float((a != b).mean()))
                flipped += int((a != b).sum())
        out[name] = {"flipped": flipped, "worst_box": worst}
        check(worst < MASK_FLIPS, f"{label}: {name}'s masks differ from {names[0]}'s in {worst} of a box's voxels")
    log(f"[{phase}] {label}: {len(want)} masks ({sum(m.size for m in want)} voxels); against {names[0]}: "
        + json.dumps(out) + f" [{CARD}]")
    return out


def phase_mask_color(dev, cparams, scenes, frames, drv):
    """Phase 11: the mask FCN's color branch (MASK_USE_IMAGES) served and
    trained, the color-only backbone (ONLY_IMAGES) served and trained, and
    the benchmark export of phase 8's artifacts."""
    t_phase = time.time()
    res = {"k3_err": 0.0, "k1_err": 0.0, "k2_err": 0.0}
    base = scannet_color_scene_config().replace(MASK_USE_IMAGES=True)
    params = matching_params(base)
    sis = {dt: SceneInference(load_jax_params(Detector(base.replace(TPU_COMPUTE_DTYPE=dt), device=dev), params),
                              base.replace(TPU_COMPUTE_DTYPE=dt)) for dt in ("float32", "bfloat16")}

    # (a) every kernel call of one fused room, and K3's per-window calls
    # (TPU_SCENE_COLOR_RESIDENT "never": each mask window fuses its own views)
    with torch.inference_mode():
        for dt, si in sis.items():
            calls = recorded_kernel_calls(si, scenes[1], dict(frames[1]))
            k3 = [a for kind, a in calls if kind == "fuse_views_cuda"]
            check(len(k3) == 1, f"{dt}: the fused MASK_USE_IMAGES room made {len(k3)} K3 calls, not 1")
            res["k3_err"] = max(res["k3_err"], _k3_case(f"{dt} resident volume, MASK_USE_IMAGES", k3[0], quiet=True,
                                                        phase=11)[0])
            errs = check_recorded_k1_k2(calls, f"{dt} MASK_USE_IMAGES room", phase=11)
            res["k1_err"] = max(res["k1_err"], errs["k1_err"])
            res["k2_err"] = max(res["k2_err"], errs["k2_err"], errs["class_aware_err"])
        si = sis["bfloat16"]
        never = SceneInference(si.det, si.cfg.replace(TPU_SCENE_COLOR_RESIDENT="never"))
        det, _ = si.infer(scenes[3], frames[3])
        with recording_kernel_calls() as calls:
            never.predict_masks(scenes[3], det, frames=dict(frames[3]))
        windows = [a for kind, a in calls if kind == "fuse_views_cuda" and tuple(a["volume_dims"]) in
                   (tuple(base.TPU_MASK_INFER_CANVAS), tuple(base.TPU_MASK_INFER_CANVAS_SMALL))]
        floors = sum(bool(a["zero_floor"]) for a in windows)
        for i, a in enumerate(windows):
            res["k3_err"] = max(res["k3_err"], _k3_case(f"per-window call {i}", a, quiet=True, phase=11)[0])
        log(f"[11] K3 on the per-window route of the {COLOR_VIEWS[3]}-view room's {len(det['pred_box'])} detections: "
            f"{len(windows)} window calls (grids {sorted({tuple(a['volume_dims']) for a in windows})}), all exact; "
            f"views per window max {max(a['feats2d'].shape[0] for a in windows)}; zero_floor on {floors} [{CARD}]")
        check(len(windows) > 0 and floors > 0, "the per-window route made no K3 call, or none with zero_floor")
        check(max(a["feats2d"].shape[0] for a in windows) <= base.TPU_MAX_TILE_VIEWS, "a window took more views")
        del never

    # (b) the path: phase 7's rooms in both dtypes through the fused route,
    # every count set to 0 just before and read just after; peak memory by room
    reset_launch_counts()
    before = device_launches()
    outs, peaks = {}, {}
    for dt, si in sis.items():
        outs[dt], peaks[dt] = [], []
        for sc, f in zip(scenes, frames):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            det, masks = si.infer(sc, f)
            torch.cuda.synchronize()
            peaks[dt].append(torch.cuda.max_memory_allocated() / 1e9)
            check(si.last_fused, f"{dt}: a MASK_USE_IMAGES room was not served by the fused path")
            check(np.isfinite(det["pred_box"]).all() and len(masks) == len(det["pred_box"]), f"{dt}: bad output")
            outs[dt].append((det, masks))
    torch.cuda.synchronize()
    launches = {"roi_pool3d_cuda": rp.roi_pool3d_cuda.launches, "nms3d_cuda": nms.nms3d_cuda.launches,
                "nms3d_cuda_class_aware": nms.nms3d_cuda.class_aware_launches,
                "fuse_views_cuda": projection.fuse_views_cuda.launches}
    kernel_launches = {k: v - before[k] for k, v in device_launches().items() if k in launches}
    log(f"[11] MASK_USE_IMAGES rooms: {2 * len(scenes)} scenes (views {list(COLOR_VIEWS)}, float32 and bfloat16), "
        f"all fused; wrapper calls {launches}, kernel launches {kernel_launches}; detections per room "
        + json.dumps({dt: [len(d["pred_box"]) for d, _ in o] for dt, o in outs.items()})
        + "; mask voxels per room " + json.dumps({dt: [int(sum(m.sum() for m in ms)) for _, ms in o]
                                                  for dt, o in outs.items()})
        + "; peak memory GB per room " + json.dumps({dt: [round(p, 3) for p in v] for dt, v in peaks.items()})
        + f" [{CARD}]")
    for k in launches:
        check(launches[k] > 0 and kernel_launches.get(k, launches[k]) == launches[k],
              f"{k} was not launched on the mask color path")
    check(launches["fuse_views_cuda"] == 2 * len(scenes), "K3 did not launch once per MASK_USE_IMAGES room")
    res["launches"], res["peak_gb"] = launches, peaks
    bf16_vs_fp32(outs, len(scenes), phase=11, iou_thresh=0.25, max_drift=0.3, slack_div=4)

    # (c) the routes where the view cap lets them agree (a room of 16 views:
    # no window meets more than TPU_MAX_TILE_VIEWS), float32: fused, the
    # host-planned path on the resident volume, each window's own fusion;
    # then the card against the CPU on that room
    scene, _, frame = make_color_scene(np.random.RandomState(31), CARD_VS_CPU_VIEWS, SCENE_SMALL, n_objects=10)
    si = sis["float32"]
    det, fused = si.infer(scene, frame)
    check(si.last_fused, "the 16-view room was not fused")
    never = SceneInference(si.det, si.cfg.replace(TPU_SCENE_COLOR_RESIDENT="never"))
    routes = {"fused": fused, "host-planned, resident": si.predict_masks(scene, det, frames=frame),
              "host-planned, per window": never.predict_masks(scene, det, frames=frame)}
    res["routes"] = mask_routes_agree(routes, det, f"the three routes on a {SCENE_SMALL} room of "
                                                   f"{CARD_VS_CPU_VIEWS} views, float32")
    del never
    cpu_si = SceneInference(load_jax_params(Detector(si.cfg, device="cpu"), params), si.cfg)
    t0 = time.time()
    cpu = cpu_si.infer(scene, frame)
    cpu_s = time.time() - t0
    check(cpu_si.last_fused, "the CPU's MASK_USE_IMAGES room was not fused")
    compare_card_cpu((det, fused), cpu, f"one {SCENE_SMALL} MASK_USE_IMAGES room with {CARD_VS_CPU_VIEWS} views",
                     cpu_s, phase=11)
    del cpu_si

    # (d) time: color masked scenes/min over a prefetched stream of 8, with and
    # without the branch (the same rooms and weights but the mask FCN's), bf16
    plain_cfg = scannet_color_scene_config()
    plain = SceneInference(load_jax_params(Detector(plain_cfg, device=dev), cparams), plain_cfg)
    res["timing"] = {}
    for name, sx in (("MASK_USE_IMAGES", sis["bfloat16"]), ("phase 7's config", plain)):
        peak = []
        for sc, f in zip(scenes, frames):  # each room alone, its prep included: its own rise over what was held
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            sx.infer(sc.copy(), dict(f))
            torch.cuda.synchronize()
            peak.append(round((torch.cuda.max_memory_allocated() - held) / 1e9, 3))
        stream = [(sc.copy(), dict(f)) for _ in range(2) for sc, f in zip(scenes, frames)]
        sx.infer(*stream[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sx.prefetch_scene(stream[0][0])
        sx.prefetch_frames(stream[0][1], stream[0][0].shape)
        for j, (sc, f) in enumerate(stream):
            if j + 1 < len(stream):
                sx.prefetch_scene(stream[j + 1][0])
                sx.prefetch_frames(stream[j + 1][1], stream[j + 1][0].shape)
            sx.infer(sc, f)
        wall = (time.perf_counter() - t0) / len(stream)
        dev_s = sx.device_seconds(scenes[1], frames[1], iters=6)
        stages, kv, n_windows = scene_stages(sx, scenes[1], sx._device_color(frames[1], scenes[1].shape[:3]))
        res["timing"][name] = {"scenes_per_min": 60.0 / wall, "device_s": dev_s, "stages": stages, "peak_gb": peak}
        log(f"[11] {name}, bfloat16: {60.0 / wall:.2f} color masked scenes/min (a prefetched stream of 8, views "
            f"{list(COLOR_VIEWS)} twice); peak memory GB per room alone, over what was held before it {peak}; "
            f"device_seconds of the "
            f"{COLOR_VIEWS[1]}-view room {dev_s:.4f} s; "
            f"{int(kv.sum())} detections, valid windows {n_windows}; per-stage ms "
            + json.dumps({k: round(v, 4) for k, v in stages.items()}) + f" [{CARD}]")
    del plain, sis
    torch.cuda.empty_cache()

    # (e) training with the branch and the ENet trained: card vs CPU (phase 9's
    # contract), 30 bf16 steps counted (K3 a sample, K3b once a step), the
    # step's one K3b call against its plain version
    cfg = enet_train_config()
    cfg.MASK_USE_IMAGES = True
    res["train_card_vs_cpu"] = train_card_vs_cpu(dev, "trainable-ENet MASK_USE_IMAGES", cfg, phase=11)
    cfg = enet_train_config()
    cfg.MASK_USE_IMAGES = True
    run, tdet, opt, step, batch, gen = train_run(dev, "trainable-ENet MASK_USE_IMAGES", cfg, TRAIN_BATCH["color"],
                                                 steps=MASK_COLOR_STEPS, phase=11)
    per_step = {k: run["launches"][k] / MASK_COLOR_STEPS for k in ("fuse_views_cuda", "fuse_views_backward_cuda")}
    check(per_step == {"fuse_views_cuda": TRAIN_BATCH["color"], "fuse_views_backward_cuda": 1}
          and run["kernel_launches"]["fuse_views_backward_cuda"] == MASK_COLOR_STEPS,
          f"a MASK_USE_IMAGES step launches K3 once a sample and K3b once: {per_step}")
    with recording_kernel_calls() as calls:
        step(opt, batch, generator=gen)
    torch.cuda.synchronize()
    k3b = [a for kind, a in calls if kind == "fuse_views_backward_cuda"]
    check(len(k3b) == 1, f"{len(k3b)} K3b calls in a MASK_USE_IMAGES step, not one")
    res["k3b_err"] = _k3b_case("the MASK_USE_IMAGES step's batched call (backbone and mask cotangents summed)", k3b[0],
                               phase=11)[0]
    res["k3b_ms"] = device_ms(lambda: projection.fuse_views_backward_cuda(**k3b[0]), 20)
    log(f"[11] K3b on the MASK_USE_IMAGES step's call: {res['k3b_ms']:.5f} ms device time (20 calls queued behind a "
        f"device sleep) [{CARD}]")
    res["train"] = dict(run, per_step=per_step)
    del tdet, opt, step, batch, calls, k3b
    torch.cuda.empty_cache()

    # (f) the color-only backbone: rooms served, then steps with the ENet trained
    only = scannet_color_scene_config().replace(ONLY_IMAGES=True)
    osi = SceneInference(load_jax_params(Detector(only, device=dev), matching_params(only)), only)
    check(osi.det.geometry1 is None, "ONLY_IMAGES built a geometry stream")
    reset_launch_counts()
    for sc, f in zip(scenes[:2], frames[:2]):
        det, masks = osi.infer(sc, f)
        check(np.isfinite(det["pred_box"]).all() and len(masks) == len(det["pred_box"]), "ONLY_IMAGES: bad output")
    olaunch = {"roi_pool3d_cuda": rp.roi_pool3d_cuda.launches, "nms3d_cuda": nms.nms3d_cuda.launches,
               "fuse_views_cuda": projection.fuse_views_cuda.launches}
    for k, v in olaunch.items():
        check(v > 0, f"{k} was not launched on the ONLY_IMAGES path")
    prep = osi._device_color(frames[1], scenes[1].shape[:3])
    ostages = scene_stages(osi, scenes[1], prep)[0]
    odev = osi.device_seconds(scenes[1], frames[1], iters=6)
    ref = res["timing"]["phase 7's config"]
    log(f"[11] ONLY_IMAGES rooms (bf16, views {list(COLOR_VIEWS[:2])}): launches {olaunch}; device_seconds of the "
        f"{COLOR_VIEWS[1]}-view room {odev:.4f} s (phase 7's config {ref['device_s']:.4f}); per-stage ms "
        + json.dumps({k: round(v, 4) for k, v in ostages.items()}) + f" (tiles in phase 7's config "
        f"{ref['stages']['tiles']:.4f}) [{CARD}]")
    res["only_images"] = {"launches": olaunch, "device_s": odev, "stages": ostages}
    del osi
    cfg = enet_train_config()
    cfg.ONLY_IMAGES = True
    tdet = train_detector(dev, cfg)
    from tpu3dsis_torch.train.trainstep import build_train_step

    opt_init, step = build_train_step(tdet, cfg, SHAPE)
    opt = opt_init()
    batch = train_batch(np.random.RandomState(7), TRAIN_BATCH["color"], cfg, True)
    gen = torch.Generator(device=dev).manual_seed(0)
    reset_launch_counts()
    metrics = [step(opt, batch, generator=gen) for _ in range(ONLY_IMAGES_STEPS)]
    torch.cuda.synchronize()
    tl = {"roi_pool3d_cuda": rp.roi_pool3d_cuda.launches, "roi_pool3d_backward_cuda": rp.roi_pool3d_backward_cuda.launches,
          "nms3d_cuda": nms.nms3d_cuda.launches, "fuse_views_cuda": projection.fuse_views_cuda.launches,
          "fuse_views_backward_cuda": projection.fuse_views_backward_cuda.launches}
    losses = [float(m["total_loss"]) for m in metrics]
    log(f"[11] ONLY_IMAGES training with the ENet trained, bf16, batch {TRAIN_BATCH['color']}: {ONLY_IMAGES_STEPS} "
        f"steps, total_loss {[round(x, 5) for x in losses]}, step_finite "
        f"{[float(m['step_finite']) for m in metrics]}; wrapper calls {tl} [{CARD}]")
    check(all(float(m["step_finite"]) == 1.0 for m in metrics), "an ONLY_IMAGES step was not finite")
    check(tl["fuse_views_backward_cuda"] == ONLY_IMAGES_STEPS and all(v > 0 for v in tl.values()),
          f"ONLY_IMAGES training launches {tl}")
    res["only_images"]["train_launches"] = tl
    del tdet, opt, step
    torch.cuda.empty_cache()

    # (g) the port's benchmark export of phase 8's test-mode artifacts: a mesh
    # and ground truth per scene made from its gt masks, export_scene,
    # evaluate, then the submission's nyu40 labels
    res["export"] = export_artifacts(drv["test_artifacts"])
    shutil.rmtree(os.path.dirname(drv["test_artifacts"]), ignore_errors=True)
    log(f"[11] phase 11 in {time.time() - t_phase:.1f} s")
    return res


def export_artifacts(art_dir):
    """``tpu3dsis_torch.eval.scannet_benchmark`` on a directory of test-mode
    artifacts: each scene's mesh is a vertex at every 2nd voxel along each
    axis of its gt masks (ground truth class * 1000 + instance) and at every
    4th of the rest (unlabelled), its world2grid the identity with the fixed
    padding;
    export_scene, evaluate, remap_benchmark_labels. Returns the averages."""
    from tpu3dsis_torch.eval import scannet_benchmark as sb
    from tpu3dsis_torch.tools.ply import write_ply

    out = tempfile.mkdtemp()
    bench, gt_dir = os.path.join(out, "bench"), os.path.join(out, "gt")
    os.makedirs(gt_dir)
    t0 = time.time()
    preds, gts, n_inst = [], [], 0
    for scene in sorted(os.listdir(art_dir)):
        extent = np.load(os.path.join(art_dir, scene, "scene.npy")).shape[:3]
        ids = np.zeros(extent, np.int64)
        with open(os.path.join(art_dir, scene, "gt_mask"), "rb") as f:
            gt_masks = pickle.load(f)
        gt_box, gt_class = np.load(os.path.join(art_dir, scene, "gt_box.npy")), np.load(
            os.path.join(art_dir, scene, "gt_class.npy"))
        for j, (box, cls, m) in enumerate(zip(gt_box, gt_class, gt_masks)):
            r = np.round(box[:6]).astype(int)
            sub = ids[r[0]:r[3], r[1]:r[4], r[2]:r[5]]
            m = np.asarray(m)[:sub.shape[0], :sub.shape[1], :sub.shape[2]] != 0
            sub[m & (sub == 0)] = int(cls) * 1000 + j + 1
        grid = np.indices(extent)
        keep = ((ids > 0) & (grid % 2 == 0).all(0)) | (grid % 4 == 0).all(0)
        verts = np.argwhere(keep).astype(np.float32)
        write_ply(os.path.join(out, f"{scene}.ply"), verts)
        w2g = np.eye(4)
        w2g[:3, 3] = (10, 16, 10)  # load_world2grid_padded takes the padding off
        np.savetxt(os.path.join(out, f"{scene}_w2g.txt"), w2g)
        np.savetxt(os.path.join(gt_dir, f"{scene}.txt"), ids[keep], fmt="%d")
        sb.export_scene(os.path.join(art_dir, scene), os.path.join(out, f"{scene}.ply"),
                        os.path.join(out, f"{scene}_w2g.txt"), bench, scene)
        preds.append(os.path.join(bench, f"{scene}.txt"))
        gts.append(os.path.join(gt_dir, f"{scene}.txt"))
        n_inst += len(open(preds[-1]).read().splitlines())
    avgs = sb.evaluate(preds, gts, output_file=os.path.join(out, "evaluation.txt"), verbose=False)
    sb.remap_benchmark_labels(bench)
    labels = {int(l.split()[1]) for p in preds for l in open(p)}
    log(f"[11] benchmark export of phase 8's {len(preds)} test-mode scenes (tpu3dsis_torch.eval.scannet_benchmark): "
        f"{n_inst} instances exported; official AP {avgs['all_ap']:.4f}, AP50 {avgs['all_ap_50%']:.4f}, AP25 "
        f"{avgs['all_ap_25%']:.4f}; nyu40 labels after remap {sorted(labels)}; {time.time() - t0:.1f} s")
    check(n_inst > 0 and all(np.isfinite(avgs[k]) for k in ("all_ap", "all_ap_50%", "all_ap_25%")),
          f"the export gave {n_inst} instances, AP {avgs['all_ap']}")
    check(labels <= set(sb.CONSECUTIVE_TO_NYU40.values()), f"remapped labels {labels}")
    shutil.rmtree(out, ignore_errors=True)
    return {k: avgs[k] for k in ("all_ap", "all_ap_50%", "all_ap_25%")} | {"instances": n_inst}


# --- phase 12: several devices: data-parallel training, tile-parallel scenes, the sharded single-shot scene -----

DP_STEPS = 3  # float32 steps held against the single process
DP_BF16_STEPS = 10
DP_TOL = 1e-4  # phase 9's contract: losses relative, parameters of their magnitude
SPATIAL_TOL = 1e-5  # of the largest feature: cuDNN may take other algorithms on the shards' shapes


def _counts():
    return {"roi_pool3d_cuda": rp.roi_pool3d_cuda.launches, "roi_pool3d_backward_cuda": rp.roi_pool3d_backward_cuda.launches,
            "nms3d_cuda": nms.nms3d_cuda.launches, "nms3d_cuda_class_aware": nms.nms3d_cuda.class_aware_launches,
            "fuse_views_cuda": projection.fuse_views_cuda.launches,
            "fuse_views_backward_cuda": projection.fuse_views_backward_cuda.launches}


def _dp_steps(step, opt, batch, steps, seed0):
    """`steps` steps on one batch, the generator seeded seed0 + s before step
    s; (metrics, CUDA-event ms of each step)."""
    gen = torch.Generator(device=opt.step.device)
    metrics, events = [], []
    for s in range(steps):
        gen.manual_seed(seed0 + s)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(step(opt, batch, generator=gen))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [{k: float(v) for k, v in m.items()} for m in metrics], [s.elapsed_time(e) for s, e in events]


def _dp_worker(rank, world, port, out_dir):
    """One rank of the data-parallel run on cuda:0 over gloo (NCCL takes one
    rank a device): DP_STEPS float32 steps on its share of the batch, its
    parameters and launch counts written to out_dir; then DP_BF16_STEPS bf16
    steps."""
    import torch.distributed as dist

    from tpu3dsis_torch.checkpoint import module_params
    from tpu3dsis_torch.config import scannet_train_config
    from tpu3dsis_torch.parallel import distributed as pdist
    from tpu3dsis_torch.train.trainstep import build_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    out = {}
    for dt, steps in (("float32", DP_STEPS), ("bfloat16", DP_BF16_STEPS)):
        cfg = scannet_train_config()
        cfg.TPU_COMPUTE_DTYPE = dt
        det = train_detector(dev, cfg, seed=rank)  # rank 1's weights differ until replicate
        opt_init, step = build_train_step(det, cfg, SHAPE, group=dist.group.WORLD)
        opt = opt_init()
        pdist.replicate(det, opt)
        batch = pdist.shard_batch(train_batch(np.random.RandomState(7), TRAIN_BATCH["geometry"], cfg), rank, world)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        reset_launch_counts()
        before = device_launches()
        metrics, ms = _dp_steps(step, opt, batch, steps, 100)
        out[dt] = {"metrics": metrics, "ms": ms, "launches": _counts(),
                   "kernel_launches": {k: v - before[k] for k, v in device_launches().items()},
                   "trained": sorted(opt.trainable())}
        if dt == "float32":
            out[dt]["params"] = module_params(det)
        del det, opt, step
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def dp_train(dev):
    """Two ranks on cuda:0 over gloo against one process at batch 8 with the
    same draws; then the entry module under torchrun (NCCL)."""
    import multiprocessing

    from tpu3dsis_torch.checkpoint import module_params
    from tpu3dsis_torch.config import scannet_train_config
    from tpu3dsis_torch.train.trainstep import build_train_step

    n = TRAIN_BATCH["geometry"]
    ref = {}
    for dt, steps in (("float32", DP_STEPS), ("bfloat16", DP_BF16_STEPS)):
        cfg = scannet_train_config()
        cfg.TPU_COMPUTE_DTYPE = dt
        det = train_detector(dev, cfg, seed=0)
        opt_init, step = build_train_step(det, cfg, SHAPE)
        opt = opt_init()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in train_batch(np.random.RandomState(7), n, cfg).items()}
        metrics, ms = _dp_steps(step, opt, batch, steps, 100)
        ref[dt] = {"metrics": metrics, "ms": ms, "params": module_params(det) if dt == "float32" else None}
        del det, opt, step
    torch.cuda.empty_cache()

    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        t0 = time.time()
        procs = [ctx.Process(target=_dp_worker, args=(r, world, port, tmp)) for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        wall = time.time() - t0
        check(all(p.exitcode == 0 for p in procs), f"a data-parallel rank failed: exit codes {[p.exitcode for p in procs]}")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))

    res = {"launches": ranks[0]["float32"]["launches"], "wall_s": wall}
    want_m, want_p = ref["float32"]["metrics"], ref["float32"]["params"]
    worst_loss, worst_param = 0.0, 0.0
    for r, got in enumerate(ranks):
        g32 = got["float32"]
        for w, g in zip(want_m, g32["metrics"]):
            check(set(g) == set(w) and g["step_finite"] == 1.0, f"rank {r}: metrics {sorted(g)}")
            for k, v in w.items():
                worst_loss = max(worst_loss, abs(g[k] - v) / max(abs(v), 1e-6))
        for k, w in want_p.items():
            worst_param = max(worst_param, float(np.abs(g32["params"][k] - w).max() / max(np.abs(w).max(), 1e-30)))
        for dt in ("float32", "bfloat16"):
            for k in ("roi_pool3d_cuda", "roi_pool3d_backward_cuda", "nms3d_cuda"):
                check(got[dt]["launches"][k] > 0 and got[dt]["kernel_launches"][k] > 0,
                      f"rank {r} {dt}: {k} was not launched")
    same = all(np.array_equal(ranks[0]["float32"]["params"][k], ranks[1]["float32"]["params"][k]) for k in want_p)
    log(f"[12] data parallel, 2 ranks on one card over gloo, scannet_train_config() float32 (TF32 off), 4 chunks a "
        f"rank, {DP_STEPS} steps, against one process at batch {n} with the same draws: largest relative loss "
        f"difference {worst_loss:.3g}, parameters {worst_param:.3g} of their magnitude (contract {DP_TOL}); the "
        f"ranks' parameters equal: {same}; launches a rank (float32) {ranks[0]['float32']['launches']}, "
        f"(bf16) {ranks[0]['bfloat16']['launches']}; {wall:.1f} s with the ranks' start-up [{CARD}]")
    check(worst_loss <= DP_TOL, f"data-parallel losses differ from one process's by {worst_loss:.3g}")
    check(worst_param <= DP_TOL, f"data-parallel parameters differ from one process's by {worst_param:.3g}")
    check(same, "the two ranks' parameters differ")

    losses = [m["total_loss"] for m in ranks[0]["bfloat16"]["metrics"]]
    check(all(m["step_finite"] == 1.0 for rk in ranks for m in rk["bfloat16"]["metrics"]), "a bf16 DP step was not finite")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]), f"bf16 DP total_loss did not fall: {losses}")
    s_dp = statistics.median(ranks[0]["bfloat16"]["ms"][2:]) / 1e3
    s_one = statistics.median(ref["bfloat16"]["ms"][2:]) / 1e3
    res.update(s_per_iter_gloo=s_dp, s_per_iter_one=s_one, loss_rel=worst_loss, param_rel=worst_param,
               launches_bf16=ranks[0]["bfloat16"]["launches"])
    log(f"[12] bf16, {DP_BF16_STEPS} steps: total_loss {losses[0]:.5f} -> {losses[-1]:.5f}, all finite; "
        f"{s_dp:.4f} s/iter for 2 ranks x 4 chunks on one card over gloo (rank 0's CUDA-event median of steps "
        f"3-{DP_BF16_STEPS}) beside {s_one:.4f} s/iter for one process at batch {n} (phase 9's step) [{CARD}]")
    res["nccl"] = dp_entry_nccl()
    return res


def free_port() -> int:
    """A free localhost port (its socket closed before the port is used)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_entry_nccl():
    """``python -m tpu3dsis_torch.main --mode train`` under ``torchrun
    --nproc_per_node 1`` with TPU_DATA_PARALLEL 1: the NCCL group is made,
    the step all-reduces on the card, rank 0 writes the snapshot."""
    with tempfile.TemporaryDirectory() as tmp:
        filelist = write_train_chunks(tmp)
        cfg = write_overlay(os.path.join(tmp, "dp_overlay"), USE_IMAGES=False, TRAIN_FILELIST=filelist,
                            VAL_FILELIST="", TRAINVAL_FILELIST="", VAL_TIME=0.0, DISPLAY=1, SNAPSHOT_KEPT=0,
                            TPU_COMPUTE_DTYPE="bfloat16", TPU_MASK_CANVAS=[64, 48, 64], TPU_DATA_PARALLEL=1)
        out_root = os.path.join(tmp, "out")
        lines = []
        launches, _, wall = run_entry(["--cfg", cfg, "--output_dir", out_root, "--mode", "train", "--max_steps", "3"],
                                      stdout=lines, torchrun=True)
        ckpt_dir = os.path.join(out_root, cfg, "checkpoints")
        steps = [l for l in lines if l.startswith("epoch ")]
        joined = [l for l in lines if l.startswith("data parallel:")]
        times = [float(l.split()[-1][:-len("s/iter")]) for l in steps]
        log(f"[12] torchrun --nproc_per_node 1 -m tpu3dsis_torch.main --mode train --max_steps 3 "
            f"(TPU_DATA_PARALLEL 1): {wall:.1f} s with start-up; {joined}; {steps}; launches {launches}; snapshots "
            f"{sorted(os.listdir(ckpt_dir))} [{CARD}]")
        check(joined and joined[0].endswith("backend nccl"), f"the entry module did not join an NCCL group: {joined}")
        check(len(steps) == 3 and os.path.isfile(os.path.join(ckpt_dir, "step_3.npz")),
              "the NCCL run did not take 3 steps and write step_3.npz")
        for k in ("roi_pool3d_cuda", "roi_pool3d_backward_cuda", "nms3d_cuda"):
            check(launches[k] > 0, f"the NCCL run did not launch {k}")
    return {"launches": launches, "wall_s": wall, "s_per_iter_steps_2_3": times[1:]}


def no_rpn_train(dev):
    """``USE_RPN: False`` (bf16, batch 8, the gt boxes as proposals): 3
    steps, finite; no RPN parameter; K1 and K1b launch (K2 does not: no
    proposal is selected)."""
    from tpu3dsis_torch.config import scannet_train_config
    from tpu3dsis_torch.train.trainstep import build_train_step

    cfg = scannet_train_config()
    cfg.USE_RPN = False
    det = train_detector(dev, cfg)
    opt_init, step = build_train_step(det, cfg, SHAPE)
    opt = opt_init()
    check(not any("rpn" in k for k in opt.params), "a USE_RPN=False detector has RPN parameters")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in train_batch(np.random.RandomState(7), 8, cfg).items()}
    reset_launch_counts()
    metrics, ms = _dp_steps(step, opt, batch, 3, 100)
    launches = _counts()
    log(f"[12] USE_RPN=False, bf16, batch 8, 3 steps: total_loss {[round(m['total_loss'], 5) for m in metrics]}, "
        f"metrics {sorted(metrics[0])}; {len(opt.params)} parameters, none of the RPN; launches {launches}; ms a step "
        f"{[round(t, 2) for t in ms]} [{CARD}]")
    check(all(m["step_finite"] == 1.0 for m in metrics), "a USE_RPN=False step was not finite")
    check(not any(k.startswith("rpn_") for k in metrics[0]), "a USE_RPN=False step took an RPN loss")
    for k in ("roi_pool3d_cuda", "roi_pool3d_backward_cuda"):
        check(launches[k] > 0, f"USE_RPN=False training did not launch {k}")
    return {"launches": launches}


def _scene_equal(a, b) -> bool:
    """Two ``infer`` results (detections, masks) equal to the bit."""
    (det_a, masks_a), (det_b, masks_b) = a, b
    return (all(det_a[k].dtype == det_b[k].dtype and np.array_equal(det_a[k], det_b[k])
                for k in ("pred_box", "pred_class", "pred_conf"))
            and len(masks_a) == len(masks_b) and all(np.array_equal(x, y) for x, y in zip(masks_a, masks_b)))


def _same_scene(a, b, label):
    check(_scene_equal(a, b), f"{label}: the detections or masks differ")


def _scenes_per_min(si, scenes, frames=None):
    """Scenes/min over a prefetched stream of the scenes twice (distinct arrays)."""
    stream = [s.copy() for _ in range(2) for s in scenes]
    t0 = time.perf_counter()
    si.prefetch_scene(stream[0])
    for j, s in enumerate(stream):
        if j + 1 < len(stream):
            si.prefetch_scene(stream[j + 1])
        si.infer(s, frames)
    torch.cuda.synchronize()
    return 60.0 * len(stream) / (time.perf_counter() - t0)


def tile_parallel(dev, n_scenes=4):
    """``SceneInference(mesh=[cuda:0, cuda:0])`` at phase 6's tile batch of
    32 on its scenes in both dtypes: each batch of tiles and each mask
    window queue split in two. torch.equal to one device at tile batches of
    16 (the same tile calls); against one device at 32 (phase 6's outputs)
    the equality is printed, and every detection matches one at IoU 0.5
    with the same class (cuDNN picks its algorithms by the batch). Phase 7's first
    room at 8 over the list against one device at 4 likewise. Launches
    counted over the device-list runs; scenes/min beside one device's at
    32."""
    params = scene_params()
    scenes = [make_scene(np.random.RandomState(7 + i))[0] for i in range(n_scenes)]
    res = {"err": 0.0, "equal_to_tile_batch_32": {}}
    launches = defaultdict(int)
    rates = {}
    for dt in ("float32", "bfloat16"):
        cfg = scannet_scene_config().replace(TPU_COMPUTE_DTYPE=dt)
        det = load_jax_params(Detector(cfg, device=dev), params)
        one = SceneInference(det, cfg)
        half = SceneInference(det, cfg, tile_batch=16)
        two = SceneInference(det, cfg, mesh=[dev, dev])
        want = [one.infer(s) for s in scenes]
        want_half = [half.infer(s) for s in scenes]
        if dt == "float32":
            calls = recorded_kernel_calls(two, scenes[0])
            errs = check_recorded_k1_k2(calls, "float32 device-list scene", phase=12)
            res["err"] = max(res["err"], *errs.values())
        reset_launch_counts()
        got = [two.infer(s) for s in scenes]
        torch.cuda.synchronize()
        for k, v in _counts().items():
            launches[k] += v
        check(two.last_fused, "a device-list scene was not served by the fused path")
        for i, (a, b) in enumerate(zip(got, want_half)):
            _same_scene(a, b, f"{dt} scene {i} against one device at tile_batch 16")
        same32 = [_scene_equal(a, b) for a, b in zip(got, want)]
        pairs = [match_detections(b[0], a[0], 0.5) for a, b in zip(got, want)]
        matched = [f"{len(p)}/{len(b[0]['pred_box'])}" for p, b in zip(pairs, want)]
        for i, (p, (a, b)) in enumerate(zip(pairs, zip(got, want))):
            check(len(p) == len(a[0]["pred_box"]) == len(b[0]["pred_box"])
                  and all(b[0]["pred_class"][r] == a[0]["pred_class"][j] for r, j in p),
                  f"{dt} scene {i}: the detections do not match one device's at tile_batch 32 (IoU 0.5, same class)")
        res["equal_to_tile_batch_32"][dt] = same32
        rates[dt] = {"one": _scenes_per_min(one, scenes), "two": _scenes_per_min(two, scenes)}
        for si in (one, half, two):
            si.close()
        log(f"[12] {dt}: {n_scenes} scenes of {SCENE_EXTENT} through SceneInference(mesh=[{dev}, {dev}]) at "
            f"tile_batch 32 (each batch and mask queue split in two) equal one device's at tile_batch 16 (boxes, "
            f"classes, scores, masks); against one device at 32 (phase 6's batch) equal {same32}, detections "
            f"matched at IoU 0.5 {matched}; masked scenes/min {rates[dt]['two']:.2f} against {rates[dt]['one']:.2f} "
            f"on one device at 32, a prefetched stream of 8 [{CARD}]")
    # one of phase 7's rooms, bf16, with the ENet, K3 and the resident color volume
    cparams = color_params()
    ccfg = scannet_color_scene_config()
    cdet = load_jax_params(Detector(ccfg, device=dev), cparams)
    room, _, frames = make_color_scene(np.random.RandomState(20), COLOR_VIEWS[0])
    want = SceneInference(cdet, ccfg, tile_batch=4).infer(room, frames)
    two = SceneInference(cdet, ccfg, tile_batch=8, mesh=[dev, dev])
    reset_launch_counts()
    got = two.infer(room, frames)
    torch.cuda.synchronize()
    for k, v in _counts().items():
        launches[k] += v
    check(two.last_fused, "the device-list room was not served by the fused path")
    _same_scene(got, want, "color room")
    log(f"[12] a {COLOR_VIEWS[0]}-view room of phase 7 (bf16, tile_batch 8 split over [{dev}, {dev}]) equals one "
        f"device's at tile_batch 4; launches over the device-list runs {dict(launches)} [{CARD}]")
    for k in ("roi_pool3d_cuda", "nms3d_cuda", "nms3d_cuda_class_aware", "fuse_views_cuda"):
        check(launches[k] > 0, f"the device-list scenes did not launch {k}")
    res.update(launches=dict(launches), rates=rates)
    return res


def spatial_scene(dev):
    """One 240x48x240 scene through ``spatial_single_shot`` on 2 and 4
    shards of cuda:0 against the port's single-shot on the whole scene,
    float32 with TF32 off: features within SPATIAL_TOL of their largest
    value, detections IoU-matched at 0.5 with the same class."""
    from tpu3dsis_torch.infer.single_shot import SingleShotInference
    from tpu3dsis_torch.parallel import spatial_features
    from tpu3dsis_torch.parallel.scene import spatial_single_shot

    cfg = scannet_scene_config()
    det = load_jax_params(Detector(cfg, device=dev), scene_params())
    scene = make_scene(np.random.RandomState(7))[0]
    shot = SingleShotInference(det, cfg)
    want = shot.detect(scene)
    with torch.inference_mode():
        whole = det.features(torch.from_numpy(scene)[None])
    res = {"err": 0.0, "feature_rel": 0.0}
    launches = defaultdict(int)
    for n in (2, 4):
        devs = [dev] * n
        feats = spatial_features(det, torch.from_numpy(scene), devs)
        rel = max(float((feats[l] - whole[l]).abs().max() / whole[l].abs().max()) for l in (1, 2))
        res["feature_rel"] = max(res["feature_rel"], rel)
        if n == 2:
            with recording_kernel_calls() as calls:
                spatial_single_shot(det, cfg, scene, devs)
            errs = check_recorded_k1_k2(calls, "sharded single-shot scene", phase=12)
            res["err"] = max(res["err"], *errs.values())
        reset_launch_counts()
        got = spatial_single_shot(det, cfg, scene, devs)
        torch.cuda.synchronize()
        for k, v in _counts().items():
            launches[k] += v
        res[f"ms_{n}_shards"] = host_ms(lambda: spatial_single_shot(det, cfg, scene, devs), iters=3, warmup=0)
        pairs = match_detections(want, got, 0.5)
        same_cls = all(want["pred_class"][i] == got["pred_class"][j] for i, j in pairs)
        log(f"[12] spatial_single_shot on {n} shards of {dev}, {SCENE_EXTENT} float32 (TF32 off): features within "
            f"{rel:.3g} of their largest value (bar {SPATIAL_TOL}); {len(got['pred_box'])} detections against "
            f"{len(want['pred_box'])} of the single-shot scene, {len(pairs)} matched at IoU 0.5, same class: "
            f"{same_cls} [{CARD}]")
        check(rel <= SPATIAL_TOL, f"{n} shards: features differ by {rel:.3g} of their largest value")
        check(len(pairs) == len(want["pred_box"]) == len(got["pred_box"]) > 0 and same_cls,
              f"{n} shards: detections do not match the single-shot scene's")
    res["ms_whole"] = host_ms(lambda: shot.detect(scene), iters=3)
    log(f"[12] sharded single-shot launches (2 and 4 shards) {dict(launches)}; ms a scene (host clock, the "
        f"detections on the host) {res['ms_2_shards']:.1f} on 2 shards, {res['ms_4_shards']:.1f} on 4, "
        f"{res['ms_whole']:.1f} unsharded [{CARD}]")
    for k in ("roi_pool3d_cuda", "nms3d_cuda"):
        check(launches[k] > 0, f"the sharded single-shot scene did not launch {k}")
    res["launches"] = dict(launches)
    return res


def phase_parallel(dev):
    """Phase 12: data-parallel training, ``USE_RPN: False`` training, the
    device-list scenes and the sharded single-shot scene, on the one card."""
    t_phase = time.time()
    res = {"dp": dp_train(dev), "no_rpn": no_rpn_train(dev), "tiles": tile_parallel(dev),
           "spatial": spatial_scene(dev)}
    log(f"[12] phase 12 in {time.time() - t_phase:.1f} s")
    return res


# --- phase 13: the closed color loop from files on disk, the demo, the native loader, the small models ---------

LOOP_TRAIN_SCENES, LOOP_EVAL_SCENES = 2, 1
LOOP_SEED = 13
LOOP_STEPS = 20
LOOP_TINY = {"extent_m": (4.0, 2.2, 4.0), "n_objects": 5, "voxel_size": 0.1, "image_wh": (64, 48),
             "max_views": 20, "traj_wh": (48, 36), "sample_factor": 24, "chunk_dim": (32, 32, 32)}
LOADER_PASSES = 3  # epochs of the generated chunks per loader timing, in turns
MODEL_TOL = {"coord_conv3d": 1e-5, "autoencoder": 1e-4}  # of each output's (parameter's) magnitude
# the oracle leg's bar, tests/test_color_loop.py's: at these settings the gt's masks (the fused
# instance grid) and the mesh's gt ids (the fused label grid, whose voting a floor or a neighbour
# overwrites) disagree on some low or small objects, so the JAX package's own export of its own
# datagen scores below 1 on the same files (PERF.md, PR 13)
ORACLE_AP50 = 0.5


def _hashes(root):
    """sha256 of every file under root, by relative path."""
    import hashlib

    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _repeat_hashes(tmp):
    """A small scene generated twice from one seed: each run's files' sha256."""
    from tpu3dsis_torch.datagen.synthetic_color import generate_scene

    trees = []
    for run in ("a", "b"):
        generate_scene(np.random.RandomState(LOOP_SEED), os.path.join(tmp, f"repeat_{run}"), "rep0", **LOOP_TINY)
        trees.append(_hashes(os.path.join(tmp, f"repeat_{run}")))
    return trees


def loop_datagen(tmp):
    """(a) the loop's scenes at color_loop_check.py's settings (2 train with
    chunks, 1 eval), and one small scene twice from one seed, hashed; (e)
    the demo runs on the card meanwhile, its own process, as the repeat
    runs in a thread here: the datagen's processes hold the host for a
    minute."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu3dsis_torch.tools import color_loop as cl

    with ThreadPoolExecutor(2) as pool:
        demo, repeat = pool.submit(loop_demo, tmp), pool.submit(_repeat_hashes, tmp)
        t0 = time.time()
        chunk_paths, records, stats = cl.generate_data(os.path.join(tmp, "loop"), n_train=LOOP_TRAIN_SCENES,
                                                       n_eval=LOOP_EVAL_SCENES, seed=LOOP_SEED)
        total = time.time() - t0
        trees, demo_res = repeat.result(), demo.result()
    for s in stats:
        log(f"[13] datagen {s['name']} (host numpy, {cl.W}x{cl.H} frames, {cl.SCENE['voxel_size']} m voxels; the scenes "
            f"made at once, a process each, beside the demo): {s['seconds']:.2f} s, {s['views']} views, "
            f"{s['chunks']} chunks, {s['bytes']:,} bytes on disk [{CARD}]")
    check(len(chunk_paths) > 0 and len(records) == LOOP_EVAL_SCENES, "the datagen wrote no training chunks")
    check(trees[0] == trees[1] and len(trees[0]) > 10,
          f"one seed gave other files: {sorted(k for k in trees[0] if trees[0][k] != trees[1].get(k))}")
    log(f"[13] datagen repeatable: a small scene generated twice from seed {LOOP_SEED}, {len(trees[0])} files, "
        f"every sha256 equal; the loop's {len(stats)} scenes in {total:.1f} s of wall time")
    return chunk_paths, records, {"scenes": stats, "seconds": total, "repeat_files": len(trees[0])}, demo_res


def loop_config(tmp, chunk_paths, records):
    """color_loop.build_cfg with the generated files, as an overlay the
    entry module reads: the train list, the eval scene, DISPLAY 1."""
    from tpu3dsis_torch.config import cfg_to_file, default_config
    from tpu3dsis_torch.tools import color_loop as cl

    cfg = cl.build_cfg(os.path.join(tmp, "loop", "frames_square"), steps=LOOP_STEPS)
    train_list, scene_list = os.path.join(tmp, "train.txt"), os.path.join(tmp, "scenes.txt")
    with open(train_list, "w") as f:
        f.write("".join(p + "\n" for p in chunk_paths))
    with open(scene_list, "w") as f:
        f.write("".join(r["scene_path"] + "\n" for r in records))
    cfg.update(TRAIN_FILELIST=train_list, VAL_FILELIST="", TRAINVAL_FILELIST="", DISPLAY=1, TEST_FILELIST=scene_list,
               TEST_SAVE_DIR=os.path.join(tmp, "res"))
    path = os.path.join(tmp, "color_loop")
    # what differs from the defaults, but the two keys finalize_config derives from the label map
    default = default_config()
    cfg_to_file({k: v for k, v in cfg.items() if v != default.get(k) and k not in ("NUM_CLASSES", "NORMALIZE_WEIGHTS")},
                path + ".yml")
    return cfg, path


def loop_train_step_calls(dev, cfg, snapshot):
    """(b) in process: one step of the loop's training on a batch the loader
    read from disk (frames included), from the entry run's snapshot; every
    kernel call recorded and held against its plain version."""
    from tpu3dsis_torch import checkpoint as ckpt
    from tpu3dsis_torch.config import DetectorConfig
    from tpu3dsis_torch.io import SceneDataset
    from tpu3dsis_torch.io.pipeline import PrefetchLoader
    from tpu3dsis_torch.train.trainstep import build_train_step

    det = Detector(DetectorConfig.from_cfg(cfg), device=dev, param_dtype=torch.float32)
    load_jax_params(det, ckpt.load_snapshot(snapshot)[0])
    opt_init, step = build_train_step(det, cfg, tuple(int(s) for s in cfg.TPU_TILE_SIZE))
    opt = opt_init()
    loader = PrefetchLoader(SceneDataset(cfg.TRAIN_FILELIST, "chunk", cfg), cfg, 1, shuffle=False,
                            pin_memory=dev.type == "cuda")
    batch = next(iter(loader))
    check("images" in batch and batch["view_valid"].any(), "the loader's batch holds no frames")
    gen = torch.Generator(device=dev).manual_seed(0)
    reset_launch_counts()
    with recording_kernel_calls() as calls:
        metrics = step(opt, batch, generator=gen)
    torch.cuda.synchronize()
    launches = _counts()
    check(np.isfinite(float(metrics["total_loss"])), "the disk-fed step's loss is not finite")
    res = check_recorded_k1_k2(calls, "color loop's disk-fed training step", phase=13)
    res.update(k3_err=0.0, k3b_err=0.0, k1b_err=0.0)
    for kind, args in calls:
        if kind == "fuse_views_cuda":
            res["k3_err"] = max(res["k3_err"], _k3_case("color loop's disk-fed step", args, phase=13)[0])
        elif kind == "fuse_views_backward_cuda":
            res["k3b_err"] = max(res["k3b_err"], _k3b_case("color loop's disk-fed step", args, phase=13)[0])
        elif kind == "roi_pool3d_backward_cuda":
            args = dict(args)
            feats, g = args.pop("feats"), args.pop("grad_out")
            res["k1b_err"] = max(res["k1b_err"], _k1b_case("color loop's disk-fed step", feats, args, g, phase=13)[0])
    kinds = [k for k, _ in calls]
    log(f"[13] the disk-fed step's kernel calls {kinds}; launches {launches}; total_loss "
        f"{float(metrics['total_loss']):.4f} [{CARD}]")
    for k in ("roi_pool3d_cuda", "roi_pool3d_backward_cuda", "nms3d_cuda", "fuse_views_cuda",
              "fuse_views_backward_cuda"):
        check(k in kinds and launches[k] > 0, f"the disk-fed step did not launch {k}")
    res["launches"] = launches
    del det, opt, step, batch
    torch.cuda.empty_cache()
    return res


def loop_test_calls(dev, cfg, snapshot):
    """(c) in process: ``run_scenes`` in test mode on the eval scene with its
    frames read from disk, from the snapshot; every kernel call recorded and
    held against its plain version."""
    from tpu3dsis_torch import checkpoint as ckpt
    from tpu3dsis_torch.config import DetectorConfig
    from tpu3dsis_torch.infer.driver import run_scenes
    from tpu3dsis_torch.io import SceneDataset

    cfg_t = cfg.copy()
    cfg_t.MODE = "test"
    cfg_t.TEST_SAVE_DIR = cfg.TEST_SAVE_DIR + "_in_process"
    det = Detector(DetectorConfig.from_cfg(cfg_t), device=dev)
    load_jax_params(det, ckpt.load_snapshot(snapshot)[0])
    ds = SceneDataset(cfg_t.TEST_FILELIST, "scene", cfg_t)
    reset_launch_counts()
    t0 = time.time()
    with recording_kernel_calls() as calls:
        maps = run_scenes(cfg_t, det, "test", dataset=ds)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts()
    res = check_recorded_k1_k2(calls, "color loop's test mode, frames from disk", phase=13)
    res["k3_err"] = 0.0
    for kind, args in calls:
        if kind == "fuse_views_cuda":
            res["k3_err"] = max(res["k3_err"], _k3_case("color loop's test mode, frames from disk", args,
                                                         phase=13)[0])
    kinds = [k for k, _ in calls]
    for k in ("roi_pool3d_cuda", "nms3d_cuda", "class-aware", "fuse_views_cuda"):
        check(k in kinds, f"test mode from disk made no {k} call")
    log(f"[13] run_scenes in process on the eval scene (frames from disk): {wall:.1f} s, calls {kinds}, launches "
        f"{launches}, {maps} [{CARD}]")
    res.update(launches=launches, map=maps)
    del det
    torch.cuda.empty_cache()
    return res


def loop_export(tmp, cfg, records):
    """(d) marching tets, the ScanNet export and ``evaluate`` on the entry
    run's predictions (AP finite) and on the gt pushed through as
    predictions (AP@0.5 above ``ORACLE_AP50``)."""
    from tpu3dsis_torch.eval import scannet_benchmark as sb
    from tpu3dsis_torch.io import SceneDataset
    from tpu3dsis_torch.tools import color_loop as cl

    t0 = time.time()
    cfg_t = cfg.copy()
    cfg_t.MODE = "test"
    ds = SceneDataset(cfg_t.TEST_FILELIST, "scene", cfg_t)
    aps = {}
    for tag in ("trained", "oracle"):
        preds, gts = [], []
        for i, rec in enumerate(records):
            scene_id = os.path.basename(rec["scene_path"])[:12]
            pred_dir = os.path.join(cfg.TEST_SAVE_DIR, scene_id)
            if tag == "oracle":
                pred_dir = os.path.join(tmp, "res_oracle", scene_id)
                cl.write_oracle_predictions(ds[i], pred_dir)
            pf, gf = cl.benchmark_eval(rec, pred_dir, tmp, tag=tag)
            preds.append(pf)
            gts.append(gf)
        avgs = sb.evaluate(preds, gts, verbose=False)
        aps[tag] = {"ap": float(avgs["all_ap"]), "ap50": float(avgs["all_ap_50%"]), "ap25": float(avgs["all_ap_25%"])}
    wall = time.time() - t0
    log(f"[13] the export (marching tets, export_scene, remap, evaluate) of {len(records)} eval scene(s): trained "
        f"{aps['trained']}, oracle {aps['oracle']}, {wall:.1f} s [{CARD}]")
    check(all(np.isfinite(v) for v in aps["trained"].values()), f"the trained export's AP is not finite: {aps}")
    check(aps["oracle"]["ap50"] > ORACLE_AP50, f"the oracle export scored AP@0.5 {aps['oracle']['ap50']}")
    return {"ap": aps, "seconds": wall}


def loop_demo(tmp):
    """(e) ``python -m tpu3dsis_torch.tools.demo`` on the card: exit 0, its PLYs
    (run beside the datagen, so its seconds include the host's contention)."""
    out = os.path.join(tmp, "demo")
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", "tpu3dsis_torch.tools.demo", "--out", out], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    wall = time.time() - t0
    if res.returncode != 0:
        log(res.stderr[-4000:])
    check(res.returncode == 0, f"python -m tpu3dsis_torch.tools.demo exited {res.returncode}")
    plys = sorted(os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out) for f in fs
                  if f.endswith(".ply"))
    want = ["demo_fused.ply", os.path.join("vis", "pred_bbox.ply"), os.path.join("vis", "pred_mask.ply"),
            os.path.join("vis", "scene.ply")]
    check(all(p in plys and os.path.getsize(os.path.join(out, p)) > 0 for p in want), f"the demo's PLYs: {plys}")
    metrics = [l for l in res.stdout.splitlines() if l.startswith("[demo] metrics")]
    log(f"[13] python -m tpu3dsis_torch.tools.demo: {wall:.1f} s with start-up (beside the datagen), PLYs {plys}, "
        f"{metrics} [{CARD}]")
    return {"seconds": wall, "plys": plys}


def loop_loader(cfg, chunk_paths, train_rate):
    """(f) ``PrefetchLoader`` on the generated chunks with a geometry
    overlay: the numpy path and the native decoder give equal batches; each
    one's chunks/s (files warm in the page cache), in turns."""
    from tpu3dsis_torch.io import SceneDataset
    from tpu3dsis_torch.io.dataset import load_fast_padded
    from tpu3dsis_torch.io.pipeline import PrefetchLoader

    geo = cfg.copy()
    geo.USE_IMAGES = False
    ds = SceneDataset(geo.TRAIN_FILELIST, "chunk", geo)
    native_served = sum(load_fast_padded(ds, p, geo) is not None for p in chunk_paths)
    batches = {}
    for native in (False, True):
        batches[native] = list(PrefetchLoader(ds, geo, 1, shuffle=False, native=native))
    check(len(batches[True]) == len(batches[False]) > 0, "the two loaders gave other batch counts")
    for a, b in zip(batches[True], batches[False]):
        check(sorted(a) == sorted(b) and all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a),
              "the native decoder's batch differs from the numpy path's")
    rates = {False: [], True: []}
    for native in (False, True, True, False):
        loader = PrefetchLoader(ds, geo, 1, shuffle=True, seed=len(rates[native]), native=native)
        t0 = time.perf_counter()
        n = sum(1 for _ in range(LOADER_PASSES) for _ in loader)
        rates[native].append(n / (time.perf_counter() - t0))
    res = {"numpy_chunks_per_s": rates[False], "native_chunks_per_s": rates[True], "native_served": native_served,
           "chunks": len(chunk_paths), "train_step_chunks_per_s": train_rate}
    log(f"[13] PrefetchLoader (4 decode threads, batch 1, geometry overlay) on the {len(chunk_paths)} generated "
        f"96x48x96 chunks, {LOADER_PASSES} epochs a run, files warm: numpy {[round(r, 2) for r in rates[False]]} "
        f"chunks/s, native decoder {[round(r, 2) for r in rates[True]]} chunks/s ({native_served} of "
        f"{len(chunk_paths)} files served natively, the rest declined to numpy); batches np.array_equal on both "
        f"paths; phase 9's geometry train step consumes "
        f"{'%.2f' % train_rate if train_rate else 'not measured in this call'} chunks/s [{CARD}]")
    return res


def loop_models(dev):
    """(g) CoordConv3d and one autoencoder train_step, card against CPU in
    float32 (TF32 off)."""
    from tpu3dsis_torch.models.autoencoder2d import Autoencoder2d
    from tpu3dsis_torch.models.coord_conv3d import coord_conv3d

    rng = np.random.RandomState(14)
    x = torch.from_numpy(rng.randn(1, 32, *SHAPE).astype(np.float32))
    w = torch.from_numpy((rng.randn(32, 35, 3, 3, 3) / np.sqrt(35 * 27)).astype(np.float32))
    b = torch.from_numpy(rng.randn(32).astype(np.float32))
    cpu = coord_conv3d(x, w, b, padding=1)
    x_d, w_d, b_d = x.to(dev), w.to(dev), b.to(dev)
    card = coord_conv3d(x_d, w_d, b_d, padding=1)
    ms_cc = device_ms(lambda: coord_conv3d(x_d, w_d, b_d, padding=1), 10)
    cc_err = float((card.cpu() - cpu).abs().max()) / float(cpu.abs().max())
    images = torch.from_numpy(rng.rand(4, 256, 328, 3).astype(np.float32))
    models = {}
    for where in ("cpu", dev):
        m = Autoencoder2d(device=where)
        m.init_params(torch.Generator().manual_seed(0))
        loss = m.train_step(images.to(where), lr=1e-3)
        models[where] = (m, float(loss))
    loss_err = abs(models[dev][1] - models["cpu"][1]) / abs(models["cpu"][1])
    param_err = max(float((p.cpu() - q).abs().max()) / max(float(q.abs().max()), 1e-12)
                    for p, q in zip(models[dev][0].parameters(), models["cpu"][0].parameters()))
    imgs_d = images.to(dev)
    ms_ae = device_ms(lambda: models[dev][0].train_step(imgs_d, lr=0.0), 5)
    log(f"[13] coord_conv3d (1, 32, 96, 48, 96) float32, 3^3 -> 32: card vs CPU {cc_err:.3g} of the largest output "
        f"(bar {MODEL_TOL['coord_conv3d']:g}), {ms_cc:.3f} ms device time; autoencoder train_step on (4, 256, 328, 3): "
        f"loss {models[dev][1]:.6f} card vs {models['cpu'][1]:.6f} CPU ({loss_err:.3g} relative), parameters within "
        f"{param_err:.3g} of their magnitude (bar {MODEL_TOL['autoencoder']:g}), {ms_ae:.3f} ms device time a step "
        f"[{CARD}]")
    check(cc_err <= MODEL_TOL["coord_conv3d"], f"coord_conv3d card vs CPU {cc_err}")
    check(loss_err <= MODEL_TOL["autoencoder"] and param_err <= MODEL_TOL["autoencoder"],
          f"autoencoder card vs CPU: loss {loss_err}, parameters {param_err}")
    return {"coord_conv3d_err": cc_err, "autoencoder_loss_err": loss_err, "autoencoder_param_err": param_err,
            "coord_conv3d_ms": ms_cc, "autoencoder_step_ms": ms_ae}


def phase_color_loop(dev, train_rate=None):
    """Phase 13: the closed color loop on the card from files on disk, in a
    fresh temporary directory: (a) datagen, (b) the entry module's training
    (20 bf16 steps, the ENet trained) and one in-process step recorded, (c)
    test mode with images from disk, as a subprocess and in process
    recorded, (d) the export with its oracle leg, (e) the demo (beside
    (a)), (f) the loader on both paths, (g) the two small models card vs
    CPU."""
    t_phase = time.time()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        chunk_paths, records, res["datagen"], res["demo"] = loop_datagen(tmp)
        cfg, overlay = loop_config(tmp, chunk_paths, records)
        out_root = os.path.join(tmp, "out")
        ckpt_dir = os.path.join(out_root, overlay, "checkpoints")  # main.py joins --output_dir and --cfg
        common = ["--cfg", overlay, "--output_dir", out_root]
        lines = []
        launches, _, wall = run_entry([*common, "--mode", "train", "--max_steps", str(LOOP_STEPS)], stdout=lines)
        losses = [float(l.split()[5]) for l in lines if l.startswith("epoch ")]
        rates = [float(l.split()[6].rstrip("s/iter")) for l in lines if l.startswith("epoch ")]
        snapshot = os.path.join(ckpt_dir, f"step_{LOOP_STEPS}.npz")
        log(f"[13] python -m tpu3dsis_torch.main --mode train, {LOOP_STEPS} bf16 steps with the ENet trained, "
            f"{len(chunk_paths)} chunks and their frames from disk: {wall:.1f} s with start-up; total_loss "
            f"{[round(x, 4) for x in losses]}; s/iter by its log (steps 6-{LOOP_STEPS}, median) "
            f"{statistics.median(rates[5:]) if len(rates) > 5 else rates}; launches {launches} [{CARD}]")
        check(len(losses) == LOOP_STEPS and all(np.isfinite(losses)), f"the loop's training losses: {losses}")
        check(os.path.isfile(snapshot), f"--mode train wrote no {os.path.basename(snapshot)}")
        for k in ("roi_pool3d_cuda", "roi_pool3d_backward_cuda", "nms3d_cuda", "fuse_views_cuda",
                  "fuse_views_backward_cuda"):
            check(launches[k] > 0, f"the loop's training did not launch {k}")
        res["train"] = {"launches": launches, "losses": losses, "s_per_iter": rates, "seconds": wall}
        res["step"] = loop_train_step_calls(dev, cfg, snapshot)

        launches, test_map, wall = run_entry([*common, "--mode", "test", "--step", snapshot])
        from tpu3dsis_torch.io import read_chunk_file

        scene_shape = list(read_chunk_file(records[0]["scene_path"], with_masks=False).sdf.shape)
        scene_shape[1] = min(scene_shape[1], 48)  # test mode's height crop
        n_det = check_artifacts(artifacts_without_torch(cfg.TEST_SAVE_DIR), len(records), True, extent=scene_shape)
        log(f"[13] python -m tpu3dsis_torch.main --mode test --step step_{LOOP_STEPS}.npz on {len(records)} eval "
            f"scene(s) {tuple(scene_shape)} with images from disk: {wall:.1f} s with start-up, "
            f"{len(records) / wall * 60:.2f} scenes/min with start-up; detections {n_det}; launches {launches}; "
            f"mAP {test_map} [{CARD}]")
        check(test_map is not None and all(np.isfinite(v) for v in test_map.values()), f"test mode mAP {test_map}")
        for k in ("roi_pool3d_cuda", "nms3d_cuda", "nms3d_cuda_class_aware", "fuse_views_cuda"):
            check(launches[k] > 0, f"test mode with images from disk did not launch {k}")
        res["test"] = {"launches": launches, "map": test_map, "seconds": wall}
        res["test_calls"] = loop_test_calls(dev, cfg, snapshot)
        res["export"] = loop_export(tmp, cfg, records)
        res["loader"] = loop_loader(cfg, chunk_paths, train_rate)
        res["models"] = loop_models(dev)
    for key in ("k1_err", "k2_err", "class_aware_err", "k3_err"):
        res[key] = max(res["step"].get(key, 0.0), res["test_calls"].get(key, 0.0))
    res["k1b_err"], res["k3b_err"] = res["step"]["k1b_err"], res["step"]["k3b_err"]
    res["seconds"] = time.time() - t_phase
    log(f"[13] phase 13 in {res['seconds']:.1f} s")
    return res


def main(argv=None) -> int:
    global CARD, CLOCK_MHZ
    import argparse

    parser = argparse.ArgumentParser(description="the port's paths on one NVIDIA card")
    parser.add_argument("--phases", default="2,3,4,5,6,7,8,9,10,11,12,13",
                        help="comma-separated phases to run after 0 and 1 (all by default; a subset prints no "
                             "result line)")
    phases = {int(p) for p in parser.parse_args(argv).phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA card", file=sys.stderr)
        return 1
    t_start = time.time()
    CARD = nvidia_smi("name,power.limit")
    try:
        CLOCK_MHZ = float(nvidia_smi("clocks.max.sm").split()[0])
    except (ValueError, IndexError):
        CLOCK_MHZ = 0.0  # not reported: the K2 latency floor is then not measured
    dev = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    found = {m: importlib.util.find_spec(m) is not None for m in ("jax", "yaml", "PIL")}
    log(f"[0] {torch.cuda.get_device_name(0)} | nvidia-smi: {CARD}, max SM clock {CLOCK_MHZ:.0f} MHz | "
        f"torch {torch.__version__} CUDA {torch.version.cuda} | python {sys.version.split()[0]} | "
        f"importable (not needed): {found}")

    t0 = time.time()
    paths, build_log = _build.build()
    _build.load_library()
    log(f"[1] kernels built in {time.time() - t0:.1f} s -> {', '.join(p.name for p in paths)}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line or "Compiling" in line:
            log(f"[1]   {line.strip()}")

    rng = np.random.RandomState(0)
    if phases != {2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13}:
        # a subset, for working on one phase: phase 9 takes phase 2's inputs and phase 6's weights,
        # phase 11 phase 7's rooms and test-mode artifacts of phase 8's scenes (driver_artifacts)
        if 6 in phases:
            params = scene_params()
            sis, scene_list, _, _, k2c = phase_scene(dev, params)
            phase_scene_card_vs_cpu(sis, params)
            phase_scene_timing(sis, scene_list, k2c)
            del sis, scene_list
        if 7 in phases:
            phase_color(dev, color_params())
        if 9 in phases:
            phase_train(dev, kernel_inputs(dev, rng), scene_params())
        if 10 in phases:
            phase_enet(dev)
        if 11 in phases:
            cparams = color_params()
            made = [make_color_scene(np.random.RandomState(20 + i), v) for i, v in enumerate(COLOR_VIEWS)]
            cscenes, cgts, cframes = (list(x) for x in zip(*made))
            phase_mask_color(dev, cparams, cscenes, cframes, {"test_artifacts": driver_artifacts(dev)})
        if 12 in phases:
            phase_parallel(dev)
        if 13 in phases:
            phase_color_loop(dev)
        log(f"[done] phases {sorted(phases)} passed in {time.time() - t_start:.1f} s; no result line for a subset")
        return 0
    kernel_res, kernel_data = phase_kernels(dev, rng)

    scenes, gts = make_chunks(np.random.RandomState(1), BATCH)
    dets = load_detectors(dev)
    outs, launches, per_batch = phase_main_path(dev, scenes, gts, dets)

    cpu_det = load_jax_params(Detector(scannet_chunk_config(), device="cpu"), TRAINED)
    phase_card_vs_cpu(scenes[:1], dets, cpu_det, outs)

    kernels = phase_timing(dev, scenes, dets, kernel_data)

    params = scene_params()
    sis, scene_list, scene_launches, per_scene, k2c = phase_scene(dev, params)
    phase_scene_card_vs_cpu(sis, params)
    scene_t = phase_scene_timing(sis, scene_list, k2c)
    del sis, scene_list

    cparams = color_params()
    csis, cscenes, cgts, cframes, color_launches, color_per_scene, k3r = phase_color(dev, cparams)
    phase_color_card_vs_cpu(csis, cparams)
    color_t = phase_color_timing(csis, cscenes, cframes, k3r)
    del csis

    drv = phase_drivers(dev, params, cparams, cscenes, cgts, cframes, scene_t, color_t)
    train = phase_train(dev, kernel_data, params)
    geo, col = train["runs"]["geometry"], train["runs"]["color"]
    enet = phase_enet(dev)
    ent = enet["run"]["launches"]
    mc = phase_mask_color(dev, cparams, cscenes, cframes, drv)
    mcp, mct = mc["launches"], mc["train"]["launches"]
    par = phase_parallel(dev)
    dpl, tpl, spl, nrl = (par["dp"]["launches"], par["tiles"]["launches"], par["spatial"]["launches"],
                          par["no_rpn"]["launches"])
    loop = phase_color_loop(dev, geo["chunks_per_s"])
    ltr, lte = loop["train"]["launches"], loop["test"]["launches"]

    k1, k2 = kernel_res["roi_pool3d_cuda"], kernel_res["nms3d_cuda"]
    # K1 at the bench's compute dtype, bf16, and K2 at N = 400, thresh 0.1
    # (both dtypes and the other cases are on the [2] and [5] lines)
    record = {"kernels": [
        {"name": "roi_pool3d_cuda", "route": "cuda", "source": "tpu3dsis_torch/csrc/roi_pool3d.cu",
         "replaces": "tpu3dsis/ops/roi_pool3d_pallas.py:85", "launches": launches["roi_pool3d_cuda"],
         "launches_per_batch": per_batch["roi_pool3d_cuda"], "launches_scene_path": scene_launches["roi_pool3d_cuda"],
         "launches_per_scene": per_scene["roi_pool3d_cuda"], "launches_color_path": color_launches["roi_pool3d_cuda"],
         "launches_driver_path": drv["launches"]["roi_pool3d_cuda"],
         "launches_driver_color_path": drv["color"]["launches"]["roi_pool3d_cuda"],
         "launches_train_path": geo["launches"]["roi_pool3d_cuda"],
         "launches_train_color_path": col["launches"]["roi_pool3d_cuda"],
         "launches_train_enet_path": ent["roi_pool3d_cuda"],
         "launches_mask_color_path": mcp["roi_pool3d_cuda"], "launches_train_mask_color_path": mct["roi_pool3d_cuda"],
         "launches_dp_train_path_per_rank": dpl["roi_pool3d_cuda"],
         "launches_tile_parallel_path": tpl["roi_pool3d_cuda"], "launches_spatial_path": spl["roi_pool3d_cuda"],
         "launches_no_rpn_train_path": nrl["roi_pool3d_cuda"],
         "launches_color_loop_train_path": ltr["roi_pool3d_cuda"], "launches_color_loop_test_path": lte["roi_pool3d_cuda"],
         "max_abs_err": max(k1["err"], k2c["k1_err"], k3r["k1_err"], train["k1_err"], enet["k1_err"], mc["k1_err"],
                            par["tiles"]["err"], par["spatial"]["err"], loop["k1_err"]),
         "ms": kernels["k1_bfloat16"], "plain_ms": k1["plain_ms_bfloat16"],
         "bound_ms": kernels["k1_bfloat16_bound"], "bound_by": "bytes", "library_ms": None},
        {"name": "roi_pool3d_backward_cuda", "route": "cuda", "source": "tpu3dsis_torch/csrc/roi_pool3d_bwd.cu",
         "replaces": "tpu3dsis/ops/roi_pool3d.py:350", "launches": geo["launches"]["roi_pool3d_backward_cuda"],
         "launches_per_step": geo["launches"]["roi_pool3d_backward_cuda"] / TRAIN_STEPS,
         "launches_train_color_path": col["launches"]["roi_pool3d_backward_cuda"],
         "launches_train_enet_path": ent["roi_pool3d_backward_cuda"],
         "launches_train_mask_color_path": mct["roi_pool3d_backward_cuda"],
         "launches_entry_train": train["entry"]["launches"]["roi_pool3d_backward_cuda"],
         "launches_dp_train_path_per_rank": dpl["roi_pool3d_backward_cuda"],
         "launches_dp_entry_train_nccl": par["dp"]["nccl"]["launches"]["roi_pool3d_backward_cuda"],
         "launches_no_rpn_train_path": nrl["roi_pool3d_backward_cuda"],
         "launches_color_loop_train_path": ltr["roi_pool3d_backward_cuda"],
         "max_abs_err": max(train["k1b_err"], loop["k1b_err"]), "ms": train["k1b_ms"], "plain_ms": train["k1b_plain_ms"],
         "bound_ms": train["k1b_bound_ms"], "bound_by": "bytes", "library_ms": None,
         "times": train["k1b_times"]},
        {"name": "nms3d_cuda", "route": "cuda", "source": "tpu3dsis_torch/csrc/nms3d.cu",
         "replaces": "tpu3dsis/ops/nms.py:86", "launches": launches["nms3d_cuda"],
         "launches_per_batch": per_batch["nms3d_cuda"], "launches_scene_path": scene_launches["nms3d_cuda"],
         "launches_per_scene": per_scene["nms3d_cuda"], "launches_color_path": color_launches["nms3d_cuda"],
         "wrapper_calls_scene_path": k2c["wrapper_calls"]["nms3d_cuda"],
         "wrapper_calls_color_path": k3r["wrapper_calls"]["nms3d_cuda"],
         # the driver paths replay the scene chain: their wrapper counts are
         # calls (eager chains and captures), not kernels
         "wrapper_calls_driver_path": drv["launches"]["nms3d_cuda"],
         "wrapper_calls_driver_color_path": drv["color"]["launches"]["nms3d_cuda"],
         "launches_train_path": geo["launches"]["nms3d_cuda"],
         "launches_train_color_path": col["launches"]["nms3d_cuda"],
         "launches_train_enet_path": ent["nms3d_cuda"],
         "launches_mask_color_path": mcp["nms3d_cuda"], "launches_train_mask_color_path": mct["nms3d_cuda"],
         "launches_dp_train_path_per_rank": dpl["nms3d_cuda"], "launches_tile_parallel_path": tpl["nms3d_cuda"],
         "launches_spatial_path": spl["nms3d_cuda"], "launches_no_rpn_train_path": nrl["nms3d_cuda"],
         "launches_color_loop_train_path": ltr["nms3d_cuda"], "wrapper_calls_color_loop_test_path": lte["nms3d_cuda"],
         "max_abs_err": max(k2["err"], k2c["k2_err"], k3r["k2_err"], train["k2_err"], enet["k2_err"], mc["k2_err"],
                            par["tiles"]["err"], par["spatial"]["err"], loop["k2_err"]),
         "ms": kernels["k2_400_0.1"], "plain_ms": kernels["k2_plain_0.1"],
         "bound_ms": kernels["k2_400_bound"], "bound_by": kernels["k2_400_bound_by"], "library_ms": None},
        {"name": "nms3d_cuda (class-aware, scene stitch)", "route": "cuda", "source": "tpu3dsis_torch/csrc/nms3d.cu",
         "replaces": "tpu3dsis/ops/nms.py:86 (classes=, tpu3dsis/infer/tiling.py:1306)",
         "launches": scene_launches["nms3d_cuda_class_aware"],
         "launches_per_scene": per_scene["nms3d_cuda_class_aware"],
         "launches_color_path": color_launches["nms3d_cuda_class_aware"],
         "wrapper_calls_scene_path": k2c["wrapper_calls"]["nms3d_cuda_class_aware"],
         "wrapper_calls_color_path": k3r["wrapper_calls"]["nms3d_cuda_class_aware"],
         "wrapper_calls_driver_path": drv["launches"]["nms3d_cuda_class_aware"],
         "wrapper_calls_driver_color_path": drv["color"]["launches"]["nms3d_cuda_class_aware"],
         "launches_mask_color_path": mcp["nms3d_cuda_class_aware"],
         "launches_tile_parallel_path": tpl["nms3d_cuda_class_aware"],
         "wrapper_calls_color_loop_test_path": lte["nms3d_cuda_class_aware"],
         "max_abs_err": max(k2c["err"], loop["class_aware_err"]),
         "ms": scene_t["k2_class_aware"]["ms"], "plain_ms": scene_t["k2_class_aware"]["plain_ms"],
         "bound_ms": scene_t["k2_class_aware"]["bound_ms"], "bound_by": scene_t["k2_class_aware"]["bound_by"],
         "library_ms": None},
        {"name": "fuse_views_cuda", "route": "cuda", "source": "tpu3dsis_torch/csrc/fuse_views.cu",
         "replaces": "tpu3dsis/geometry/projection.py:369", "launches": color_launches["fuse_views_cuda"],
         "launches_per_scene": color_per_scene["fuse_views_cuda"],
         "launches_driver_color_path": drv["color"]["launches"]["fuse_views_cuda"],
         "launches_train_color_path": col["launches"]["fuse_views_cuda"],
         "launches_train_enet_path": ent["fuse_views_cuda"],
         "launches_mask_color_path": mcp["fuse_views_cuda"], "launches_train_mask_color_path": mct["fuse_views_cuda"],
         "launches_tile_parallel_path": tpl["fuse_views_cuda"],
         "launches_color_loop_train_path": ltr["fuse_views_cuda"], "launches_color_loop_test_path": lte["fuse_views_cuda"],
         "max_abs_err": max(k3r["err"], drv["color"]["k3_err"], train.get("k3_err", 0.0), enet.get("k3_err", 0.0),
                            mc["k3_err"], loop["k3_err"]),
         "ms": color_t["bfloat16"]["k3_ms"], "plain_ms": color_t["bfloat16"]["k3_plain_ms"],
         "bound_ms": color_t["bfloat16"]["k3_bound_ms"], "bound_by": color_t["bfloat16"]["k3_bound_by"],
         "library_ms": None, "cull_kept_share": k3r["kept_share"]},
        {"name": "fuse_views_backward_cuda", "route": "cuda", "source": "tpu3dsis_torch/csrc/fuse_views_bwd.cu",
         "replaces": "tpu3dsis/geometry/projection.py:173", "launches": ent["fuse_views_backward_cuda"],
         "launches_per_step": enet["per_step"]["fuse_views_backward_cuda"],
         "launches_train_mask_color_path": mct["fuse_views_backward_cuda"],
         "launches_per_step_mask_color": mc["train"]["per_step"]["fuse_views_backward_cuda"],
         "launches_color_loop_train_path": ltr["fuse_views_backward_cuda"],
         "max_abs_err": max(enet["k3b_err"], mc["k3b_err"], loop["k3b_err"]),
         "ms": enet["k3b_ms"], "plain_ms": enet["k3b_plain_ms"], "bound_ms": enet["k3b_bound_ms"],
         "bound_by": enet["k3b_bound_by"], "library_ms": None, "times": enet["k3b_times"]},
    ]}
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps(record))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
