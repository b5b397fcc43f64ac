#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's chunk and whole-scene paths on one NVIDIA card.

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
     fused path, with the kernels' launches counted; the card against the
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
     counted; the card against the CPU on a 144x48x144 room with 16 views;
     bfloat16 against float32; color masked scenes/min over a prefetched
     stream of 8, ``device_seconds``, prep ms by view count (upload, ENet,
     K3), per-stage ms, K3 against its plain version and its bound, and a
     profile of one bf16 scene with its prep.

The last three lines are the kernels' JSON, the card's name and power limit
as ``nvidia-smi`` reports them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from tpu3dsis_torch import (Detector, SceneInference, _build, build_inference_fn, load_jax_params,
                            scannet_chunk_config, scannet_color_scene_config, scannet_scene_config)
from tpu3dsis_torch.geometry import projection
from tpu3dsis_torch.geometry.boxes import nms_overlap
from tpu3dsis_torch.infer.color_volume import build_color_volume
from tpu3dsis_torch.models.detector import device_anchors
from tpu3dsis_torch.models.rpn import select_proposals
from tpu3dsis_torch.ops import nms
from tpu3dsis_torch.ops import roi_pool3d as rp

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


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median time of fn() in ms, CUDA events around each call (the time
    includes any gap while the host enqueues the call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of one fn() in ms: `iters` calls queued behind a device
    sleep, so the events see the kernels back to back and no host gap."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms: longer than enqueueing the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


def make_scene(rng, extent=SCENE_EXTENT, n_objects=24):
    """A scene as tools/tiling_parity_check.py:89 make_scene draws it (about a
    third 53-voxel sofas), encoded; and its object boxes."""
    sdf = np.full(extent, 8.0, np.float32)
    boxes = []
    kinds = ["sofa"] * (n_objects // 3)
    kinds += ["chair", "table"] * ((n_objects - len(kinds)) // 2 + 1)
    for kind in kinds[:n_objects]:
        _add_object(sdf, boxes, rng, kind, (2, 2, 2), tuple(e - 2 for e in extent))
    return encode_tsdf(sdf), np.asarray(boxes, np.float32)


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
            "fuse_views_cuda": lib.tpu3dsis_fuse_views_launches()}


def reset_launch_counts():
    """Every wrapper's launch count to 0 (just before a path is driven)."""
    rp.roi_pool3d_cuda.launches = 0
    nms.nms3d_cuda.launches = 0
    nms.nms3d_cuda.class_aware_launches = 0
    projection.fuse_views_cuda.launches = 0


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


def phase_card_vs_cpu(scene, dets, cpu_det, outs):
    cfg32, det32 = dets[0]
    card = {k: v.cpu() for k, v in build_inference_fn(det32, cfg32, SHAPE)(torch.from_numpy(scene)).items()}
    cpu = build_inference_fn(cpu_det, cfg32, SHAPE)(torch.from_numpy(scene))
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
    log(f"[4] card vs CPU, one chunk, float32, TF32 off: {int(vc.sum())} valid proposals, "
        f"same order={in_order}, max abs diff {errs} [{CARD}]")

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
    and K3's wrappers, with copies of its arguments, in call order: [(kind,
    {argument: value})], kind the wrapper's name or "class-aware" for K2 with
    classes. The wrappers are wrapped for that call only."""
    calls = []
    wrapped = ((rp, "roi_pool3d_cuda"), (nms, "nms3d_cuda"), (projection, "fuse_views_cuda"))
    originals = [getattr(mod, name) for mod, name in wrapped]

    def recorder(fn):
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
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
        si.infer(scene, frames)
    finally:
        for (mod, name), fn in zip(wrapped, originals):
            setattr(mod, name, fn)
    check(si.last_fused == fused, f"the recorded scene was {'not ' * fused}served by the fused path")
    return calls


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

    # the path: every count set to 0 just before, read just after
    reset_launch_counts()
    before = device_launches()
    outs = {}
    for dt, si in sis.items():
        outs[dt] = []
        for s in scenes:
            det, masks = si.infer(s)
            check(si.last_fused, f"{dt}: a scene fell back to the host-planned path")
            outs[dt].append((det, masks))
    torch.cuda.synchronize()
    launches = {"roi_pool3d_cuda": rp.roi_pool3d_cuda.launches, "nms3d_cuda": nms.nms3d_cuda.launches,
                "nms3d_cuda_class_aware": nms.nms3d_cuda.class_aware_launches}
    kernel_launches = {k: v - before[k] for k, v in device_launches().items() if k in launches}
    runs = len(sis) * n_scenes
    per_scene = {k: v / runs for k, v in launches.items()}
    host_path = {dt: si.host_path_scenes for dt, si in sis.items()}
    log(f"[6] scene path: {runs} scenes ({n_scenes} x float32, bfloat16) of {SCENE_EXTENT}, 25 tiles each, all "
        f"served by the fused path (host-path scenes so far {host_path}); wrapper calls {launches}, kernel launches "
        f"{kernel_launches}, per scene {per_scene}")
    for k in ("roi_pool3d_cuda", "nms3d_cuda"):
        check(launches[k] > 0, f"{k} was not launched on the scene path")
        check(kernel_launches[k] == launches[k], f"{k}: {kernel_launches[k]} kernel launches for {launches[k]} calls")
    check(launches["nms3d_cuda_class_aware"] == runs, "the class-aware K2 did not launch once per scene")

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


def compare_card_cpu(card, cpu, label, cpu_s, phase):
    """float32 card against CPU: the same detections (order-free, same class,
    boxes within 1e-3 voxels, conf within 1e-4), masks within 0.005 flips
    per box; the flipped voxels are counted."""
    (dc, mc), (dp, mp) = card, cpu
    check(len(dc["pred_box"]) == len(dp["pred_box"]) > 0,
          f"{len(dc['pred_box'])} detections on the card, {len(dp['pred_box'])} on the CPU")
    used = np.zeros(len(dp["pred_box"]), bool)
    worst_box = worst_conf = worst_flip = 0.0
    flipped = 0
    for i in range(len(dc["pred_box"])):
        d = np.abs(dp["pred_box"] - dc["pred_box"][i]).max(1)
        d[used | (dp["pred_class"] != dc["pred_class"][i])] = np.inf
        j = int(np.argmin(d))
        check(d[j] <= 1e-3, f"card detection {dc['pred_box'][i]} has no CPU counterpart within 1e-3 voxels")
        used[j] = True
        worst_box = max(worst_box, float(d[j]))
        worst_conf = max(worst_conf, abs(float(dc["pred_conf"][i]) - float(dp["pred_conf"][j])))
        check(mc[i].shape == mp[j].shape, "mask shapes differ")
        if mc[i].size:
            worst_flip = max(worst_flip, float((mc[i] != mp[j]).mean()))
            flipped += int((mc[i] != mp[j]).sum())
    check(worst_conf <= 1e-4, f"card vs CPU conf differs by {worst_conf}")
    check(worst_flip < 0.005, f"card vs CPU masks differ in {worst_flip} of a box's voxels")
    log(f"[{phase}] card vs CPU, {label}, float32, TF32 off: {len(dc['pred_box'])} detections on both, "
        f"max abs diff box {worst_box:.3g} voxels, conf {worst_conf:.3g}; mask voxels flipped {flipped} of "
        f"{sum(m.size for m in mc)}, worst box {worst_flip:.4g} (CPU infer {cpu_s:.1f} s) [{CARD}]")


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
        origins = si._origins(data.shape[:3])
        tiles = si._tile_outputs(scene_dev, origins, prep)
        det = si._stitch(tiles, origins, scene.shape[:3])
        plans = si._plan_queues(det, scene_dev.shape[:3])

        def fcn(name):
            q = plans[name]
            return si._window_masks(scene_dev, q["starts"], q["locals6"], det["pred_class"][q["roi_idx"].long()],
                                    si._queue_canvas[name])

        stages = {"tiles": cuda_ms(lambda: si._tile_outputs(scene_dev, origins, prep), 5)}
        if prep is not None:
            stages["color_crops_of_tiles"] = cuda_ms(lambda: si._tile_color(prep, origins), 5)
        stages.update({
            "stitch_nms": cuda_ms(lambda: si._stitch(tiles, origins, scene.shape[:3]), 10),
            "planning": cuda_ms(lambda: si._plan_queues(det, scene_dev.shape[:3]), 10),
            "mask_fcn_small": cuda_ms(lambda: fcn("mask_small"), 5),
            "mask_fcn_large": cuda_ms(lambda: fcn("mask_large"), 5),
        })
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


def _k3_case(name, args, quiet=False):
    """K3 against its plain version on one call's arguments, with
    ``torch.equal`` (NaN positions first, then the rest). Returns (max abs
    err, plain ms, the share of voxels it fills, the plain result)."""
    got = projection.fuse_views_cuda(**args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = projection.fuse_views_plain(**args)
    end.record()
    end.synchronize()
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    same = torch.equal(nan_got, nan_want) and torch.equal(got.masked_fill(nan_got, 0), want.masked_fill(nan_want, 0))
    err = float((got.float() - want.float()).abs().nan_to_num(0.0).max())
    filled = float((want != 0).any(-1).float().mean())
    if not quiet or not same:
        log(f"[7] K3 {name}: {tuple(got.shape)} {got.dtype}, {args['feats2d'].shape[0]} views: exact={same} "
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

    # the path: every count set to 0 just before, read just after
    reset_launch_counts()
    before = device_launches()
    outs, filled = {}, {}
    for dt, si in sis.items():
        outs[dt], filled[dt] = [], []
        for s, f in zip(scenes, frames):
            det, masks = si.infer(s, f)
            check(si.last_fused, f"{dt}: a color scene was not served by the fused path")
            outs[dt].append((det, masks))
            filled[dt].append(float((si._color_cache[1]["color"] != 0).any(-1).float().mean()))
    torch.cuda.synchronize()
    launches = {"roi_pool3d_cuda": rp.roi_pool3d_cuda.launches, "nms3d_cuda": nms.nms3d_cuda.launches,
                "nms3d_cuda_class_aware": nms.nms3d_cuda.class_aware_launches,
                "fuse_views_cuda": projection.fuse_views_cuda.launches}
    kernel_launches = {k: v - before[k] for k, v in device_launches().items() if k in launches}
    runs = len(sis) * len(scenes)
    per_scene = {k: v / runs for k, v in launches.items()}
    host_path = {dt: si.host_path_scenes for dt, si in sis.items()}
    log(f"[7] color scene path: {runs} scenes ({len(scenes)} x float32, bfloat16), views {list(COLOR_VIEWS)}, all "
        f"served by the fused path (host-path scenes {host_path}); wrapper calls {launches}, kernel launches "
        f"{kernel_launches}, per scene {per_scene}")
    log(f"[7] share of the volume's voxels K3 fills, per scene: {json.dumps(filled)}")
    for k in ("roi_pool3d_cuda", "nms3d_cuda", "fuse_views_cuda"):
        check(launches[k] > 0, f"{k} was not launched on the color scene path")
        check(kernel_launches[k] == launches[k], f"{k}: {kernel_launches[k]} kernel launches for {launches[k]} calls")
    check(launches["fuse_views_cuda"] == runs, "K3 did not launch once per color scene")
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
    return sis, scenes, frames, launches, per_scene, res


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


def main() -> int:
    global CARD, CLOCK_MHZ
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
    csis, cscenes, cframes, color_launches, color_per_scene, k3r = phase_color(dev, cparams)
    phase_color_card_vs_cpu(csis, cparams)
    color_t = phase_color_timing(csis, cscenes, cframes, k3r)

    k1, k2 = kernel_res["roi_pool3d_cuda"], kernel_res["nms3d_cuda"]
    # K1 at the bench's compute dtype, bf16, and K2 at N = 400, thresh 0.1
    # (both dtypes and the other cases are on the [2] and [5] lines)
    record = {"kernels": [
        {"name": "roi_pool3d_cuda", "route": "cuda", "source": "tpu3dsis_torch/csrc/roi_pool3d.cu",
         "replaces": "tpu3dsis/ops/roi_pool3d_pallas.py:85", "launches": launches["roi_pool3d_cuda"],
         "launches_per_batch": per_batch["roi_pool3d_cuda"], "launches_scene_path": scene_launches["roi_pool3d_cuda"],
         "launches_per_scene": per_scene["roi_pool3d_cuda"], "launches_color_path": color_launches["roi_pool3d_cuda"],
         "max_abs_err": max(k1["err"], k2c["k1_err"], k3r["k1_err"]),
         "ms": kernels["k1_bfloat16"], "plain_ms": k1["plain_ms_bfloat16"],
         "bound_ms": kernels["k1_bfloat16_bound"], "bound_by": "bytes", "library_ms": None},
        {"name": "nms3d_cuda", "route": "cuda", "source": "tpu3dsis_torch/csrc/nms3d.cu",
         "replaces": "tpu3dsis/ops/nms.py:86", "launches": launches["nms3d_cuda"],
         "launches_per_batch": per_batch["nms3d_cuda"], "launches_scene_path": scene_launches["nms3d_cuda"],
         "launches_per_scene": per_scene["nms3d_cuda"], "launches_color_path": color_launches["nms3d_cuda"],
         "max_abs_err": max(k2["err"], k2c["k2_err"], k3r["k2_err"]),
         "ms": kernels["k2_400_0.1"], "plain_ms": kernels["k2_plain_0.1"],
         "bound_ms": kernels["k2_400_bound"], "bound_by": kernels["k2_400_bound_by"], "library_ms": None},
        {"name": "nms3d_cuda (class-aware, scene stitch)", "route": "cuda", "source": "tpu3dsis_torch/csrc/nms3d.cu",
         "replaces": "tpu3dsis/ops/nms.py:86 (classes=, tpu3dsis/infer/tiling.py:1306)",
         "launches": scene_launches["nms3d_cuda_class_aware"],
         "launches_per_scene": per_scene["nms3d_cuda_class_aware"], "max_abs_err": k2c["err"],
         "ms": scene_t["k2_class_aware"]["ms"], "plain_ms": scene_t["k2_class_aware"]["plain_ms"],
         "bound_ms": scene_t["k2_class_aware"]["bound_ms"], "bound_by": scene_t["k2_class_aware"]["bound_by"],
         "library_ms": None},
        {"name": "fuse_views_cuda", "route": "cuda", "source": "tpu3dsis_torch/csrc/fuse_views.cu",
         "replaces": "tpu3dsis/geometry/projection.py:369", "launches": color_launches["fuse_views_cuda"],
         "launches_per_scene": color_per_scene["fuse_views_cuda"], "max_abs_err": k3r["err"],
         "ms": color_t["bfloat16"]["k3_ms"], "plain_ms": color_t["bfloat16"]["k3_plain_ms"],
         "bound_ms": color_t["bfloat16"]["k3_bound_ms"], "bound_by": color_t["bfloat16"]["k3_bound_by"],
         "library_ms": None, "cull_kept_share": k3r["kept_share"]},
    ]}
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps(record))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
