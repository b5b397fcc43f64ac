"""Where K1's, K2's and K3's time goes on the card, without a profiler's counters.

Each kernel is timed against copies of itself built with one phase cut out
(a loop that runs no time, a store that never happens, an early return), on
the inputs ``chip_smoke.py`` uses: phase 2's 6400 rois and the main path's
own proposals for K1, 32 x 400 and 32 x 1024 boxes for K2, the views of
phase 7's 96-view room fused into its 240x48x240 volume for K3. A cut copy
computes nothing useful; only its time is read. Run from the repository root
on a machine with a CUDA card and nvcc:

    python -m tpu3dsis_torch.probe

It prints one JSON line per case: the full kernel's and each cut copy's
device time in ms, measured in turns (full, cuts, cuts reversed, full).
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from tpu3dsis_torch import _build

# per source: cut name -> (text in the source, its replacement)
CUTS = {
    "roi_pool3d.cu": {
        "no pool loop": ("  for (int col = (threadIdx.x >> 5) * per_warp + lane / lanes; col < P * P;",
                         "  for (int col = P * P; col < P * P;"),
        "no output stores": ("    __stcs(dst + f, tile[row * pitch + f % kRowUnits]);",
                             "    if (row < 0) __stcs(dst + f, tile[row * pitch + f % kRowUnits]);"),
    },
    "nms3d.cu": {
        "staging only": ("  cluster.sync();  // also: every block has started before any writes to another\n",
                         "  cluster.sync();\n  if (N > 0) return;\n"),
        "one pair per row": ("#pragma unroll 8\n      for (int t = 0; t < n; ++t) {",
                             "#pragma unroll 8\n      for (int t = 0; t < 1; ++t) {"),
        "no walk": ("  if (rank != 0) return;\n", "  return;\n"),
    },
    "fuse_views.cu": {
        "no gather or max": ("    while (accepted) {  // uniform: the same set in every lane",
                          "    while (accepted && V < 0) {"),
        "no output stores": ("    *reinterpret_cast<Pack<T, CPL>*>(out + (n0 + j) * C + lane * CPL) = r;",
                             "    if (V < 0) *reinterpret_cast<Pack<T, CPL>*>(out + (n0 + j) * C + lane * CPL) = r;"),
    },
}


def build_cuts():
    """{source stem: {"full" or cut name: ctypes library}}, all built at once."""
    nvcc = _build._nvcc()
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in _build.SOURCES:
        text = src.read_text()
        for name, cut in {"full": None, **CUTS[src.name]}.items():
            if cut and cut[0] not in text:
                raise RuntimeError(f"{src.name}: the probe's anchor for '{name}' is gone; update CUTS")
            variant = out / f"{src.stem}_{name.replace(' ', '_')}.cu"
            variant.write_text(text if cut is None else text.replace(cut[0], cut[1]))
            lib = variant.with_suffix(".so")
            proc = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(variant)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src.stem, name, lib, proc))
    libs = {}
    for stem, name, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"probe build of {stem} '{name}' failed:\n{log}")
        handle = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in _build._SIGNATURES.items():
            if hasattr(handle, fn):
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = restype
        libs.setdefault(stem, {})[name] = handle
    return libs


def call_k1(lib, feats, rois, batch_idx, level_idx, scales, pooled):
    n, f0 = len(feats), feats[0]
    m, c = rois.shape[0], f0.shape[-1]
    out = torch.empty((m, c, pooled, pooled, pooled), dtype=f0.dtype, device=f0.device)
    err = lib.tpu3dsis_roi_pool3d(
        int(f0.dtype == torch.bfloat16), n, (ctypes.c_void_p * n)(*[f.data_ptr() for f in feats]),
        (ctypes.c_int * (3 * n))(*[d for f in feats for d in f.shape[1:4]]),
        (ctypes.c_float * n)(*[float(s) for s in scales]), f0.shape[0], c, rois.data_ptr(),
        batch_idx.data_ptr(), level_idx.data_ptr(), m, pooled, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "probe K1")


def call_k2(lib, boxes, valid, thresh):
    b, n = valid.shape
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    err = lib.tpu3dsis_nms3d(boxes.data_ptr(), valid.data_ptr(), None, b, n, float(thresh), keep.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "probe K2")


def call_k3(lib, feats2d, depths, mats, valid, fx, fy, cx, cy, volume_dims, depth_min, depth_max, voxel_size):
    v, h, w, c = feats2d.shape
    out = torch.empty((*volume_dims, c), dtype=feats2d.dtype, device=feats2d.device)
    err = lib.tpu3dsis_fuse_views(int(feats2d.dtype == torch.bfloat16), feats2d.data_ptr(), depths.data_ptr(),
                                  mats.data_ptr(), valid.data_ptr(), v, h, w, c, *volume_dims, fx, fy, cx, cy,
                                  depth_min, depth_max, voxel_size, 0, out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(err, "probe K3")


def k3_inputs(dev, cs):
    """K3's arguments for phase 7's 96-view room at its bucket, features
    random (their values do not change the work)."""
    from tpu3dsis_torch.geometry.projection import view_matrices

    _, _, frames = cs.make_color_scene(np.random.RandomState(21), 96)
    cfg = cs.scannet_color_scene_config()
    k = cfg.INTRINSIC
    feats = torch.randn((96, 32, 41, 128), generator=torch.Generator().manual_seed(3)).to(dev)
    return feats, dict(depths=torch.from_numpy(frames["depths"]).to(dev),
                       mats=view_matrices(frames["poses"], frames["world_to_grid"]).to(dev),
                       valid=torch.ones(96, dtype=torch.uint8, device=dev), fx=k[0][0], fy=k[1][1], cx=k[0][2],
                       cy=k[1][2], volume_dims=cs.SCENE_EXTENT, depth_min=cfg.PROJ_DEPTH_MIN,
                       depth_max=cfg.PROJ_DEPTH_MAX, voxel_size=cfg.VOXEL_SIZE)


def in_turns(fns, iters, device_ms):
    names = list(fns)
    times = {k: [] for k in names}
    for k in names + names[::-1]:
        times[k].append(device_ms(fns[k], iters))
    return {k: round(statistics.median(v), 5) for k, v in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs  # the inputs and timing of the card's smoke run

    card = cs.nvidia_smi("name,power.limit")
    dev = torch.device("cuda:0")
    libs = build_cuts()
    feats, k1, k2 = cs.kernel_inputs(dev, np.random.RandomState(0))
    scenes, _ = cs.make_chunks(np.random.RandomState(1), cs.BATCH)
    x = torch.from_numpy(scenes).to(dev)
    cases = {}
    for (cfg, det) in cs.load_detectors(dev):
        name = cfg.TPU_COMPUTE_DTYPE
        cases[f"K1 {name}, phase 2's rois"] = (list(feats.to(det.compute_dtype).unbind(0)), k1)
        cases[f"K1 {name}, the main path's rois"] = cs.main_path_kernel_inputs(cfg, det, x)
    for case, (levels, kw) in cases.items():
        fns = {k: (lambda lib=lib: call_k1(lib, levels, **kw)) for k, lib in libs["roi_pool3d"].items()}
        print(json.dumps({"case": case, "ms": in_turns(fns, 20, cs.device_ms), "card": card}), flush=True)
    k2_cases = {400: k2, 1024: {k: v.to(dev) for k, v in cs._boxes(np.random.RandomState(2), cs.BATCH, 1024).items()}}
    for n, bx in k2_cases.items():
        fns = {k: (lambda lib=lib: call_k2(lib, bx["boxes"], bx["valid"], 0.1))
               for k, lib in libs["nms3d"].items()}
        print(json.dumps({"case": f"K2 32x{n} boxes, thresh 0.1", "ms": in_turns(fns, 50, cs.device_ms),
                          "card": card}), flush=True)
    feats, k3 = k3_inputs(dev, cs)
    for dt in (torch.bfloat16, torch.float32):
        f = feats.to(dt)
        fns = {k: (lambda lib=lib: call_k3(lib, f, **k3)) for k, lib in libs["fuse_views"].items()}
        print(json.dumps({"case": f"K3 {str(dt).split('.')[-1]}, 96 views into {cs.SCENE_EXTENT} x 128",
                          "ms": in_turns(fns, 10, cs.device_ms), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
