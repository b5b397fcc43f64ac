"""Where K1's, K1b's, K2's, K3's and K3b's time goes on the card, without a profiler's counters.

Each kernel is timed against copies of itself built with one phase cut out
(a loop that runs no time, a store that never happens, an early return), on
the inputs ``chip_smoke.py`` uses: phase 2's 6400 rois and the main path's
own proposals for K1, 32 x 400 and 32 x 1024 boxes for K2, the views of
phase 7's 96-view room fused into its 240x48x240 volume for K3, and for K1b
a geometry training step's own call (recorded from the step), the training
call's shapes (two 8x24x12x24x128 level maps, 8 x 16 rois) and phase 2's
rois, each in bf16 and float32, and for K3b one batched call on the
trainable-ENet color batch's views (float32, 4 samples of 5 views into
96x48x96) and phase 10's 32-view room (one sample into 240x48x240). A cut
copy computes nothing useful; only
its time is read. K1b's copies are cut at its constants: "zeros only"
stores every brick as zeros without the column pass or a scan of the rois
(the write floor), "no column walk" takes each plane's max from one voxel
in the column pass, "no stage recompute" takes each row's x-max from one
voxel in the brick pass (the one stage a brick recomputes); two copies
change its shape, not its result ("bricks 4x4x4", "16 columns staged");
"float32 zero and cast alone" times zeroed float32 maps and their cast to
the maps' dtype, the traffic a wrapper that sums in float32 maps pays
around its kernel. A K1b copy built to count (not timed) adds to each
K1b line what the kernels computed on that input: the columns the column
pass computed and their row x-maxima, the columns the brick pass staged
(once per brick that meets a column) and the row x-maxima it recomputed.
Run from the repository root on a machine with a CUDA card and nvcc:

    python -m tpu3dsis_torch.probe [K1] [K1b] [K2] [K3] [K3b] [--against DIR ...]

(all five when none is named). K3b's copies: "pass 1 only" (the zero fill
and the list), "pass 2 only" (the gradient from a list a whole call
left), "zero fill alone"; its line adds what pass 1 listed, counted from
the list: the accepted voxels and the most of them in one of K3's bricks,
one warp's slices of a brick and one slice (the chain of dependent walks
that bounded the per-sample design). It prints one JSON line per case:
the full kernel's and each cut copy's device time in ms, measured in
turns (full, cuts, cuts reversed, full); K3's line adds the share of
(brick, view) pairs its cull keeps. ``--against DIR`` (with K1b or K3b)
also times the whole wrapper, ``ops/roi_pool3d.py::roi_pool3d_backward_cuda``
or ``geometry/projection.py::fuse_views_backward_cuda``, of another
checkout of the repository (DIR holds its ``tpu3dsis_torch``, for example
an earlier commit unpacked with ``git archive``) against this checkout's,
on the same inputs, each in a process started in its checkout, in turns
(the others, this one, this one, the others reversed): one JSON line per
case with each checkout's median ms (for K3b also the host's ms of a call
and the device's busy ms, its kernels, copies and memsets summed from
``torch.profiler``, which the host's pace does not stretch). A checkout
whose K3b takes a batch (it has ``fuse_views_batch``) is called once for
the batch on the forward's operands, as its train step calls it; an
earlier one once a sample.
"""

from __future__ import annotations

import ctypes
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tpu3dsis_torch import _build
from tpu3dsis_torch.utils import profiling

COUNTING = "counting"  # the copy of K1b that counts what its kernels compute; built, not timed

_K3_CULL = "  const int ncand = cull_brick<kCullViews>(depths, mats, view_valid, V, lo, hi, k, s_mat, s_view, cs, culled);\n"
# per source: cut name -> (text in the source, its replacement)
CUTS = {
    "roi_pool3d.cu": {
        "no pool loop": ("  for (int col = (threadIdx.x >> 5) * per_warp + lane / lanes; col < P * P;",
                         "  for (int col = P * P; col < P * P;"),
        "no output stores": ("    __stcs(dst + f, tile[row * pitch + f % kRowUnits]);",
                             "    if (row < 0) __stcs(dst + f, tile[row * pitch + f % kRowUnits]);"),
    },
    "roi_pool3d_bwd.cu": {
        "zeros only": ("constexpr bool kZerosOnly = false;", "constexpr bool kZerosOnly = true;"),
        "no column walk": ("constexpr bool kColumnWalk = true;", "constexpr bool kColumnWalk = false;"),
        "no stage recompute": ("constexpr bool kStageRecompute = true;", "constexpr bool kStageRecompute = false;"),
        "bricks 4x4x4": ("constexpr int kBX = 2, kBY = 4, kBZ = 4;", "constexpr int kBX = 4, kBY = 4, kBZ = 4;"),
        "16 columns staged": ("constexpr int kPairs = 8; ", "constexpr int kPairs = 16;"),
        COUNTING: ("constexpr bool kCount = false;", "constexpr bool kCount = true;"),
    },
    "nms3d.cu": {
        "staging only": ("  cluster.sync();  // also: every block has started before any writes to another\n",
                         "  cluster.sync();\n  if (N > 0) return;\n"),
        "one pair per row": ("#pragma unroll 8\n      for (int t = 0; t < n; ++t) {",
                             "#pragma unroll 8\n      for (int t = 0; t < 1; ++t) {"),
        "no walk": ("  if (rank != 0) return;\n", "  return;\n"),
    },
    "fuse_views.cu": {
        "no cull": ("constexpr bool kCullViews = true;", "constexpr bool kCullViews = false;"),
        "cull only": (_K3_CULL, _K3_CULL + "  if (V > 0) return;\n"),
        "no gather or max": ("        while (acc_set) {  // uniform; lowest lane first, i.e. view order",
                             "        while (acc_set && V < 0) {"),
        "no output stores": ("      store_row(reinterpret_cast<Pack<T, CPL>*>(dst), r);",
                             "      if (V < 0) store_row(reinterpret_cast<Pack<T, CPL>*>(dst), r);"),
    },
    "fuse_views_bwd.cu": {
        "pass 1 only": ("constexpr bool kPass2 = true;", "constexpr bool kPass2 = false;"),
        "pass 2 only": ("constexpr bool kPass1 = true;", "constexpr bool kPass1 = false;"),
        "zero fill alone": ("constexpr bool kZeroOnly = false;", "constexpr bool kZeroOnly = true;"),
    },
}
# warps of one of K3's bricks (fuse_views_common.cuh's kWarps): warp w takes
# its x-slices w and w + kWarps
_K3_WARPS = 4


def build_cuts():
    """{source stem: {"full" or cut name: ctypes library}}, all built at once."""
    nvcc = _build._nvcc()
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    for src in _build.SOURCES:
        text = src.read_text()
        for name, (anchor, _) in CUTS[src.name].items():
            if anchor not in text:
                raise RuntimeError(f"{src.name}: the probe's anchor for '{name}' is gone; update CUTS")
    jobs = []
    for src in _build.SOURCES:
        text = src.read_text()
        for name, cut in {"full": None, **CUTS[src.name]}.items():
            variant = out / f"{src.stem}_{name.replace(' ', '_')}.cu"
            variant.write_text(text if cut is None else text.replace(cut[0], cut[1]))
            lib = variant.with_suffix(".so")
            proc = subprocess.Popen(_build.nvcc_command(nvcc, variant, lib),
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


def call_k1b(lib, feats, rois, batch_idx, level_idx, scales, pooled, grad_out):
    """K1b's wrapper with another library: maps and scratch from
    ``torch.empty``, the kernels."""
    n, f0 = len(feats), feats[0]
    grads = [torch.empty_like(f) for f in feats]
    zcap = max(f.shape[3] for f in feats)
    shape = (rois.shape[0], pooled, pooled, zcap, f0.shape[-1])
    plane_max = torch.empty(shape, dtype=f0.dtype, device=f0.device)
    plane_grad = torch.empty(shape, dtype=torch.float32, device=f0.device)
    err = lib.tpu3dsis_roi_pool3d_bwd(
        int(f0.dtype == torch.bfloat16), n, (ctypes.c_void_p * n)(*[f.data_ptr() for f in feats]),
        (ctypes.c_void_p * n)(*[g.data_ptr() for g in grads]),
        (ctypes.c_int * (3 * n))(*[d for f in feats for d in f.shape[1:4]]),
        (ctypes.c_float * n)(*[float(s) for s in scales]), f0.shape[0], f0.shape[-1], rois.data_ptr(),
        batch_idx.data_ptr(), level_idx.data_ptr(), rois.shape[0], pooled, grad_out.data_ptr(), plane_max.data_ptr(),
        plane_grad.data_ptr(), zcap, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "probe K1b")


def k1b_counts(lib, kw):
    """What the counting copy of K1b computes on one input (see the note at
    the top), and the ratios: column stagings per column, and row x-maxima
    the brick pass recomputes per row x-max of the column pass."""
    call_k1b(lib, **kw)
    out = (ctypes.c_longlong * 4)()
    _build.check(lib.tpu3dsis_roi_pool3d_bwd_counts(out), "probe K1b counts")
    columns, column_rows, stagings, brick_rows = list(out)
    return {"columns": columns, "column_pass_row_maxima": column_rows, "brick_pass_stagings": stagings,
            "brick_pass_row_maxima": brick_rows, "stagings_per_column": stagings / max(columns, 1),
            "brick_row_maxima_per_column_row_max": brick_rows / max(column_rows, 1)}


# Run in another checkout's root by against(): the device time in ms of a
# wrapper of that checkout on the saved inputs and the host's ms of a call,
# by this checkout's timers (``utils/profiling.py``, their source inlined, so
# that the other checkout's package is the one the wrapper comes from)
_TIMING = "\n".join(["import json, statistics, sys, time", "import torch", "",
                      *(inspect.getsource(f) for f in (profiling._require_cuda, profiling.device_ms,
                                                        profiling.host_ms))])

# K1b's whole wrapper, each case's device ms
_K1B_TIMER = _TIMING + r"""
from tpu3dsis_torch.ops.roi_pool3d import roi_pool3d_backward_cuda

out = {}
for case, kw in torch.load(sys.argv[1]).items():
    kw = {k: [t.cuda() for t in v] if k == "feats" else v.cuda() if torch.is_tensor(v) else v for k, v in kw.items()}
    out[case] = {"ms": device_ms(lambda: roi_pool3d_backward_cuda(**kw))}
print(json.dumps(out))
"""

# K3b's whole wrapper on a batch, each case's device ms, host ms and busy ms
# (the device's kernels, copies and memsets of a call, summed from
# torch.profiler: the device time however the host paces the calls): one
# call for the batch on the forward's operands where the checkout has the
# batched fusion, else one call a sample
_K3B_TIMER = _TIMING + r"""
from torch.profiler import ProfilerActivity, profile
from tpu3dsis_torch.geometry import projection as P

def busy_ms(fn):
    fn()
    for calls in (10, 100):  # as chip_smoke.k3b_kernel_split: 100 where 10 brought back no device event
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if us:
            return sum(us) / calls / 1e3
    return float("nan")

PER_SAMPLE = ("grad_out", "feats2d", "depths", "poses", "world_to_grid", "view_valid")
out = {}
for case, kw in torch.load(sys.argv[1]).items():
    kw = {k: v.cuda() if k in ("grad_out", "feats2d", "depths", "view_valid") else v for k, v in kw.items()}
    if hasattr(P, "fuse_views_batch"):
        if hasattr(P, "batch_operands"):
            ops = P.batch_operands(kw["poses"], kw["world_to_grid"], kw["view_valid"],
                                   *kw["feats2d"].shape[:2], kw["feats2d"].device)
            kw = dict(kw, **dict(zip(("mats", "view_valid", "rank", "margins"), ops)))  # an older checkout makes no margins
        call = lambda: P.fuse_views_backward_cuda(**kw)
    else:
        samples = [{k: v[i] if k in PER_SAMPLE else v for k, v in kw.items()} for i in range(kw["feats2d"].shape[0])]
        call = lambda: [P.fuse_views_backward_cuda(**one) for one in samples]
    out[case] = {"ms": device_ms(call), "host_ms": host_ms(call), "busy_ms": busy_ms(call)}
print(json.dumps(out))
"""


def against(cases, others, card, timer, what):
    """A whole wrapper of each checkout in `others` and of this one on the
    same inputs (`cases`, CPU tensors and plain values), run by `timer` in
    processes started in each checkout, in turns; one JSON line per case with
    each checkout's median of each number the timer reports."""
    here = str(Path(__file__).resolve().parents[1])
    saved = _build.BUILD_DIR / "probe" / "against_cases.pt"
    saved.parent.mkdir(parents=True, exist_ok=True)
    torch.save(cases, saved)
    times = {root: [] for root in [*others, here]}
    for root in [*others, here, here, *others[::-1]]:
        res = subprocess.run([sys.executable, "-c", timer, str(saved)], cwd=root, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"probe: the wrapper of {root} failed:\n{res.stderr[-4000:]}")
        times[root].append(json.loads(res.stdout.strip().splitlines()[-1]))
    for case in cases:
        line = {"case": f"{case}: {what}"}
        for metric in times[here][0][case]:
            line[metric] = {("this checkout" if root == here else root):
                            round(statistics.median(t[case][metric] for t in runs), 5) for root, runs in times.items()}
        print(json.dumps({**line, "card": card}), flush=True)


def zero_and_cast(feats):
    """Zeroed float32 maps and their cast to the maps' dtype: what a wrapper
    that sums the gradient in float32 maps pays around its kernel."""
    for f in feats:
        torch.zeros(f.shape, dtype=torch.float32, device=f.device).to(f.dtype)


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


def k3b_scratch(feats2d, volume_dims):
    """K3b's work list and its scratch (length and bitmap) for a batch."""
    n = feats2d.shape[0] * int(np.prod(volume_dims))
    return (torch.empty(n, dtype=torch.int32, device=feats2d.device),
            torch.empty(1 + (n + 31) // 32, dtype=torch.int32, device=feats2d.device))


def call_k3b(lib, grad, feats2d, depths, mats, margins, valid, rank, fx, fy, cx, cy, volume_dims, depth_min,
             depth_max, voxel_size, work=None, scratch=None):
    """This checkout's K3b on a batch: one call, the gradient from
    ``torch.empty`` (the kernel zeroes it), the work list and its scratch
    from the arguments or ``k3b_scratch``."""
    b, v, h, w, c = feats2d.shape
    out = torch.empty_like(feats2d)
    if work is None:
        work, scratch = k3b_scratch(feats2d, volume_dims)
    err = lib.tpu3dsis_fuse_views_bwd(b, grad.data_ptr(), feats2d.data_ptr(), depths.data_ptr(), mats.data_ptr(),
                                      margins.data_ptr(), valid.data_ptr(), rank.data_ptr(), v, h, w, c, *volume_dims, fx, fy, cx, cy,
                                      depth_min, depth_max, voxel_size, work.data_ptr(), scratch.data_ptr(),
                                      out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "probe K3b")
    return out


def k3b_counts(lib, kw):
    """What K3b's pass 1 lists on one input, counted from its list: the
    accepted voxels, and the most of them in one of K3's bricks, in one
    warp's slices of a brick (the chain of dependent walks of the per-sample
    design, which took them one at a time, twice) and in one slice; the
    bricks that hold any."""
    from tpu3dsis_torch.geometry.projection import BRICK

    work, scratch = k3b_scratch(kw["feats2d"], kw["volume_dims"])
    call_k3b(lib, **kw, work=work, scratch=scratch)
    n = int(scratch[0])
    x_, y_, z_ = (int(d) for d in kw["volume_dims"])
    e = work[:n].long()
    b, vox = e // (x_ * y_ * z_), e % (x_ * y_ * z_)
    x, y, z = vox // (y_ * z_), vox // z_ % y_, vox % z_
    nb = [-(-d // k) for d, k in zip((x_, y_, z_), BRICK)]
    brick = ((b * nb[0] + x // BRICK[0]) * nb[1] + y // BRICK[1]) * nb[2] + z // BRICK[2]
    slab = x % BRICK[0]

    def most(ids):
        return int(torch.bincount(ids).max()) if n else 0

    return {"accepted_voxels": n, "most_in_a_brick": most(brick), "most_in_a_warp": most(brick * _K3_WARPS
                                                                                       + slab % _K3_WARPS),
            "most_in_a_slice": most(brick * BRICK[0] + slab), "bricks_with_any": int(brick.unique().numel())}


def k3b_case_args(case):
    """The kernels' arguments of a batched K3b call given as
    ``fuse_views_backward_batch_plain``'s (``chip_smoke``'s cases): the
    matrices, flags and rank made on the card once, the intrinsics as
    floats."""
    from tpu3dsis_torch.geometry.projection import _intrinsic_floats, batch_operands

    feats = case["feats2d"]
    mats, valid, rank, margins = batch_operands(case["poses"], case["world_to_grid"], case.get("view_valid"),
                                                *feats.shape[:2], feats.device)
    fx, fy, cx, cy = _intrinsic_floats(case["intrinsic"])
    return dict(grad=case["grad_out"], feats2d=feats, depths=case["depths"], mats=mats, margins=margins, valid=valid,
                rank=rank,
                fx=fx, fy=fy, cx=cx, cy=cy, volume_dims=tuple(case["volume_dims"]), depth_min=case["depth_min"],
                depth_max=case["depth_max"], voxel_size=case["voxel_size"])


def k3b_inputs(cs, dev):
    """A batched K3b call on the training call's shapes: ``chip_smoke``'s
    trainable-ENet color batch (4 samples of 5 views of 32x41 depths,
    bench_train's cameras) into 96x48x96, random float32 features and
    cotangent (their values change the ties, not the work), as
    ``fuse_views_backward_batch_plain``'s arguments."""
    cfg = cs.enet_train_config()
    n = cs.TRAIN_BATCH["color"]
    batch = cs.train_batch(np.random.RandomState(7), n, cfg, color=True)
    g = torch.Generator().manual_seed(3)
    v = int(cfg.NUM_IMAGES)
    w, h = cfg.DEPTH_SHAPE
    return dict(grad_out=torch.randn((n, *cs.SHAPE, 128), generator=g).to(dev),
                feats2d=torch.randn((n, v, h, w, 128), generator=g).to(dev),
                depths=torch.from_numpy(batch["depths"]).to(dev), poses=batch["poses"],
                world_to_grid=batch["world_to_grid"], intrinsic=cfg.INTRINSIC, volume_dims=cs.SHAPE,
                depth_min=cfg.PROJ_DEPTH_MIN, depth_max=cfg.PROJ_DEPTH_MAX, voxel_size=cfg.VOXEL_SIZE,
                view_valid=torch.from_numpy(batch["view_valid"]).to(dev))


def k3_inputs(dev, cs):
    """K3's arguments for phase 7's 96-view room at its bucket (and the
    intrinsic matrix), features random (their values do not change the
    work), and the room's frames."""
    from tpu3dsis_torch.geometry.projection import view_matrices

    _, _, frames = cs.make_color_scene(np.random.RandomState(21), 96)
    cfg = cs.scannet_color_scene_config()
    k = cfg.INTRINSIC
    feats = torch.randn((96, 32, 41, 128), generator=torch.Generator().manual_seed(3)).to(dev)
    return feats, dict(depths=torch.from_numpy(frames["depths"]).to(dev),
                       mats=view_matrices(frames["poses"], frames["world_to_grid"]).to(dev),
                       valid=torch.ones(96, dtype=torch.uint8, device=dev), fx=k[0][0], fy=k[1][1], cx=k[0][2],
                       cy=k[1][2], volume_dims=cs.SCENE_EXTENT, depth_min=cfg.PROJ_DEPTH_MIN,
                       depth_max=cfg.PROJ_DEPTH_MAX, voxel_size=cfg.VOXEL_SIZE, intrinsic=k), frames


def in_turns(fns, iters, device_ms):
    names = list(fns)
    times = {k: [] for k in names}
    for k in names + names[::-1]:
        times[k].append(device_ms(fns[k], iters))
    return {k: round(statistics.median(v), 5) for k, v in times.items()}


def main(argv=()) -> int:
    argv, others = list(argv), []
    while "--against" in argv:
        at = argv.index("--against")
        if at + 1 == len(argv):
            print("probe: --against takes a directory", file=sys.stderr)
            return 2
        others.append(str(Path(argv.pop(at + 1)).resolve()))
        argv.pop(at)
    which = set(argv) or {"K1", "K1b", "K2", "K3", "K3b"}
    if not which <= {"K1", "K1b", "K2", "K3", "K3b"} or (others and not which & {"K1b", "K3b"}):
        print(f"probe: name K1, K1b, K2, K3 or K3b (K1b or K3b with --against), not {sorted(which)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs  # the inputs of the card's smoke run

    card = cs.nvidia_smi("name,power.limit")
    dev = torch.device("cuda:0")
    libs = build_cuts()
    if "K1" in which:
        probe_k1(cs, dev, libs, card)
    if "K1b" in which:
        probe_k1b(cs, dev, libs, card, others)
    if "K2" in which:
        probe_k2(cs, dev, libs, card)
    if "K3" in which:
        probe_k3(cs, dev, libs, card)
    if "K3b" in which:
        probe_k3b(cs, dev, libs, card, others)
    return 0


def probe_k1(cs, dev, libs, card):
    feats, k1, _ = cs.kernel_inputs(dev, np.random.RandomState(0))
    scenes, _ = cs.make_chunks(np.random.RandomState(1), cs.BATCH)
    x = torch.from_numpy(scenes).to(dev)
    cases = {}
    for (cfg, det) in cs.load_detectors(dev):
        name = cfg.TPU_COMPUTE_DTYPE
        cases[f"K1 {name}, phase 2's rois"] = (list(feats.to(det.compute_dtype).unbind(0)), k1)
        cases[f"K1 {name}, the main path's rois"] = cs.main_path_kernel_inputs(cfg, det, x)
    for case, (levels, kw) in cases.items():
        fns = {k: (lambda lib=lib: call_k1(lib, levels, **kw)) for k, lib in libs["roi_pool3d"].items()}
        print(json.dumps({"case": case, "ms": in_turns(fns, 20, profiling.device_ms), "card": card}), flush=True)


def k1b_inputs(dev, dtype=torch.bfloat16):
    """The training call's shapes: two (8, 24, 12, 24, 128) post-ReLU level
    maps, 16 rois a chunk of 4-40 voxels on either level, a random
    cotangent."""
    g = torch.Generator().manual_seed(0)
    feats = [torch.relu(torch.randn((8, 24, 12, 24, 128), generator=g)).to(dev, dtype) for _ in range(2)]
    rng = np.random.RandomState(0)
    lo = rng.uniform(0, 80, (128, 3)) * [1, 0.5, 1]
    rois = np.concatenate([lo, lo + rng.uniform(4, 40, (128, 3))], 1).astype(np.float32)
    return dict(feats=feats, rois=torch.from_numpy(rois).to(dev),
                batch_idx=torch.arange(8, dtype=torch.int32).repeat_interleave(16).to(dev),
                level_idx=torch.from_numpy(rng.randint(0, 2, 128).astype(np.int32)).to(dev), scales=[0.25, 0.25],
                pooled=4, grad_out=torch.randn((128, 128, 4, 4, 4), generator=g).to(dev, dtype))


def k1b_training_call(cs, dev):
    """K1b's arguments on a geometry training step (``chip_smoke``'s
    training config, batch 8, seeded weights), recorded from its second
    step."""
    from tpu3dsis_torch.config import scannet_train_config
    from tpu3dsis_torch.train.trainstep import build_train_step

    cfg = scannet_train_config(color=False)
    det = cs.train_detector(dev, cfg)
    opt_init, step = build_train_step(det, cfg, cs.SHAPE)
    opt = opt_init()
    batch = cs.train_batch(np.random.RandomState(7), cs.TRAIN_BATCH["geometry"], cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    step(opt, batch, generator=gen)
    with cs.recording_kernel_calls() as calls:
        step(opt, batch, generator=gen)
    torch.cuda.synchronize()
    return dict(next(args for kind, args in calls if kind == "roi_pool3d_backward_cuda"))


def probe_k1b(cs, dev, libs, card, others=()):
    feats, k1, _ = cs.kernel_inputs(dev, np.random.RandomState(0))
    step_call = k1b_training_call(cs, dev)
    cases = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        m = step_call["rois"].shape[0]
        cases[f"K1b {name}, a geometry training step's call (2 x 8x24x12x24x128, {m} rois)"] = {
            k: [f.to(dt) for f in v] if k == "feats" else v.to(dt) if k == "grad_out" else v
            for k, v in step_call.items()}
        cases[f"K1b {name}, the training call's shapes (2 x 8x24x12x24x128, 128 rois)"] = k1b_inputs(dev, dt)
        cot = torch.randn((k1["rois"].shape[0], 128, 4, 4, 4), generator=torch.Generator().manual_seed(4))
        cases[f"K1b {name}, phase 2's rois (2 x 32x24x12x24x128, 6400 rois)"] = dict(
            feats=list(feats.to(dt).unbind(0)), **k1, grad_out=cot.to(dev, dt))
    copies = dict(libs["roi_pool3d_bwd"])
    counting = copies.pop(COUNTING)
    for case, kw in cases.items():
        fns = {k: (lambda lib=lib: call_k1b(lib, **kw)) for k, lib in copies.items()}
        fns["float32 zero and cast alone"] = lambda: zero_and_cast(kw["feats"])
        print(json.dumps({"case": case, "ms": in_turns(fns, 20, profiling.device_ms), "counts": k1b_counts(counting, kw),
                          "card": card}), flush=True)
    if others:
        saved = {case: {k: [t.cpu() for t in v] if k == "feats" else v.cpu() if torch.is_tensor(v) else v
                        for k, v in kw.items()} for case, kw in cases.items()}
        against(saved, list(others), card, _K1B_TIMER, "the whole wrapper")


def probe_k2(cs, dev, libs, card):
    _, _, k2 = cs.kernel_inputs(dev, np.random.RandomState(0))
    k2_cases = {400: k2, 1024: {k: v.to(dev) for k, v in cs._boxes(np.random.RandomState(2), cs.BATCH, 1024).items()}}
    for n, bx in k2_cases.items():
        fns = {k: (lambda lib=lib: call_k2(lib, bx["boxes"], bx["valid"], 0.1))
               for k, lib in libs["nms3d"].items()}
        print(json.dumps({"case": f"K2 32x{n} boxes, thresh 0.1", "ms": in_turns(fns, 50, profiling.device_ms),
                          "card": card}), flush=True)


def probe_k3(cs, dev, libs, card):
    from tpu3dsis_torch.geometry.projection import brick_view_candidates_plain

    feats, k3, frames = k3_inputs(dev, cs)
    keep = brick_view_candidates_plain(k3["depths"], frames["poses"], frames["world_to_grid"], k3["intrinsic"],
                                       k3["volume_dims"], k3["depth_min"], k3["depth_max"], k3["voxel_size"])
    args = {key: val for key, val in k3.items() if key != "intrinsic"}
    for dt in (torch.bfloat16, torch.float32):
        f = feats.to(dt)
        fns = {k: (lambda lib=lib: call_k3(lib, f, **args)) for k, lib in libs["fuse_views"].items()}
        print(json.dumps({"case": f"K3 {str(dt).split('.')[-1]}, 96 views into {cs.SCENE_EXTENT} x 128",
                          "ms": in_turns(fns, 10, profiling.device_ms), "cull_kept_share": float(keep.float().mean()),
                          "card": card}), flush=True)


def probe_k3b(cs, dev, libs, card, others=()):
    cases = {f"K3b float32, the training call's shapes: 4 samples x 5 views from {cs.SHAPE} x 128":
             k3b_inputs(cs, dev),
             f"K3b float32, a 32-view room (phase 10's) into {cs.SCENE_EXTENT} x 128":
             cs.k3b_room_case(dev, np.random.RandomState(10))}
    copies = libs["fuse_views_bwd"]
    for case, plain in cases.items():
        kw = k3b_case_args(plain)
        # "pass 2 only" reads the list that a whole call left in its own buffers
        work, scratch = k3b_scratch(kw["feats2d"], kw["volume_dims"])
        call_k3b(copies["full"], **kw, work=work, scratch=scratch)
        fns = {k: (lambda lib=lib: call_k3b(lib, **kw)) for k, lib in copies.items()}
        fns["pass 2 only"] = lambda: call_k3b(copies["pass 2 only"], **kw, work=work, scratch=scratch)
        print(json.dumps({"case": case, "ms": in_turns(fns, 20, profiling.device_ms),
                          "counts": k3b_counts(copies["full"], kw), "card": card}), flush=True)
    if others:
        saved = {case: {k: torch.as_tensor(v).cpu() if k in ("poses", "world_to_grid") or torch.is_tensor(v)
                        else v for k, v in plain.items()} for case, plain in cases.items()}
        against(saved, list(others), card, _K3B_TIMER, "the whole wrapper, one call a batch or one a sample")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
