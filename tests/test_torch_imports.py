"""The port's paths (chunk, scene, color scene with the mask FCN's color
branch, the test and benchmark drivers, the benchmark export, training and
their entry module, the device-list scene and the sharded single-shot scene;
the datagen, the demo, the color loop, the PLY views, the native decoder
and the two small models) import no JAX, YAML, PIL or JAX
package (nor ``ml_dtypes``, in training; PIL only where frames are written
or read); the probe's cuts still fit the kernel sources; its kernels on the
card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TINY_FORWARD = """
import sys
import numpy as np
import torch
import tpu3dsis_torch as tt

cfg = tt.scannet_chunk_config()
det = tt.Detector(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
scene = np.random.RandomState(0).randn(1, 16, 16, 16, 2).astype(np.float32)
out = tt.build_inference_fn(det, cfg, (16, 16, 16))(torch.from_numpy(scene))
assert out["valid"].shape == (200,) and torch.isfinite(out["pred_box"]).all()
# the scene path: tiles, class-aware stitch, window plans, mask FCN
cfg = tt.scannet_scene_config().replace(
    TPU_TILE_SIZE=(16, 16, 16), TPU_TILE_STRIDE=(12, 12, 12), TPU_MASK_INFER_CANVAS=(16, 16, 16),
    TPU_MASK_INFER_CANVAS_SMALL=(8, 8, 8), TEST=tt.ProposalConfig(16, 4, 0.1), CLASS_THRESH=0.0)
det = tt.Detector(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
si = tt.SceneInference(det, cfg)
boxes, masks = si.infer(np.random.RandomState(1).randn(20, 16, 20, 2).astype(np.float32))
assert si.last_fused and len(masks) == len(boxes["pred_box"]) > 0
# several devices: tile batches and mask windows split over a device list, the sharded single-shot scene
from tpu3dsis_torch.parallel import distributed
from tpu3dsis_torch.parallel.scene import spatial_single_shot
boxes, masks = tt.SceneInference(det, cfg, tile_batch=2, mesh=["cpu", "cpu"]).infer(
    np.random.RandomState(1).randn(20, 16, 20, 2).astype(np.float32))
assert len(masks) == len(boxes["pred_box"]) > 0
assert spatial_single_shot(det, cfg, np.random.RandomState(1).randn(20, 16, 20, 2).astype(np.float32),
                           ["cpu", "cpu"])["pred_box"].shape[1] == 6
# the color scene path: uint8 images -> ENet -> view fusion -> the resident
# volume the tiles and, with the mask FCN's color branch, the mask windows
# crop (images 32x40, so 2D features and depths are 4x5)
f = 6.0
cfg = tt.scannet_color_scene_config().replace(
    MASK_USE_IMAGES=True, TPU_COMPUTE_DTYPE="float32", TPU_TILE_SIZE=(16, 16, 16), TPU_TILE_STRIDE=(12, 12, 12),
    TPU_MASK_INFER_CANVAS=(16, 16, 16), TPU_MASK_INFER_CANVAS_SMALL=(8, 8, 8), TEST=tt.ProposalConfig(16, 4, 0.1),
    CLASS_THRESH=0.0, IMAGE_SHAPE=(40, 32), DEPTH_SHAPE=(5, 4), VOXEL_SIZE=0.25,
    INTRINSIC=((f, 0.0, 2.5, 0.0), (0.0, f, 2.0, 0.0), (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0)))
det = tt.Detector(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
rng = np.random.RandomState(2)
poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
poses[:, :3, 3] = [[2.5, 2.0, -1.0], [2.0, 2.5, -1.5], [3.0, 2.0, -2.0]]
frames = {"images": rng.randint(0, 256, (3, 32, 40, 3)).astype(np.uint8),
          "depths": rng.uniform(1.0, 3.5, (3, 4, 5)).astype(np.float32), "poses": poses,
          "world_to_grid": np.diag([4.0, 4.0, 4.0, 1.0]).astype(np.float32)}
si = tt.SceneInference(det, cfg)
boxes, masks = si.infer(np.random.RandomState(3).randn(20, 16, 20, 2).astype(np.float32), frames)
assert si.last_fused and len(masks) == len(boxes["pred_box"])
print(" ".join(m for m in sys.modules
               if m in ("jax", "jaxlib", "yaml", "PIL", "tpu3dsis") or m.startswith("tpu3dsis.")))
"""


def test_port_imports_no_jax_yaml_or_pil():
    """Nor any module of the JAX package: the port keeps its own copies."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _TINY_FORWARD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"imported: {res.stdout.strip()}"


_TINY_DRIVERS = """
import os, sys, tempfile
import numpy as np
from tpu3dsis_torch import main, yaml_subset
from tpu3dsis_torch.eval import DetectionMAP, gt_export, scannet_benchmark
from tpu3dsis_torch.infer import driver, single_shot
from tpu3dsis_torch.tools import evaluate_benchmark, export_gt, ply, proj_label, vox2mesh
from tpu3dsis_torch.io import SceneDataset, chunk_format, dataset, frames
from tpu3dsis_torch.io import write_chunk_file

tmp = tempfile.mkdtemp()
rng = np.random.RandomState(0)
path = os.path.join(tmp, "scene0000_00.scene")
write_chunk_file(path, rng.randn(20, 16, 20).astype(np.float32), np.array([[2, 2, 2, 8, 8, 8]], np.float32),
                 np.array([5], np.uint32), [np.ones((6, 6, 6), np.uint16)], np.ones(1, np.float32),
                 np.eye(4, dtype=np.float32), np.zeros(0, np.uint32))
with open(os.path.join(tmp, "list.txt"), "w") as f:
    f.write(path + "\\n")
with open("experiments/cfgs/ScanNet/benchmark.yml") as f:
    cfg = yaml_subset.load(f.read())
cfg.update(USE_IMAGES=False, TPU_TILE_SIZE=[16, 16, 16], TPU_TILE_STRIDE=[12, 12, 12], CLASS_THRESH=0.0,
           TPU_MASK_INFER_CANVAS=[16, 16, 16], TPU_MASK_INFER_CANVAS_SMALL=[8, 8, 8],
           TEST_FILELIST=os.path.join(tmp, "list.txt"), TEST_SAVE_DIR=os.path.join(tmp, "out"))
cfg["TEST"].update(RPN_PRE_NMS_TOP_N=16, RPN_POST_NMS_TOP_N=4)
with open(os.path.join(tmp, "tiny.yml"), "w") as f:
    f.write(yaml_subset.dump(cfg))
for mode in ("test", "benchmark"):
    main.main(["--cfg", os.path.join(tmp, "tiny"), "--mode", mode, "--device", "cpu", "--output_dir", tmp])
assert sorted(os.listdir(os.path.join(tmp, "out", "scene0000_00")))[0] == "gt_box.npy"
print("MODULES", " ".join(m for m in sys.modules
                          if m in ("jax", "jaxlib", "yaml", "PIL") or m.startswith(("tpu3dsis.", "PIL."))
                          or m == "tpu3dsis"))
"""


def test_drivers_import_no_jax_yaml_or_pil():
    """The entry module in test and benchmark mode on a tiny geometry scene
    (no frames on disk, so no PIL either), and the benchmark export's
    modules and entries."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _TINY_DRIVERS], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    line = [l for l in res.stdout.splitlines() if l.startswith("MODULES")]
    assert line == ["MODULES "], f"imported: {line}"


_TINY_DATAGEN = """
import os, sys, tempfile
import numpy as np
from tpu3dsis_torch.datagen import (marching_tets, mesh_render, prepare_2d, scene_sampler, synthetic_color,
                                    tsdf_fusion, virtual_scan)
from tpu3dsis_torch.models import autoencoder2d, coord_conv3d
from tpu3dsis_torch.runtime import native
from tpu3dsis_torch.tools import color_loop, demo, visualization, visualize, visualize_benchmark
from tpu3dsis_torch.utils import profiling, provenance, timer
from tpu3dsis_torch.io import SceneDataset
from tpu3dsis_torch.io.pipeline import PrefetchLoader

def modules():
    return " ".join(m for m in sys.modules if m in ("jax", "jaxlib", "yaml", "PIL") or m.startswith(("tpu3dsis.", "PIL."))
                    or m == "tpu3dsis")

tmp = tempfile.mkdtemp()
# the demo's fusion, .scene export and mesh; marching tets; a chunk through the native decoder and the loader
scene = demo.fuse_demo_scene(tmp)
cfg = demo.demo_config(tmp, scene)
visualization.visualize_chunk(scene, os.path.join(tmp, "vis"), cfg)
verts, faces, sem, inst, cols, objects = synthetic_color.room_mesh(np.random.RandomState(0), (3.0, 2.2, 3.0), 3)
grid, w2g, traj = virtual_scan.virtual_scan(verts, faces, sem, inst, voxel_size=0.2, width=16, height=12, max_views=6)
marching_tets.grid_to_mesh(grid)
chunks = scene_sampler.process_scene_chunks(os.path.join(tmp, "demo.scsdf"), os.path.join(tmp, "demo.aabbs"),
                                            os.path.join(tmp, "c_"), chunk_dim=(32, 32, 32), sample_factor=32,
                                            rotate90=False, require_images=False)
with open(os.path.join(tmp, "list.txt"), "w") as f:
    f.write("".join(c + "\\n" for c in chunks))
cfg.update(KEEP_THRESH=0.0, TPU_MAX_GT=4, LABEL_MAP="experiments/labelmaps/nyu40labels_scannet.csv")
assert len(list(PrefetchLoader(SceneDataset(os.path.join(tmp, "list.txt"), "chunk", cfg), cfg, 1))) == len(chunks) > 0
color_loop.build_cfg(os.path.join(tmp, "frames_square"))
print("GEOMETRY", modules())
# frames on disk: PIL, and only PIL
synthetic_color.generate_scene(np.random.RandomState(0), tmp, "s0", extent_m=(3.0, 2.2, 3.0), n_objects=2,
                               voxel_size=0.2, image_wh=(16, 12), max_views=4, traj_wh=(16, 12), chunks=False)
print("FRAMES", modules())
"""


def test_datagen_demo_and_color_loop_import_no_jax_or_yaml():
    """The datagen, the demo's and the color loop's modules, the PLY views,
    the native decoder and the two small models import no JAX, YAML or JAX
    package; PIL only once frames are written."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _TINY_DATAGEN], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    lines = [l for l in res.stdout.splitlines() if l.startswith(("GEOMETRY", "FRAMES"))]
    assert lines[0] == "GEOMETRY ", f"imported: {lines}"
    assert lines[1].split()[0] == "FRAMES" and "PIL" in lines[1].split()
    assert not any(m in ("jax", "jaxlib", "yaml", "tpu3dsis") or m.startswith("tpu3dsis.") for m in lines[1].split())


_TINY_TRAIN = """
import os, sys, tempfile
import numpy as np
sys.modules["torch.utils.tensorboard"] = None  # TensorBoard imports TensorFlow where installed, and it JAX
from tpu3dsis_torch import main, yaml_subset
from tpu3dsis_torch.io import write_chunk_file
from tpu3dsis_torch.infer import validate
from tpu3dsis_torch.io import pipeline
from tpu3dsis_torch.train import loop, losses, solver, targets, trainstep
from tpu3dsis_torch.utils import logger

tmp = tempfile.mkdtemp()
rng = np.random.RandomState(0)
paths = []
for i in range(2):
    sdf = (rng.randn(32, 16, 32) * 2).astype(np.float32)
    sdf[4:12, 3:10, 5:13] = 0.2
    paths.append(os.path.join(tmp, f"s{i}__0__.chunk"))
    write_chunk_file(paths[-1], sdf, np.array([[4, 3, 5, 12, 10, 13]], np.float64), np.array([5], np.uint32),
                     [np.ones((8, 7, 8), np.uint16)], np.ones(1, np.float32), np.eye(4, dtype=np.float32),
                     np.zeros(0, np.uint32))
with open(os.path.join(tmp, "list.txt"), "w") as f:
    f.write("".join(p + "\\n" for p in paths))
with open("experiments/cfgs/ScanNet/tiny_ci.yml") as f:
    cfg = yaml_subset.load(f.read())
cfg.update(TRAIN_FILELIST=os.path.join(tmp, "list.txt"), VAL_FILELIST=os.path.join(tmp, "list.txt"), VAL_TIME=1e-9,
           TPU_MASK_CANVAS=[16, 16, 16], TEST_SAVE_DIR=os.path.join(tmp, "out"))
with open(os.path.join(tmp, "tiny.yml"), "w") as f:
    f.write(yaml_subset.dump(cfg))
args = ["--cfg", os.path.join(tmp, "tiny"), "--mode", "train", "--device", "cpu", "--output_dir", tmp, "--max_steps", "2"]
assert main.main(args) == {"step": 2}
assert sorted(os.listdir(os.path.join(tmp, "tiny", "checkpoints")))[-1] == "step_2.npz"
print("MODULES", " ".join(m for m in sys.modules
                          if m in ("jax", "jaxlib", "yaml", "PIL", "ml_dtypes") or m.startswith(("tpu3dsis.", "PIL."))
                          or m == "tpu3dsis"))
"""


def test_training_imports_no_jax_yaml_pil_or_ml_dtypes():
    """The entry module's train mode on two tiny chunks, validation
    included (VAL_TIME passes at once), and every training module."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _TINY_TRAIN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    line = [l for l in res.stdout.splitlines() if l.startswith("MODULES")]
    assert line == ["MODULES "], f"imported: {line}"


def test_probe_cuts_match_the_kernel_sources():
    """Each phase the probe cuts out of a kernel is found, once, in its
    source, so a kernel edit cannot leave the probe timing a stale cut."""
    from tpu3dsis_torch import _build, probe

    for src in _build.SOURCES:
        text = src.read_text()
        assert probe.CUTS[src.name]
        for name, (anchor, _) in probe.CUTS[src.name].items():
            assert text.count(anchor) == 1, f"{src.name}: {name}"


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card():
    """K1, K1b, K2, K3 and K3b against their plain versions, on CUDA tensors (run on a
    machine with an NVIDIA card and nvcc: ``python -m pytest -m gpu``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu3dsis_torch.geometry import projection
    from tpu3dsis_torch.ops import nms, roi_pool3d as rp

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    levels = [rng.randn(3, 24, 12, 24, 128), rng.randn(3, 12, 6, 12, 128)]
    lo = rng.uniform(-10, 90, (300, 3))
    rois = torch.from_numpy(np.concatenate([lo, lo + rng.uniform(0, 60, (300, 3))], 1).astype(np.float32)).to(dev)
    bidx = torch.from_numpy(rng.randint(0, 3, 300).astype(np.int32)).to(dev)
    lidx = torch.from_numpy(rng.randint(0, 2, 300).astype(np.int32)).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        f = [torch.from_numpy(x.astype(np.float32)).to(dev, dt) for x in levels]
        got = rp.roi_pool3d_cuda(f, rois, bidx, lidx, [0.25, 0.125], 4)
        want = rp.roi_pool3d_plain(f, rois, bidx, lidx, [0.25, 0.125], 4)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        # K1b: float32 within 1e-6 of the largest gradient (the order of the sums), bf16 within
        # one ulp; two launches bit for bit (one fixed order, no atomics)
        g = torch.from_numpy(rng.randn(300, 128, 4, 4, 4).astype(np.float32)).to(dev, dt)
        got = rp.roi_pool3d_backward_cuda(f, rois, bidx, lidx, [0.25, 0.125], 4, g)
        again = rp.roi_pool3d_backward_cuda(f, rois, bidx, lidx, [0.25, 0.125], 4, g)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for a, w in zip(got, rp.roi_pool3d_backward_plain(f, rois, bidx, lidx, [0.25, 0.125], 4, g)):
            a, w = a.float(), w.float()
            if dt == torch.float32:
                assert (a - w).abs().max() <= 1e-6 * w.abs().max()
            else:
                ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(a.abs(), w.abs()).clamp(min=1e-30))) - 7)
                assert bool(((a - w).abs() <= ulp).all())

    for n in (400, 1024):
        lo = rng.uniform(0, 60, (4, n, 3))
        boxes = torch.from_numpy(np.concatenate([lo, lo + rng.uniform(1, 20, (4, n, 3))], -1).astype(np.float32)).to(dev)
        valid = torch.from_numpy(rng.rand(4, n) > 0.1).to(dev)
        classes = torch.from_numpy(rng.randint(1, 19, (4, n)).astype(np.int32)).to(dev)
        for thresh in (0.1, 0.5):
            got = nms.nms3d_cuda(boxes, thresh, valid)
            torch.cuda.synchronize()
            assert torch.equal(got, nms.nms_mask_plain(boxes, thresh, valid))
        for thresh in (0.1, 0.25):  # class-aware, as the scene stitch runs it
            got = nms.nms3d_cuda(boxes, thresh, valid, classes)
            torch.cuda.synchronize()
            assert torch.equal(got, nms.nms_mask_plain(boxes, thresh, valid, classes))

    # K3: 12 views looking into a 40^3 grid of 0.1 m voxels, two invalid
    intrinsic = np.array([[28.0, 0, 20.5, 0], [0, 28.0, 16.0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (12, 1, 1))
    poses[:, :3, 3] = np.stack([rng.uniform(1, 3, 12), rng.uniform(1, 3, 12), rng.uniform(-3, -1, 12)], 1)
    w2g = np.diag([10.0, 10.0, 10.0, 1.0]).astype(np.float32)
    depths = torch.from_numpy(rng.uniform(1.0, 6.0, (12, 32, 41)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(np.arange(12) % 5 != 1).to(dev)
    feats = torch.from_numpy(rng.randn(12, 32, 41, 128).astype(np.float32)).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        for zero_floor in (None, True):
            args = (feats.to(dt), depths, poses, w2g, intrinsic, (40, 40, 40), 0.1, 4.0, 0.1, valid, zero_floor)
            got = projection.fuse_views_cuda(*args)
            torch.cuda.synchronize()
            want = projection.fuse_views_plain(*args)
            assert bool((want != 0).any()) and torch.equal(got, want)
    # K3b on the same views, float32, a batch of two samples (the second with other valid views):
    # within 1e-5 of the largest gradient (a pixel's shares are summed by float32 atomics, in
    # another order than the plain version's)
    g = torch.from_numpy(rng.randn(2, 40, 40, 40, 128).astype(np.float32)).to(dev)
    valid2 = torch.stack([valid, torch.from_numpy(np.arange(12) % 3 != 0).to(dev)])
    args = (g, torch.stack([feats, feats.flip(0)]), torch.stack([depths, depths.flip(0)]),
            np.stack([poses, poses[::-1]]), np.stack([w2g, w2g]), intrinsic, (40, 40, 40), 0.1, 4.0, 0.1, valid2)
    got = projection.fuse_views_backward_cuda(*args)
    torch.cuda.synchronize()
    want = projection.fuse_views_backward_batch_plain(*args)
    assert bool((want[1] != 0).any()) and (got - want).abs().max() <= 1e-5 * want.abs().max()
