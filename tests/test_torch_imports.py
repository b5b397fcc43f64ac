"""The port's path imports no JAX, YAML, PIL or JAX package; the probe's cuts
still fit the kernel sources; its kernels on the card."""

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
    """K1 and K2 against their plain versions, on CUDA tensors (run on a
    machine with an NVIDIA card and nvcc: ``python -m pytest -m gpu``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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
