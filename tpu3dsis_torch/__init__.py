"""tpu3dsis_torch: the PyTorch and CUDA port of ``tpu3dsis`` for NVIDIA Hopper.

The JAX package ``tpu3dsis`` is the reference; this package follows it module
for module. It imports ``torch`` and never ``jax``. The hand-written CUDA
kernels (``csrc/``) are built at first use (``_build.py``). It covers
chunk detection (``Detector``, ``build_inference_fn``), whole-scene
inference with instance masks (``SceneInference``), geometry-only or with
the color stream (ENet, view fusion), and the test and benchmark drivers
over ``.scene`` files (``python -m tpu3dsis_torch.main``,
``infer/driver.py::run_scenes``), and training, on the CUDA card unless
the caller asks for the CPU (``device="cpu"``); over several cards,
data-parallel training, tile-parallel scenes and the X-sharded single-shot
scene (``parallel/``). Its own datagen (``datagen/``, numpy on the host)
writes generated scenes, frames and chunks to disk, which the demo and the
closed color loop (``python -m tpu3dsis_torch.tools.demo | color_loop``)
train and test on.
"""

from tpu3dsis_torch.checkpoint import load_jax_params
from tpu3dsis_torch.config import (DetectorConfig, ProposalConfig, scannet_chunk_config, scannet_color_scene_config,
                                   scannet_scene_config)
from tpu3dsis_torch.infer.tiling import SceneInference
from tpu3dsis_torch.models.detector import Detector, build_inference_fn

__all__ = [
    "Detector",
    "DetectorConfig",
    "ProposalConfig",
    "SceneInference",
    "build_inference_fn",
    "load_jax_params",
    "scannet_chunk_config",
    "scannet_color_scene_config",
    "scannet_scene_config",
]
