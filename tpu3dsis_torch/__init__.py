"""tpu3dsis_torch: the PyTorch and CUDA port of ``tpu3dsis`` for NVIDIA Hopper.

The JAX package ``tpu3dsis`` is the reference; this package follows it module
for module. It imports ``torch`` and never ``jax``. The hand-written CUDA
kernels (``csrc/``) are built at first use (``_build.py``). So far it covers
geometry-only chunk detection (``Detector``, ``build_inference_fn``) and
whole-scene geometry inference with instance masks (``SceneInference``), on
the CUDA card unless the caller asks for the CPU (``device="cpu"``).
"""

from tpu3dsis_torch.checkpoint import load_jax_params
from tpu3dsis_torch.config import DetectorConfig, ProposalConfig, scannet_chunk_config, scannet_scene_config
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
    "scannet_scene_config",
]
