"""The port's training without the RPN (``USE_RPN: False``), against the JAX package's, on the CPU.

``tests/test_torch_train.py``'s three-step tests on one more case, in one
step: no RPN parameters, the gt boxes as the proposals (the JAX step's
ablation, ``tpu3dsis/train/trainstep.py:261-275``). The parameter set and
its checkpoints are the JAX package's; what the JAX package cannot run
with this setting (serving, so validation and the scene drivers) and level
3 (which it has no feature map for) raise with the reason. It lives in a
module of its own so that a test worker of its own takes its JAX compile.
"""

import numpy as np
import pytest
import torch
from test_torch_scene import _numpy_params
from test_torch_train import SHAPE, _three_steps, test_three_steps_match_jax_metrics, test_three_steps_match_jax_params
from test_torch_train import tiny_cfg

from tpu3dsis.config import default_config as jax_default_config
from tpu3dsis.models import Detector as JaxDetector
from tpu3dsis.train import checkpoint as jax_ckpt
from tpu3dsis_torch import checkpoint as ckpt
from tpu3dsis_torch.config import DetectorConfig, default_config
from tpu3dsis_torch.infer.tiling import SceneInference
from tpu3dsis_torch.infer.validate import ChunkValidator
from tpu3dsis_torch.models.detector import Detector, build_inference_fn
from tpu3dsis_torch.parallel.scene import spatial_single_shot

# the three-step tests above run here on this case
__all__ = ["test_three_steps_match_jax_metrics", "test_three_steps_match_jax_params"]


@pytest.fixture(scope="module", params=["no_rpn"])
def three_steps(request):
    """Both packages' metrics over one step, and their final params."""
    return _three_steps(request.param)


def test_no_rpn_parameters_and_checkpoints_are_the_jax_packages():
    """No ``rpn_*`` parameter: the names are the JAX detector's under the
    same config, its param dict loads strictly, and ``partial_update`` of a
    checkpoint that has the RPN takes what the JAX package's takes."""
    jcfg, tcfg = tiny_cfg(jax_default_config(), no_rpn=True), tiny_cfg(default_config(), no_rpn=True)
    jdet = JaxDetector(jcfg, anchor_dir="experiments/anchors")
    det = Detector(DetectorConfig.from_cfg(tcfg), device="cpu", param_dtype=torch.float32)
    names = jdet.param_names()
    assert set(ckpt.module_params(det)) == set(names) and not any("rpn" in k for k in names)
    params = _numpy_params(jdet, 3)
    ckpt.load_jax_params(det, params)
    assert all(np.array_equal(v, params[k]) for k, v in ckpt.module_params(det).items())
    full = _numpy_params(JaxDetector(tiny_cfg(jax_default_config()), anchor_dir="experiments/anchors"), 4)
    assert any("rpn" in k for k in full)
    want = jax_ckpt.partial_update(params, full, jcfg)
    got = ckpt.partial_update(ckpt.module_params(det), full, tcfg)
    assert set(got) == set(want) and all(np.array_equal(got[k], np.asarray(want[k])) for k in want)


def test_no_rpn_serving_and_level3_raise_with_the_reason():
    cfg = tiny_cfg(default_config(), no_rpn=True)
    dcfg = DetectorConfig.from_cfg(cfg)
    det = Detector(dcfg, device="cpu")
    for build in (lambda: build_inference_fn(det, dcfg, SHAPE), lambda: ChunkValidator(det, cfg, SHAPE),
                  lambda: SceneInference(det, dcfg),
                  lambda: spatial_single_shot(det, dcfg, np.zeros((*SHAPE, 2), np.float32), ["cpu"])):
        with pytest.raises(NotImplementedError, match="USE_RPN=False serves no proposals"):
            build()
    level3 = tiny_cfg(default_config())
    level3.update(NUM_ANCHORS_LEVEL3=3, ANCHORS_TYPE_LEVEL3="scannet14_3.txt")
    with pytest.raises(NotImplementedError, match="no level-3 feature map"):
        Detector(DetectorConfig.from_cfg(level3), device="cpu")
