"""The port's training with the ENet trained and on SUNCG, against the JAX package's, on the CPU.

``tests/test_torch_train.py``'s three-step tests on two more of its cases:
the ENet trained through the view fusion (``FIX_ENET: False``: 2 views of
40x32 uint8 images; the ENet's weights, PReLU slopes and BatchNorm
statistics held with the rest, within 1e-4 of their magnitude) and the
SUNCG backbone with the color stream; and a check that the ENet case's
comparison is well conditioned. They live in a module of their own so
that a test worker of its own takes their JAX compiles.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_train import (STEPS, SHAPE, _three_steps, anchor_count, build_train_step, jax_step_draws,
                              make_batch, test_three_steps_match_jax_metrics, test_three_steps_match_jax_params,
                              tiny_cfg)

from tpu3dsis_torch import checkpoint as ckpt
from tpu3dsis_torch.config import DetectorConfig, default_config
from tpu3dsis_torch.models.detector import Detector

# the three-step tests above run here on these cases
__all__ = ["test_three_steps_match_jax_metrics", "test_three_steps_match_jax_params"]


@pytest.fixture(scope="module", params=["enet", "suncg"])
def three_steps(request):
    """Both packages' metrics over three steps, and their final params."""
    return _three_steps(request.param)


def test_enet_case_is_well_conditioned(monkeypatch):
    """The enet case's comparison is well posed: noise of 1e-6 of each ENet
    feature (the size of the two frameworks' float32 differences in the
    ENet) moves the port's parameters after the case's three steps by
    under 1e-5 of their magnitude, ten times inside the 1e-4 the comparison
    holds, so no ReLU of the 3D streams sits at its kink for these inputs."""
    from tpu3dsis_torch.models.color import ColorProjector

    base = _three_steps("enet")[3]
    cfg = tiny_cfg(default_config(), enet=True)
    det = Detector(DetectorConfig.from_cfg(cfg), device="cpu", param_dtype=torch.float32)
    det.init_params(torch.Generator().manual_seed(0))
    features, g = ColorProjector.image_features, torch.Generator().manual_seed(1)

    def noisy_features(self, images):
        f = features(self, images)
        return f * (1 + 1e-6 * torch.randn(f.shape, generator=g))

    monkeypatch.setattr(ColorProjector, "image_features", noisy_features)
    opt_init, step = build_train_step(det, cfg, SHAPE)
    opt = opt_init()
    n_anchor = anchor_count(det, SHAPE)
    for i in range(STEPS):
        step(opt, make_batch(i, True, True), draws=jax_step_draws(jax.random.PRNGKey(10 + i), n_anchor, 8 + 4))
    noisy = ckpt.module_params(det)
    assert max(np.abs(noisy[k] - v).max() / np.abs(v).max() for k, v in base.items()) < 1e-5


