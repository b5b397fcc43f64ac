"""The port's training with the mask FCN's color branch, and its non-finite guard, against the JAX package's, on the CPU.

``tests/test_torch_train.py``'s three-step tests on one more case, in one
step: the ENet trained through the view fusion (``FIX_ENET: False``) with
the mask FCN's color branch (``MASK_USE_IMAGES``), so that the fused
volume's gradient is the sum of the backbone's color stream's and the mask
windows' crops'. Its ENet starts from the trained color fixture's, as a
shipped config's ``PRETRAINED_ENET_PATH`` has it: from a fresh ENet the
BatchNorm biases and means are their gradients alone after a step, sums
that cancel to about 1e-7, where the JAX package's float32 gradient was 8%
off the port's float64 one and the port's float32 gradient within 1e-5 of
it. It lives in a module of its own so that a test worker of its own takes
its JAX compile. And the non-finite guard on a step whose only non-finite gradient
is a frozen layer's: the JAX package's guard skips it, and so does the
port's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (SHAPE, _three_steps, anchor_count, build_train_step, jax_step_draws, make_batch,
                              test_three_steps_match_jax_metrics, test_three_steps_match_jax_params, tiny_cfg)

from tpu3dsis.config import default_config as jax_default_config
from tpu3dsis.train import solver as jax_solver
from tpu3dsis.train.trainstep import TrainState
from tpu3dsis.train.trainstep import apply_step_update as jax_apply_step_update
from tpu3dsis_torch import checkpoint as ckpt
from tpu3dsis_torch.config import DetectorConfig, default_config
from tpu3dsis_torch.models.detector import Detector
from tpu3dsis_torch.train.trainstep import build_loss_fn

# the three-step tests above run here on this case
__all__ = ["test_three_steps_match_jax_metrics", "test_three_steps_match_jax_params"]


@pytest.fixture(scope="module", params=["mask_color"])
def three_steps(request):
    """Both packages' metrics over one step, and their final params."""
    return _three_steps(request.param)


def test_nonfinite_guard_reads_frozen_gradients():
    """A step whose loss and trainable gradients are finite, and whose only
    non-finite gradient is a frozen layer's: the backbone frozen
    (``FIX_BACKBONE``) under trained RPN and class losses, which flow back
    through it; one voxel of the chunk +inf, and the frozen first conv's
    weights on that voxel's channel and tap negative, so that every output
    it reaches is -inf, which the ReLU after it takes to 0: the forward is
    finite, and the conv's weight gradient takes inf x 0. The JAX package's
    guard, which reads every leaf of its gradient, skips the step (its
    ``apply_step_update`` on these gradients); the port's skips it too,
    where a guard over the trainable gradients alone would take it. The
    same step on the chunk without the inf is taken."""
    import jax

    cfg, jcfg = tiny_cfg(default_config()), tiny_cfg(jax_default_config())
    for c in (cfg, jcfg):
        c.update(FIX_BACKBONE=True, USE_MASK=False)
    det = Detector(DetectorConfig.from_cfg(cfg), device="cpu", param_dtype=torch.float32)
    det.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        w = det.geometry1[0].weight  # (out, in, kx, ky, kz), stride 2: voxel (0, 0, 0) meets tap (0, 0, 0) only
        w[:, 0, 0, 0, 0] = -w[:, 0, 0, 0, 0].abs() - 0.01
    clean = make_batch(0)
    bad = {**clean, "data": clean["data"].copy()}
    bad["data"][0, 0, 0, 0, 0] = np.inf
    draws = jax_step_draws(jax.random.PRNGKey(3), anchor_count(det, SHAPE), 8 + 4)
    names = [k for k, _ in det.named_parameters()]
    frozen = {k for k, (_, f) in jax_solver.param_groups(names, jcfg).items() if f}
    assert "geometry1.0.weight" in frozen and "classifier.0.weight" not in frozen

    # every parameter's gradient, as the JAX package takes it
    for p in det.parameters():
        p.requires_grad_(True)
    total, metrics = build_loss_fn(det, cfg, SHAPE)(bad, {k: torch.as_tensor(v) for k, v in draws.items()})
    assert bool(torch.isfinite(total))
    got = torch.autograd.grad(total, [p for _, p in det.named_parameters()], allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(det.named_parameters(), got)}
    bad_names = {k for k, g in grads.items() if not bool(torch.isfinite(g).all())}
    assert bad_names == {"geometry1.0.weight"}
    assert (grads["classifier.0.weight"] != 0).any()  # the class losses reach the trainable layers

    # the JAX package's guard on these gradients skips the step
    jinit, jupdate = jax_solver.make_solver(jcfg, names)
    params = {k: jnp.asarray(v) for k, v in ckpt.module_params(det).items() if k in names}
    _, jm = jax_apply_step_update(TrainState(params=params, opt=jinit(params)),
                                  {k: jnp.asarray(v) for k, v in ckpt.tensors_to_params(grads).items()},
                                  {"total_loss": jnp.asarray(float(metrics["total_loss"]))}, jupdate)
    assert float(jm["step_finite"]) == 0.0

    # the port's step skips it, and takes the one on the clean chunk
    opt_init, step = build_train_step(det, cfg, SHAPE)
    opt = opt_init()
    for batch, want in ((bad, 0.0), (clean, 1.0)):
        before = {k: v.clone() for k, v in det.state_dict().items()}
        m = step(opt, batch, draws=draws)
        assert float(m["step_finite"]) == want and bool(torch.isfinite(m["total_loss"]))
        assert any(not torch.equal(v, before[k]) for k, v in det.state_dict().items()) == bool(want)
    assert int(opt.step) == 1
