"""The port's CoordConv3d and 2D autoencoder (``models/coord_conv3d.py``,
``models/autoencoder2d.py``) against the JAX package's, in float32 on the
CPU, within 1e-5 of each output's largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dsis.models import autoencoder2d as jax_ae
from tpu3dsis.models import coord_conv3d as jax_cc
from tpu3dsis_torch.models.autoencoder2d import Autoencoder2d, params_to_state_dict
from tpu3dsis_torch.models.coord_conv3d import add_coordinates_3d, coord_conv3d

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0), np.abs(got - want).max()


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


@pytest.mark.parametrize("shape,window,stride,padding", [
    ((2, 6, 5, 7, 3), None, 1, 1),  # odd and even dims
    ((1, 8, 1, 4, 2), None, 2, 1),  # an axis of one, stride 2
    ((2, 5, 6, 4, 1), ((-0.5, 0.25), (0.0, 1.0), (-1.0, -0.2)), 1, 0),  # the random-window variant
])
def test_coord_conv3d_matches_jax(shape, window, stride, padding):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(3, 3, 3, shape[-1] + 3, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    want_coords = np.asarray(jax_cc.add_coordinates_3d(jnp.asarray(x), window))
    _close(add_coordinates_3d(_ncdhw(x), window).numpy().transpose(0, 2, 3, 4, 1), want_coords)
    want = np.asarray(jax_cc.coord_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, padding, window))
    got = coord_conv3d(_ncdhw(x), torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()), torch.from_numpy(b), stride,
                       padding, window)
    _close(got.numpy().transpose(0, 2, 3, 4, 1), want)


def _models(seed=0):
    params = {k: np.asarray(v) for k, v in jax_ae.init_params(jax.random.PRNGKey(seed)).items()}
    model = Autoencoder2d(device="cpu")
    model.load_state_dict(params_to_state_dict(params), strict=True)
    return params, model


@pytest.mark.parametrize("hw", [(24, 40), (13, 7), (17, 32)])
def test_autoencoder_forward_matches_jax(hw):
    """encode at even and odd sizes (JAX's uneven "SAME" padding), decode
    from the odd latents, and the loss where the sizes round-trip."""
    params, model = _models()
    x = np.random.RandomState(1).rand(2, *hw, 3).astype(np.float32)
    z = np.array(jax_ae.encode(params, jnp.asarray(x)))
    with torch.no_grad():
        _close(model.encode(torch.from_numpy(x)).numpy(), z)
        _close(model.decode(torch.from_numpy(z)).numpy(), np.asarray(jax_ae.decode(params, jnp.asarray(z))))
        if hw[0] % 8 == 0 and hw[1] % 8 == 0:
            _close(model.reconstruction_loss(torch.from_numpy(x)).numpy(),
                   np.asarray(jax_ae.reconstruction_loss(params, jnp.asarray(x))))


def test_autoencoder_train_steps_match_jax():
    """Two SGD steps, the weights carried: the losses and every parameter
    within 1e-5 of the JAX package's."""
    params, model = _models(seed=3)
    rng = np.random.RandomState(2)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for _ in range(2):
        x = rng.rand(3, 16, 24, 3).astype(np.float32)
        jparams, jloss = jax_ae.train_step(jparams, jnp.asarray(x), 0.05)
        loss = model.train_step(torch.from_numpy(x), lr=0.05)
        _close(loss.numpy(), np.asarray(jloss))
    want = params_to_state_dict({k: np.asarray(v) for k, v in jparams.items()})
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].numpy(), want[k].numpy())
    assert not np.allclose(got["enc0.weight"].numpy(), params_to_state_dict(params)["enc0.weight"].numpy())


def test_autoencoder_init_draws():
    """The port's init is the JAX package's law: weights of std
    1/sqrt(9 cin), zero biases, the same from a seed on any device."""
    a, b = Autoencoder2d(device="cpu"), Autoencoder2d(device="cpu")
    a.init_params(torch.Generator().manual_seed(0))
    b.init_params(torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q)
        if name.endswith("bias"):
            assert not p.any()
    assert abs(float(a.dec0.weight.detach().std()) * np.sqrt(64 * 9) - 1) < 0.05
