"""The weights a cell runs with, made by the benchmark and handed to both
the program and the reference: a file of the repository where the
configuration names one (in JAX's layout), seeded on the card for the
rest."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import nets


def make(model: dict, weights: dict, seed: int, device) -> dict:
    """{name: float32 tensor in torch's layout on ``device``}: every
    parameter of the configuration's model; those the ``weights`` section's
    file holds under a prefix it lists come from it, the others from a
    ``torch.Generator`` on the card seeded with ``seed``."""
    shapes = nets.param_shapes(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    out = nets.seeded_params(shapes, gen, device)
    path = weights.get("file")
    if path:
        prefixes = tuple(weights["from_file"])
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files if k.startswith(prefixes) and k in shapes}
        loaded = nets.params_from_jax(arrays, device)
        for k, v in loaded.items():
            if tuple(v.shape) != tuple(shapes[k]):
                raise ValueError(f"{path}: {k} is {tuple(v.shape)}, the model wants {shapes[k]}")
        out.update(loaded)
    return out
