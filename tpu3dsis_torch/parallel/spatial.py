"""Spatial sharding: the backbone over a scene cut along X into shards, one
a device, with halo exchanges (``tpu3dsis/parallel/spatial.py``).

A whole-scene volume is split along X into equal shards over a list of
devices. Each 3x3x3 conv and 3x3x3 max-pool first takes one X-slab from
each neighbour shard (``halo_exchange``: a ``tensor.to(neighbour's
device)`` copy, the counterpart of ``ppermute``; zeros at the grid's two
ends), so every shard computes the values the unsharded layer computes on
its voxels. The stride-2, kernel-2 convs need no halo while each shard's X
extent stays even. The stride-4 maps are small (1/64 of the voxels), so
they are gathered onto the first device, where the RPN and the RoI heads
run (``parallel/scene.py``).

The device list may name one device more than once: that is how one card
runs this code. Each distinct device gets one copy of the backbone's
layers (``replicas``).
Shards run in channels-first (N, C, X, Y, Z) with N = 1, as the
detector's backbone does.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F

from tpu3dsis_torch.models.nn import Bottleneck, Conv, MaxPool, Relu


def halo_exchange(shards: list, halo: int = 1) -> list:
    """Each (N, C, Xl, Y, Z) shard with ``halo`` X-slabs of each neighbour
    added, on the shard's own device: -> (N, C, Xl + 2 halo, Y, Z). The
    first shard's left slab and the last one's right slab are zeros, which
    is what a zero-padded conv over the whole volume sees there."""
    out = []
    for i, x in enumerate(shards):
        zeros = x.new_zeros((*x.shape[:2], halo, *x.shape[3:]))
        left = zeros if i == 0 else shards[i - 1][:, :, -halo:].to(x.device)
        right = zeros if i == len(shards) - 1 else shards[i + 1][:, :, :halo].to(x.device)
        out.append(torch.cat([left, x, right], dim=2))
    return out


def _conv(layer: Conv, x: torch.Tensor, padding=None) -> torch.Tensor:
    """``layer`` on x, in x's dtype (as ``Conv.forward``), with its own
    padding or ``padding``."""
    w = layer.weight.to(x.dtype)
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv3d(x, w, b, stride=layer.stride, padding=layer.padding if padding is None else padding)


def _halo_conv3(layers: list, shards: list) -> list:
    """A 3x3x3 pad-1 conv over the sharded volume: the halo on X, padding 1
    on Y and Z. ``layers[i]`` is the conv's copy on shard i's device."""
    return [_conv(layer, x, padding=(0, 1, 1)) for layer, x in zip(layers, halo_exchange(shards))]


def _halo_maxpool3(shards: list) -> list:
    """The 3x3x3 stride-1 max-pool over the sharded volume: the halo on X
    (zeros at the grid's ends, as the JAX package has it: the backbone pools
    only ReLU outputs, where a zero never exceeds the window's max), -inf
    padding on Y and Z."""
    out = []
    for x in halo_exchange(shards):
        x = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
        out.append(F.max_pool3d(x, 3, stride=1))
    return out


def apply_specs_sharded(copies: list, shards: list) -> list:
    """Shard-local apply of a backbone stream (an ``nn.Sequential``), one
    copy of it a shard, on the shard's device. The shipped backbones'
    vocabulary: k=2 s=2 convs (no halo; each shard's X stays even), k=3
    pad-1 convs and 3x3x3 max-pools (a one-slab halo), 1x1x1 convs,
    Bottlenecks and ReLU."""
    for layers in zip(*copies):
        spec = layers[0]
        if isinstance(spec, Conv):
            k = spec.kernel_size[0]
            if k == 3:
                if spec.padding != (1, 1, 1) or spec.stride != (1, 1, 1):
                    raise ValueError(f"{spec}: a sharded 3x3x3 conv has stride 1 and padding 1")
                shards = _halo_conv3(layers, shards)
            elif k == 1 or spec.stride[0] == k:
                shards = [_conv(layer, x) for layer, x in zip(layers, shards)]
            else:
                raise ValueError(f"{spec}: not in the sharded backbone's vocabulary")
        elif isinstance(spec, Relu):
            shards = [torch.relu(x) for x in shards]
        elif isinstance(spec, MaxPool):
            if (spec.kernel_size, spec.stride, spec.padding) != (3, 1, 1):
                raise ValueError(f"{spec}: a sharded max-pool is 3x3x3, stride 1, padding 1")
            shards = _halo_maxpool3(shards)
        elif isinstance(spec, Bottleneck):
            res = shards
            y = [torch.relu(_conv(b.conv1, x)) for b, x in zip(layers, shards)]
            y = [torch.relu(t) for t in _halo_conv3([b.conv2 for b in layers], y)]
            shards = [torch.relu(_conv(b.conv3, t) + r) for b, t, r in zip(layers, y, res)]
        else:
            raise TypeError(f"{type(spec).__name__} is not in the sharded backbone's vocabulary")
    return shards


def replicas(module: torch.nn.Module, devices: list) -> list:
    """One copy of ``module`` for each entry of ``devices``: the module
    itself on its own device, one copy on each other distinct device,
    shared by the entries that name it (the list may name one device more
    than once)."""
    home = next(module.parameters()).device
    by_device = {home: module}
    out = []
    for d in devices:
        if d not in by_device:
            by_device[d] = copy.deepcopy(module).to(d)
        out.append(by_device[d])
    return out


def device_list(devices) -> list:
    """torch.devices of a device list, a CUDA device without an index made
    the current one's."""
    out = []
    for d in devices:
        d = torch.device(d)
        out.append(torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d)
    return out


@torch.inference_mode()
def spatial_features(detector, scene: torch.Tensor, devices, imageft: torch.Tensor | None = None) -> dict:
    """The backbone over a whole scene with X sharded over ``devices``.

    scene (X, Y, Z, 2) and, with the color stream, imageft (X, Y, Z, C2d),
    any device; X must divide by 4 * len(devices) (the stride-4 maps' shards
    stay whole). Returns {1: lvl1, 2: lvl2} as ``detector.features`` does:
    (1, X/4, Y/4, Z/4, 128) channels-last, on the first device, in the
    detector's compute dtype.
    """
    devices = device_list(devices)
    n = len(devices)
    if scene.shape[0] % (4 * n):
        raise ValueError(f"X={scene.shape[0]} must divide by 4 * {n}")
    dt = detector.compute_dtype

    def shard(vol):
        # each shard goes straight to its device: no device holds the whole volume
        x = torch.as_tensor(vol).permute(3, 0, 1, 2)[None]  # (1, C, X, Y, Z), channels-last in memory
        return [s.to(d, dt).contiguous(memory_format=torch.channels_last_3d)
                for s, d in zip(x.chunk(n, dim=2), devices)]

    def run(stream, shards):
        return apply_specs_sharded(replicas(stream, devices), shards)

    if detector.color is not None:
        if imageft is None:
            raise ValueError("a detector with the color stream needs the projected color volume (imageft)")
        color = run(detector.color, shard(imageft))
    if detector.geometry1 is None:
        lvl1 = color
    elif detector.color is not None:
        lvl1 = [torch.cat([c, g], dim=1) for c, g in zip(color, run(detector.geometry1, shard(scene)))]
    else:
        lvl1 = run(detector.geometry1, shard(scene))
    lvl2 = run(detector.geometry2, lvl1)

    def gather(shards):
        # contiguous channels-last, as K1 reads each level map
        return torch.cat([s.to(devices[0]).permute(0, 2, 3, 4, 1) for s in shards], dim=1).contiguous()

    return {1: gather(lvl1), 2: gather(lvl2)}
