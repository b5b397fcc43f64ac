"""The 3D-SIS networks in plain PyTorch, from a flat parameter dict.

The benchmark's reference: float32, no kernel of the program, no module of
it. Parameters are a {name: tensor} dict in torch's layout (3D convs
OIDHW, 2D convs OIHW, linears (out, in)) under the names of the
reference's ``state_dict`` (``geometry1.2.conv1.weight``,
``rpn_cls_score_net_level1.0.weight``, ``mask_backbone.geometry.0.weight``,
``enet.10.0.0.3.weight``...). The layers follow 3D-SIS's published
networks (github.com/Sekunde/3D-SIS, ``lib/nets/backbones.py``,
``network.py``, ``enet.py``): bottlenecks without batch norm, two feature
levels at stride 4, per-level RPN heads, a three-layer classifier over
4x4x4 RoI pools, and the mask FCN of five 3x3x3 convs.

``Precision`` is how every conv and linear takes its operands: float32 as
they are (the reference), or cast to float8 e4m3 (the control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FEAT_STRIDE = 4
BN_EPS = 1e-3


class Precision:
    """The operands' rounding: "fp32" leaves them; "fp8_cast" casts each to
    float8 e4m3 as it is (no scale), the gradient passing straight through."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8_cast"):
            raise ValueError(f"precision {kind!r}: fp32 or fp8_cast")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return t
        x = t.detach()
        return t + (x.to(torch.float8_e4m3fn).to(torch.float32) - x)


FP32 = Precision()


def conv3d(p, name, x, prec, stride=1, pad=0, bias=True):
    w = prec(p[f"{name}.weight"])
    b = p[f"{name}.bias"] if bias else None
    return F.conv3d(prec(x), w, b, stride=stride, padding=pad)


def bottleneck3d(p, name, x, prec):
    y = torch.relu(conv3d(p, f"{name}.conv1", x, prec))
    y = torch.relu(conv3d(p, f"{name}.conv2", y, prec, pad=1))
    return torch.relu(conv3d(p, f"{name}.conv3", y, prec) + x)


def maxpool3(x):
    return F.max_pool3d(x, 3, 1, 1)


# Each stream as (kind, index, args): "conv" (cin, cout, k, stride, pad, bias),
# "bneck" (inplanes, planes), "pool"; a ReLU follows each strided conv.
def _scannet_streams(use_images: bool):
    geo_ch = 64 if use_images else 128
    geometry1 = [("conv", 0, 2, 32, 2, 2, 0, False), ("bneck", 2, 32, 32), ("bneck", 3, 32, 32),
                 ("conv", 4, 32, geo_ch, 2, 2, 0, False), ("bneck", 6, geo_ch, 32), ("bneck", 7, geo_ch, 32)]
    color = [("conv", 0, 128, 64, 2, 2, 0, False), ("bneck", 2, 64, 32), ("pool", 3),
             ("conv", 4, 64, 64, 2, 2, 0, False), ("bneck", 6, 64, 32), ("pool", 7)]
    geometry2 = [("conv", 0, 128, 128, 3, 1, 1, False), ("bneck", 2, 128, 64), ("bneck", 3, 128, 64), ("pool", 4)]
    return geometry1, (color if use_images else None), geometry2


def _suncg_streams(use_images: bool):
    geometry1 = [("conv", 0, 2, 64, 2, 2, 0, False), ("bneck", 2, 64, 32),
                 ("conv", 3, 64, 64, 2, 2, 0, False), ("bneck", 5, 64, 32)]
    color = [("conv", 0, 128, 64, 2, 2, 0, False), ("bneck", 2, 64, 32),
             ("conv", 3, 64, 64, 2, 2, 0, False), ("bneck", 5, 64, 32)]
    geometry2 = [("conv", 0, 128 if use_images else 64, 128, 3, 1, 1, False), ("bneck", 2, 128, 64)]
    return geometry1, (color if use_images else None), geometry2


STREAMS = {"ScanNet_Backbone": _scannet_streams, "SUNCG_Backbone": _suncg_streams}


def run_stream(p, prefix, layers, x, prec):
    for layer in layers:
        kind, idx = layer[0], layer[1]
        name = f"{prefix}.{idx}"
        if kind == "conv":
            _, _, _, _, _, stride, pad, bias = layer
            x = torch.relu(conv3d(p, name, x, prec, stride=stride, pad=pad, bias=bias))
        elif kind == "bneck":
            x = bottleneck3d(p, name, x, prec)
        else:
            x = maxpool3(x)
    return x


def backbone(p, net: str, use_images: bool, scene, imageft, prec=FP32):
    """scene (N, 2, X, Y, Z), imageft (N, 128, X, Y, Z) or None -> the two
    level maps (N, 128, X/4, Y/4, Z/4); level 1 is the color stream's
    channels, then the geometry stream's."""
    geometry1, color, geometry2 = STREAMS[net](use_images)
    lvl1 = run_stream(p, "geometry1", geometry1, scene, prec)
    if color is not None:
        lvl1 = torch.cat([run_stream(p, "color", color, imageft, prec), lvl1], dim=1)
    return lvl1, run_stream(p, "geometry2", geometry2, lvl1, prec)


def rpn_level(p, lvl: int, feat, num_anchors: int, prec=FP32):
    """One level's RPN head: feat (N, 128, W, H, L) -> (cls_score (N, W, H,
    L, 2, A), bbox_pred (N, W*H*L*A, 6)); class k of anchor a is channel
    k*A + a, sites x-major, anchors innermost."""
    t = torch.relu(conv3d(p, f"rpn_net_level{lvl}", feat, prec, pad=1))
    cls = conv3d(p, f"rpn_cls_score_net_level{lvl}.0", t, prec).permute(0, 2, 3, 4, 1)
    cls = cls.reshape(*cls.shape[:4], 2, num_anchors)
    box = conv3d(p, f"rpn_bbox_pred_net_level{lvl}", t, prec).permute(0, 2, 3, 4, 1)
    return cls, box.reshape(box.shape[0], -1, 6)


def linear(p, name, x, prec):
    return F.linear(prec(x), prec(p[f"{name}.weight"]), p[f"{name}.bias"])


def classifier(p, pool5, prec=FP32):
    """pool5 (R, 128, 4, 4, 4) -> (cls_score (R, C), bbox_pred (R, 6C))."""
    x = pool5.reshape(pool5.shape[0], -1)
    for i in (0, 2, 4):
        x = torch.relu(linear(p, f"classifier.{i}", x, prec))
    return linear(p, "classifier_cls_score_net", x, prec), linear(p, "classifier_bbox_pred_net", x, prec)


def mask_fcn(p, crop, prec=FP32):
    """The mask FCN's geometry branch on one exact-size crop: (1, 2, X, Y, Z)
    -> (1, C, X, Y, Z) logits; zero padding at the crop's border."""
    x = crop
    for i in (0, 2, 4, 6, 8):
        x = torch.relu(conv3d(p, f"mask_backbone.geometry.{i}", x, prec, pad=1, bias=False))
    return conv3d(p, "mask_backbone.geometry.10", x, prec, bias=False)


# --- ENet (lib/nets/enet.py: the Torch7 graph; eval mode) --------------------
def enet_blocks():
    """("down", idx, cin, mid, cout, drop), ("reg", idx, cin, mid, drop,
    dilation), ("asym", idx, cin, mid, drop)."""
    blocks = [("down", 4, 16, 16, 64, 0.01)]
    blocks += [("reg", i, 64, 16, 0.01, 1) for i in range(5, 9)]
    blocks.append(("down", 9, 64, 32, 128, 0.1))
    for base in (10, 18):
        blocks += [("reg", base, 128, 32, 0.1, 1), ("reg", base + 1, 128, 32, 0.1, 2),
                   ("asym", base + 2, 128, 32, 0.1), ("reg", base + 3, 128, 32, 0.1, 4),
                   ("reg", base + 4, 128, 32, 0.1, 1), ("reg", base + 5, 128, 32, 0.1, 8),
                   ("asym", base + 6, 128, 32, 0.1), ("reg", base + 7, 128, 32, 0.1, 16)]
    return blocks


def _bn(p, name, x):
    scale = p[f"{name}.weight"] / torch.sqrt(p[f"{name}.running_var"] + BN_EPS)
    shift = p[f"{name}.bias"] - p[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def _prelu(p, name, x):
    return F.prelu(x, p[f"{name}.weight"])


def _conv2d(p, name, x, prec, bias, **kw):
    return F.conv2d(prec(x), prec(p[f"{name}.weight"]), p[f"{name}.bias"] if bias else None, **kw)


def enet_features(p, images, prec=FP32):
    """(V, H, W, 3) normalised RGB -> (V, H/8, W/8, 128): modules 0-25."""
    x = images.permute(0, 3, 1, 2)
    y = torch.cat([_conv2d(p, "enet.0.0", x, prec, True, stride=2, padding=1), F.max_pool2d(x, 2)], dim=1)
    y = _prelu(p, "enet.3", _bn(p, "enet.2", y))
    for blk in enet_blocks():
        kind, idx = blk[0], blk[1]
        m = f"enet.{idx}.0.0"
        if kind == "down":
            cin, cout, drop, dil = blk[2], blk[4], blk[5], 1
        elif kind == "reg":
            cin, cout, drop, dil = blk[2], blk[2], blk[4], blk[5]
        else:
            cin, cout, drop, dil = blk[2], blk[2], blk[4], 1
        if kind == "down":
            h = _conv2d(p, f"{m}.0", y, prec, False, stride=2)
        else:
            h = _conv2d(p, f"{m}.0", y, prec, False)
        h = _prelu(p, f"{m}.2", _bn(p, f"{m}.1", h))
        if kind == "asym":
            h = _conv2d(p, f"{m}.3", h, prec, False, padding=(0, 2))
            h = _conv2d(p, f"{m}.4", h, prec, True, padding=(2, 0))
            rest = 5
        else:
            h = _conv2d(p, f"{m}.3", h, prec, True, padding=dil, dilation=dil)
            rest = 4
        h = _prelu(p, f"{m}.{rest + 1}", _bn(p, f"{m}.{rest}", h))
        h = _bn(p, f"{m}.{rest + 3}", _conv2d(p, f"{m}.{rest + 2}", h, prec, False)) * (1.0 - drop)
        skip = y
        if kind == "down":
            skip = F.pad(F.max_pool2d(y, 2), (0, 0, 0, 0, 0, cout - cin))
        y = _prelu(p, f"enet.{idx}.2", h + skip)
    return y.permute(0, 2, 3, 1)


def normalise_images(images_u8, mean, std):
    """uint8 (V, H, W, 3) -> float32 (x / 255 - mean) / std."""
    m = torch.tensor(mean, dtype=torch.float32, device=images_u8.device)
    s = torch.tensor(std, dtype=torch.float32, device=images_u8.device)
    return (images_u8.to(torch.float32) / 255.0 - m) / s


# --- the parameters' names and shapes --------------------------------------------
def param_shapes(cfg: dict) -> dict:
    """{name: shape} of every parameter of the detector that ``cfg`` (a
    configuration file's ``model`` section) describes, in torch's layout."""
    shapes = {}
    geometry1, color, geometry2 = STREAMS[cfg["NET"]](bool(cfg["USE_IMAGES"]))
    for prefix, layers in (("geometry1", geometry1), ("color", color), ("geometry2", geometry2)):
        for layer in layers or []:
            name = f"{prefix}.{layer[1]}"
            if layer[0] == "conv":
                _, _, cin, cout, k, _, _, bias = layer
                shapes[f"{name}.weight"] = (cout, cin, k, k, k)
                if bias:
                    shapes[f"{name}.bias"] = (cout,)
            elif layer[0] == "bneck":
                inp, planes = layer[2], layer[3]
                for conv, ci, co, k in (("conv1", inp, planes, 1), ("conv2", planes, planes, 3),
                                        ("conv3", planes, inp, 1)):
                    shapes[f"{name}.{conv}.weight"] = (co, ci, k, k, k)
                    shapes[f"{name}.{conv}.bias"] = (co,)
    pool = int(cfg["CLASS_POOLING_SIZE"])
    for i, (ci, co) in zip((0, 2, 4), ((128 * pool**3, 256), (256, 256), (256, 128))):
        shapes[f"classifier.{i}.weight"], shapes[f"classifier.{i}.bias"] = (co, ci), (co,)
    nc = int(cfg["NUM_CLASSES"])
    shapes["classifier_cls_score_net.weight"], shapes["classifier_cls_score_net.bias"] = (nc, 128), (nc,)
    shapes["classifier_bbox_pred_net.weight"], shapes["classifier_bbox_pred_net.bias"] = (6 * nc, 128), (6 * nc,)
    rc = int(cfg["RPN_CHANNELS"])
    for lvl in (1, 2):
        a = int(cfg[f"NUM_ANCHORS_LEVEL{lvl}"])
        shapes[f"rpn_net_level{lvl}.weight"], shapes[f"rpn_net_level{lvl}.bias"] = (rc, 128, 3, 3, 3), (rc,)
        shapes[f"rpn_cls_score_net_level{lvl}.0.weight"] = (2 * a, rc, 1, 1, 1)
        shapes[f"rpn_cls_score_net_level{lvl}.0.bias"] = (2 * a,)
        shapes[f"rpn_bbox_pred_net_level{lvl}.weight"] = (6 * a, rc, 1, 1, 1)
        shapes[f"rpn_bbox_pred_net_level{lvl}.bias"] = (6 * a,)
    if cfg["USE_MASK"]:
        for i in (0, 2, 4, 6, 8):
            shapes[f"mask_backbone.geometry.{i}.weight"] = (64, 2 if i == 0 else 64, 3, 3, 3)
        shapes["mask_backbone.geometry.10.weight"] = (nc, 64, 1, 1, 1)
    if cfg["USE_IMAGES"]:
        shapes.update(enet_shapes(int(cfg["NUM_2D_CLASSES"])))
    return shapes


def enet_shapes(num_2d_classes: int) -> dict:
    shapes = {"enet.0.0.weight": (13, 3, 3, 3), "enet.0.0.bias": (13,)}

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{k}"] = (c,)

    bn("enet.2", 16)
    shapes["enet.3.weight"] = (16,)
    for blk in enet_blocks():
        kind, idx = blk[0], blk[1]
        cin, mid = blk[2], blk[3]
        cout = blk[4] if kind == "down" else cin
        m = f"enet.{idx}.0.0"
        k0 = 2 if kind == "down" else 1
        shapes[f"{m}.0.weight"] = (mid, cin, k0, k0)
        bn(f"{m}.1", mid)
        shapes[f"{m}.2.weight"] = (mid,)
        if kind == "asym":
            shapes[f"{m}.3.weight"] = (mid, mid, 1, 5)
            shapes[f"{m}.4.weight"], shapes[f"{m}.4.bias"] = (mid, mid, 5, 1), (mid,)
            rest = 5
        else:
            shapes[f"{m}.3.weight"], shapes[f"{m}.3.bias"] = (mid, mid, 3, 3), (mid,)
            rest = 4
        bn(f"{m}.{rest}", mid)
        shapes[f"{m}.{rest + 1}.weight"] = (mid,)
        shapes[f"{m}.{rest + 2}.weight"] = (cout, mid, 1, 1)
        bn(f"{m}.{rest + 3}", cout)
        shapes[f"enet.{idx}.2.weight"] = (cout,)
    shapes["enet.26.0.weight"] = (num_2d_classes, 128, 1, 1)
    return shapes


def fan_in(shape) -> int:
    n = 1
    for s in shape[1:]:
        n *= s
    return n


@torch.no_grad()
def seeded_params(shapes: dict, generator: torch.Generator, device) -> dict:
    """Torch's default init for convs and linears (weight and bias
    U(+-1/sqrt(fan_in)) of their weight), batch norms at weight 1, bias 0,
    mean 0, variance 1, PReLU slopes 0.25; one uniform draw on ``device``
    for all of it, float32."""
    names = sorted(shapes)
    sizes = [int(torch.Size(shapes[n]).numel()) for n in names]
    flat = torch.rand(sum(sizes), generator=generator, device=device) * 2.0 - 1.0
    out = {}
    for name, part in zip(names, flat.split(sizes)):
        shape = shapes[name]
        owner = name.rsplit(".", 1)[0]
        weight = shapes.get(f"{owner}.weight")
        if name.endswith(("running_mean",)) or (name.endswith(".bias") and len(weight) == 1):
            out[name] = torch.zeros(shape, device=device)
        elif name.endswith("running_var") or (name.endswith(".weight") and len(shape) == 1
                                               and f"{owner}.running_var" in shapes):
            out[name] = torch.ones(shape, device=device)
        elif name.endswith(".weight") and len(shape) == 1:
            out[name] = torch.full(shape, 0.25, device=device)
        else:
            out[name] = part.reshape(shape) * fan_in(weight) ** -0.5
    return out


def params_from_jax(arrays: dict, device) -> dict:
    """A flat JAX-layout param dict (numpy; 3D conv DHWIO, 2D conv HWIO,
    linear (in, out)) -> float32 tensors in torch's layout on ``device``."""
    out = {}
    for name, value in arrays.items():
        t = torch.as_tensor(value, dtype=torch.float32).to(device)
        if name.endswith(".weight") and t.dim() == 5:
            t = t.permute(4, 3, 0, 1, 2)
        elif name.endswith(".weight") and t.dim() == 4:
            t = t.permute(3, 2, 0, 1)
        elif name.endswith(".weight") and t.dim() == 2:
            t = t.t()
        out[name] = t.contiguous()
    return out
