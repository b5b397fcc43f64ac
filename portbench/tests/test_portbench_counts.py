"""The benchmark's counts on the CPU: FLOPs against ``torch.utils.flop_counter``
on the reference's layers at small shapes, bytes against hand sums."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.counts import bounds, flops
from portbench.reference import nets

SMALL = (16, 8, 16)


def _model(name):
    return harness.config(name)["model"]


def _params(model):
    return nets.seeded_params(nets.param_shapes(model), torch.Generator().manual_seed(0), "cpu")


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("name", ["scannet.rpn_class_mask_5", "suncg.rpn_class_mask_5"])
def test_backbone_and_rpn_flops_match_the_flop_counter(name):
    model = _model(name)
    p = _params(model)
    scene = torch.rand(1, 2, *SMALL)
    color = torch.rand(1, 128, *SMALL)
    counted = _counted(lambda: nets.backbone(p, model["NET"], True, scene, color))
    assert counted == pytest.approx(sum(flops.backbone(model, SMALL).values()), rel=1e-9)
    lvl = torch.rand(1, 128, *(s // 4 for s in SMALL))
    counted = sum(_counted(lambda lv=lv: nets.rpn_level(p, lv, lvl, model[f"NUM_ANCHORS_LEVEL{lv}"]))
                  for lv in (1, 2))
    assert counted == pytest.approx(flops.rpn(model, SMALL), rel=1e-9)


@pytest.mark.parametrize("name", ["scannet.rpn_class_mask_5", "suncg.rpn_class_mask_5"])
def test_classifier_and_mask_flops_match_the_flop_counter(name):
    model = _model(name)
    p = _params(model)
    pool5 = torch.rand(5, 128, 4, 4, 4)
    assert _counted(lambda: nets.classifier(p, pool5)) == pytest.approx(flops.classifier(model, 5), rel=1e-9)
    crop = torch.rand(1, 2, 7, 5, 9)
    assert _counted(lambda: nets.mask_fcn(p, crop)) == pytest.approx(flops.mask_fcn(model, 7 * 5 * 9), rel=1e-9)


def test_enet_flops_match_the_flop_counter():
    p = nets.seeded_params(nets.enet_shapes(41), torch.Generator().manual_seed(0), "cpu")
    images = torch.rand(1, 64, 80, 3)
    assert _counted(lambda: nets.enet_features(p, images)) == pytest.approx(flops.enet(64, 80), rel=1e-9)


def test_train_step_counts_backward_only_where_a_gradient_passes():
    cfg = harness.config("scannet.rpn_class_mask_5")
    gt = [np.array([[10, 5, 10, 30, 20, 30]], np.float32)]
    f = flops.train_step(cfg["model"], cfg["train"], 1, gt)
    assert {k for k, v in f["backward"].items() if v} == {"mask"}
    suncg = harness.config("suncg.rpn_class_mask_5")
    f = flops.train_step(suncg["model"], suncg["train"], 1, gt)
    assert {k for k, v in f["backward"].items() if v} == {"backbone", "rpn", "classifier", "mask"}
    assert f["backward"]["backbone"] == 2 * f["forward"]["backbone"]


def test_k3_bytes_are_the_hand_sum():
    call = {"feats_shape": (3, 32, 41, 128), "itemsize": 2, "volume_dims": (96, 48, 96)}
    want = 96 * 48 * 96 * 128 * 2 + 3 * 32 * 41 * 128 * 2 + 3 * 32 * 41 * 4 + 3 * (12 * 4 + 1)
    assert bounds.k3_bytes(call) == want


def test_k1_and_k1b_bytes_are_the_hand_sums():
    # two rois on one level map of (1, 10, 10, 10, C): a 2x2x2 cube and a
    # 3x1x1 row that overlaps it in one voxel
    call = {"rois": np.array([[0, 0, 0, 8, 8, 8], [4, 0, 0, 16, 4, 4]], np.float32),
            "batch_idx": np.array([0, 0]), "level_idx": np.array([0, 0]), "map_shapes": [(1, 10, 10, 10, 16)],
            "scales": [0.25], "pooled": 4, "channels": 16, "itemsize": 2}
    covered = 8 + 3 - 1
    want = covered * 16 * 2 + 2 * (6 * 4 + 2 * 4) + 2 * 16 * 4**3 * 2
    assert bounds.k1_bytes(call) == want
    assert bounds.k1b_bytes(call) == want + 1000 * 16 * 2
