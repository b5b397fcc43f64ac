"""The comparison fails what it must, on the CPU at a size a test run
holds: each cell's run driven past the look for a card (``run.drive``),
with a fault planted under the timed path, reads ``correct`` false against
the cell's own limits; the control (the reference in the program's place,
its operands cast to float8) fails them too; the program itself passes. The
cells' own sizes are read on the card by ``python3 -m portbench.readings``.
"""

from __future__ import annotations

import contextlib
import copy
import json

import pytest

from portbench import faults, harness, judge, run, traffic
from portbench.kinds import serve_rooms, train_step

SEED = 2**32 + 4242
# two or more rooms (of three tiles, so that half of them can be left out)
# or steps in the window, on the CPU
WINDOW_S = {"scannet.rooms": 15.0, "suncg.train": 8.0}
TINY_ROOMS = {"kind": "serve_rooms", "pool": 2, "extents": [[144, 48, 96]], "views": [4, 6], "objects": [4, 6]}


def _room_kind():
    return serve_rooms.make(harness.config("scannet.rpn_class_mask_5"), TINY_ROOMS, SEED, device="cpu")


def _train_kind(config):
    cfg = copy.deepcopy(harness.config(config))
    t = cfg["train"]
    t["TPU_MAX_MASK_ROIS"], t["TPU_MASK_CANVAS"] = 2, [32, 32, 32]
    t["TRAIN"]["RPN_PRE_NMS_TOP_N"], t["TRAIN"]["RPN_POST_NMS_TOP_N"] = 200, 50
    mix = dict(traffic.load("train_chunks"), pool=1, extents=[[144, 48, 144]], views=[6, 6], objects=[6, 6],
               chunks_per_room=4, batch=2)
    return train_step.make(cfg, mix, SEED, device="cpu")


def _correct(kind, workload, fault=None):
    with fault if fault is not None else contextlib.nullcontext():
        bench = harness.benchmark(str(harness.ROOT.parent / "BENCHMARK.json"))
        line, _ = run.drive(kind, bench, workload, WINDOW_S[workload], False)
    return json.loads(line)["correct"]


@pytest.mark.parametrize("fault", [None, "stale", "half", "class"])
def test_served_rooms_fail_each_fault(fault):
    kind = _room_kind()
    assert _correct(kind, "scannet.rooms", None if fault is None else faults.serve(fault)) is (fault is None)


def test_served_rooms_fail_the_float8_control():
    kind = _room_kind()
    assert _correct(kind, "scannet.rooms")
    ok, _ = judge.decide(kind.check(served=kind.control()), harness.limits("scannet.rooms"))
    assert not ok


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_training_fails_each_fault(fault):
    kind = _train_kind("suncg.rpn_class_mask_5")
    assert _correct(kind, "suncg.train", None if fault is None else faults.train(fault)) is (fault is None)


def test_training_fails_the_float8_control():
    kind = _train_kind("suncg.rpn_class_mask_5")
    assert _correct(kind, "suncg.train")
    ok, _ = judge.decide(kind.check(served=kind.control()), harness.limits("suncg.train"))
    assert not ok
