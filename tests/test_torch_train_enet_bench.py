"""SUNCG's training step with the ENet trained (``FIX_ENET: False``, the
benchmark's ``suncg.rpn_class_mask_5-enet``), on the CPU at a small size,
against the benchmark's plain reference (``portbench/reference/train.py``):

- three steps of the port's ``build_train_step`` and the reference's three
  from the same seeded weights, batches and draws, compared by the numbers
  that decide the cell's ``correct`` (``portbench.judge.train_numbers`` and
  the RPN loss's of ``portbench/kinds/train_step_rpn.py``); the same with
  K3b's plain backward zeroed fails them, as the float8 control fails the
  RPN loss's;
- the reference's view fusion splits a tie's gradient as the port does;
- the spans the step records for the ENet, the fusion and the update;
- K3b's bytes (``portbench/counts/k3b.py``) by hand and against
  ``chip_smoke.py::k3b_bound``, and the reader of its roofline.

No JAX: a test worker runs it in about 20 s.
"""

import copy
import types

import numpy as np
import pytest
import torch

import chip_smoke
from portbench import harness, judge, weights
from portbench.counts import PEAKS, k3b
from portbench.kinds import train_step, train_step_rpn
from portbench.reference import nets
from portbench.reference import geometry as G
from portbench.reference.train import frozen
from tpu3dsis_torch.config import DetectorConfig, default_config
from tpu3dsis_torch.geometry import projection
from tpu3dsis_torch.models.detector import Detector
from tpu3dsis_torch.train.trainstep import build_train_step
from tpu3dsis_torch.utils import tracing

CONFIG = "suncg.rpn_class_mask_5-enet"
SHAPE = (32, 16, 32)
BATCH, VIEWS, STEPS = 2, 2, 3
F = 6.0  # focal length in pixels of the 5x4 depth maps
SEED = 2**33 + 7
THREADS = 2

# Both sides compute in float32 here (the configuration's bf16 is the
# card's, whose rounding its own limits take), so the program and the
# reference differ only in the order of their sums: about 1e-7 of a value
# on these inputs (loss 7e-8, gradient 6e-7, change 3e-6 of the median
# leaf when written). Each tolerance leaves a hundred times that or more;
# a gradient share lost or misrouted moves its leaves by their whole norm.
TOL = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3, "change_gap_median": 1e-4, "rpn_loss_gap": 1e-5}


def small_config() -> dict:
    """The configuration's file at a small size: a 32x16x32 chunk, 2 views
    of 40x32 uint8 images (5x4 ENet features and depths), 4 gt boxes, 2
    mask rois, float32 compute; every other key as the file holds it."""
    cfg = copy.deepcopy(harness.config(CONFIG))
    t = cfg["train"]
    t.update(TPU_TILE_SIZE=list(SHAPE), TPU_MASK_CANVAS=[16, 16, 16], TPU_MAX_MASK_ROIS=2, TPU_MAX_GT=4,
             RPN_BATCHSIZE=16, CLASS_BATCH_SIZE=8, IMAGE_SHAPE=[40, 32], DEPTH_SHAPE=[5, 4], NUM_IMAGES=VIEWS,
             VOXEL_SIZE=0.25, INTRINSIC=[[F, 0, 2.5, 0], [0, F, 2.0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
             TPU_COMPUTE_DTYPE="float32")
    t["TRAIN"].update(RPN_PRE_NMS_TOP_N=32, RPN_POST_NMS_TOP_N=8)
    assert cfg["train"]["FIX_ENET"] is False
    return cfg


def make_batch(seed) -> dict:
    """Objects as solid boxes in noise with their gt boxes and mask
    canvases, and two views of 40x32 uint8 images looking into the chunk."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((BATCH, 4, 7), np.float32)
    gt[..., :3] = -1e4
    gt[..., 3:6] = -1e4 + 1
    valid = np.zeros((BATCH, 4), bool)
    data = rng.randn(BATCH, *SHAPE, 2).astype(np.float32) * 0.5
    canvas = np.zeros((BATCH, *SHAPE), np.uint8)
    boxes = [[4, 4, 4, 12, 12, 12, 3], [14, 2, 10, 26, 12, 20, 5], [2, 1, 16, 20, 14, 30, 7]]
    for b in range(BATCH):
        for j, box in enumerate(boxes[:2 + b]):
            gt[b, j], valid[b, j] = box, True
            x0, y0, z0, x1, y1, z1 = box[:6]
            canvas[b, x0:x1, y0:y1, z0:z1] = rng.rand(x1 - x0, y1 - y0, z1 - z0) > 0.3
            data[b, x0:x1, y0:y1, z0:z1, 0] += 1.5
    poses = np.tile(np.eye(4, dtype=np.float32), (BATCH, VIEWS, 1, 1))
    poses[..., :3, 3] = [[4.0, 2.0, -1.0], [3.5, 2.5, -1.5]]
    return {"data": data, "gt_box": gt, "gt_valid": valid, "mask_canvas": canvas,
            "images": rng.randint(0, 256, (BATCH, VIEWS, 32, 40, 3)).astype(np.uint8),
            "depths": rng.uniform(1.0, 3.5, (BATCH, VIEWS, 4, 5)).astype(np.float32), "poses": poses,
            "world_to_grid": np.tile(np.diag([4.0, 4.0, 4.0, 1.0]).astype(np.float32), (BATCH, 1, 1)),
            "view_valid": np.ones((BATCH, VIEWS), bool)}


def program_steps(cfg, params, batches, draws) -> tuple:
    """The port's three steps as the benchmark's ``TrainStepRPN`` reads them:
    ({"losses", "rpn_losses", "grad" (the first step's momentum), "change"},
    the SGD)."""
    pcfg = default_config()
    for k, v in cfg["train"].items():
        if isinstance(v, dict):
            pcfg[k].update(v)
        else:
            pcfg[k] = v
    det = Detector(DetectorConfig.from_cfg(pcfg), device="cpu", param_dtype=torch.float32)
    det.load_state_dict(params, strict=True)
    opt_init, step = build_train_step(det, pcfg, SHAPE)
    opt = opt_init()
    names = [k for k in opt.params if not frozen(k, cfg["train"])]
    p0 = {k: opt.params[k].detach().clone() for k in names}
    out = {"losses": [], "rpn_losses": []}
    for s, (batch, dr) in enumerate(zip(batches, draws)):
        metrics = step(opt, batch, draws=dr)
        assert float(metrics["step_finite"]) == 1.0
        out["losses"].append(float(metrics["total_loss"]))
        out["rpn_losses"].append(float(sum(metrics.get(k, 0.0) for k in train_step_rpn.RPN_KEYS)))
        if s == 0:
            out["grad"] = {k: opt.momentum[k].detach().clone() for k in names}
    out["change"] = {k: opt.params[k].detach() - p0[k] for k in names}
    return out, opt


def compare(prog, ref) -> dict:
    return {**judge.train_numbers(prog, ref), **train_step_rpn.rpn_numbers(prog["rpn_losses"], ref["rpn_losses"])}


def passes(numbers) -> bool:
    return all(numbers[k] <= tol for k, tol in TOL.items())


@pytest.fixture(scope="module")
def runs():
    """The program's steps (spans recorded), the reference's, the float8
    control's, and the program's with K3b's plain backward zeroed (its one
    call recorded)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        cfg = small_config()
        params = weights.make(cfg["model"], {"file": ""}, SEED, "cpu")
        g = torch.Generator().manual_seed(5)
        anchors = (SHAPE[0] // 4) * (SHAPE[1] // 4) * (SHAPE[2] // 4) * (3 + 6)
        cands = 8 + 4  # post-NMS proposals and gt boxes
        draws = [{"anchor": torch.rand((BATCH, 2, anchors), generator=g),
                  "proposal": torch.rand((BATCH, 2, cands), generator=g)} for _ in range(STEPS)]
        batches = [make_batch(i) for i in range(STEPS)]
        tracing.clear()
        with tracing.recording():
            prog, opt = program_steps(cfg, params, batches, draws)
        recorded = tracing.spans()
        tracing.clear()
        ref = train_step_rpn.RecordingReference(cfg["model"], cfg["train"]).steps(params, batches, draws)
        control = train_step_rpn.RecordingReference(cfg["model"], cfg["train"], nets.Precision("fp8_cast")).steps(
            params, batches, draws)
        calls = []

        def zeroed(grad_out, feats2d, *args, **kw):
            calls.append((grad_out, feats2d, args, kw))
            return torch.zeros_like(feats2d)

        plain = projection.fuse_views_backward_batch_plain
        projection.fuse_views_backward_batch_plain = zeroed
        try:
            zero, _ = program_steps(cfg, params, batches, draws)
        finally:
            projection.fuse_views_backward_batch_plain = plain
        return {"cfg": cfg, "prog": prog, "opt": opt, "spans": recorded, "ref": ref, "control": control,
                "zero": zero, "k3b_call": calls[0]}
    finally:
        torch.set_num_threads(threads)


def test_three_steps_match_the_plain_reference(runs):
    numbers = compare(runs["prog"], runs["ref"])
    assert numbers["leaves"] > 400 and numbers["leaves_moving"] > 400  # the ENet's ~430 leaves among them
    assert passes(numbers), numbers


def test_zeroed_k3b_fails_the_comparison(runs):
    """With the fusion's gradient zeroed the ENet keeps only its weight
    decay: its leaves' gradients and changes miss the reference's."""
    numbers = compare(runs["zero"], runs["ref"])
    assert not passes(numbers), numbers
    assert numbers["grad_gap"] > 100 * TOL["grad_gap"], numbers


def test_the_float8_control_fails_the_rpn_loss(runs):
    """The reference with its operands cast to float8 misses its own RPN
    loss by far more than the program does."""
    numbers = compare(runs["control"], runs["ref"])
    ours = compare(runs["prog"], runs["ref"])
    assert numbers["rpn_loss_gap"] > 100 * TOL["rpn_loss_gap"], numbers
    assert numbers["rpn_loss_gap"] > 100 * ours["rpn_loss_gap"], (numbers, ours)


def test_the_kind_keeps_the_checked_steps_rpn_losses(monkeypatch):
    """``TrainStepRPN`` keeps the RPN loss of each step set-up runs (the
    checked steps), and the window's steps run the step unwrapped."""
    parts = {k: torch.tensor(float(i + 1)) for i, k in enumerate(train_step_rpn.RPN_KEYS)}

    def setup(self):
        self.step = lambda opt, batch, **kw: dict(parts, total_loss=torch.tensor(20.0))
        for _ in range(3):
            self.step(None, None, draws=None)

    monkeypatch.setattr(train_step.TrainStep, "setup", setup)
    kind = train_step_rpn.TrainStepRPN({"train": {}}, {"batch": 2}, 1, device="cpu")
    kind.setup()
    assert [float(x) for x in kind.rpn_losses] == [10.0] * 3
    kind.step(None, None, draws=None)
    assert len(kind.rpn_losses) == 3
    del kind.step
    assert not hasattr(kind, "_unwrapped")


def test_the_reference_fusion_splits_ties_as_the_port():
    """Two views alike (the same pose, depths and features) tie at every
    voxel they accept; with a third view, the reference's autograd gradient
    equals the port's plain K3b (``torch.maximum``'s 0.5 / 0.5 split at
    each tied step of the view max), and each twin takes half of what one
    of them alone would."""
    rng = np.random.RandomState(3)
    dims, vox, intr = (8, 6, 8), 0.25, [[F, 0, 2.5, 0], [0, F, 2.0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :3, 3] = [[1.0, 0.8, -1.0], [1.0, 0.8, -1.0], [0.8, 0.6, -0.5]]
    depths = torch.from_numpy(rng.uniform(1.0, 2.5, (3, 4, 5)).astype(np.float32))
    depths[1] = depths[0]
    feats = torch.from_numpy(rng.randn(3, 4, 5, 8).astype(np.float32))
    feats[1] = feats[0]
    w2g = np.diag([4.0, 4.0, 4.0, 1.0]).astype(np.float32)
    cot = torch.from_numpy(rng.randn(*dims, 8).astype(np.float32))

    def reference_grad(f, p, d):
        f = f.clone().requires_grad_(True)
        out = G.fuse_views(f, d, p, w2g, intr, dims, 0.1, 4.0, vox)
        (grad,) = torch.autograd.grad((out * cot).sum(), f)
        return grad

    want = projection.fuse_views_backward_plain(cot, feats, depths, poses, w2g, intr, dims, 0.1, 4.0, vox)
    got = reference_grad(feats, poses, depths)
    assert float(got.abs().sum()) > 0
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    alone = reference_grad(feats[[0, 2]], poses[[0, 2]], depths[[0, 2]])
    assert torch.allclose(got[0] + got[1], alone[0], atol=1e-6) and torch.allclose(got[0], got[1])


def _children(recorded, parent):
    return [s for s in recorded if s.parent is parent]


def test_the_step_records_the_enet_fusion_and_update_spans(runs):
    """Each step: ``train.enet`` then ``train.fuse`` inside ``train.color``
    (inside ``train.forward``); in the backward (on the CPU the caller's
    thread, so inside ``train.backward``) ``train.fuse_bwd`` and after it
    ``train.enet_bwd``; ``train.update`` with the tensors it moved."""
    recorded, opt = runs["spans"], runs["opt"]
    roots = [s for s in recorded if s.name == "train.step"]
    assert len(roots) == STEPS
    trainable = opt.trainable()
    for root in roots:
        forward, backward, update = _children(recorded, root)
        color = [s for s in _children(recorded, forward) if s.name == "train.color"]
        assert len(color) == 1
        assert [s.name for s in _children(recorded, color[0])] == ["train.enet", "train.fuse"]
        bwd = _children(recorded, backward)
        assert [s.name for s in bwd] == ["train.fuse_bwd", "train.enet_bwd"]
        assert bwd[0].end_ns <= bwd[1].start_ns and bwd[1].end_ns <= backward.end_ns
        assert {s.request for s in bwd} == {root.request}
        assert update.name == "train.update"
        assert update.attrs == {"tensors": len(trainable)}
    assert sum("enet" in k for k in trainable) > 400


def test_on_the_cpu_the_step_never_captures_its_enet(runs):
    """The CPU step runs its ENet eagerly every step: a ``train.enet`` a
    step, none holding a ``train.enet_replay`` or ``train.enet_capture``
    (``train/enet_graph.py``)."""
    names = [s.name for s in runs["spans"]]
    assert names.count("train.enet") == STEPS
    assert not {"train.enet_replay", "train.enet_capture"} & set(names)


def test_off_the_enet_backward_span_registers_no_hook():
    feats = torch.ones(3, requires_grad=True) * 2
    w = torch.ones(2, requires_grad=True)
    tracing.backward_span("train.enet_bwd", feats, [w])
    assert feats._backward_hooks is None and w._backward_hooks is None


def test_a_backward_span_whose_leaf_takes_no_gradient_leaves_nothing_behind():
    """The output's gradient comes, one of the two leaves' never does: no
    span is written, no thread's stack keeps one, and the next call of the
    name removes the hooks the first left."""
    w1, w2 = torch.ones(2, requires_grad=True), torch.ones(2, requires_grad=True)
    tracing.clear()
    with tracing.recording(), tracing.span("outer") as outer:
        out = w1 * 2 + w2.detach()
        tracing.backward_span("test.bwd", out, [w1, w2])
        out.sum().backward()
        assert w1.grad is not None and w2.grad is None
        assert tracing._this_thread().stack == [outer]
        x = torch.ones(2, requires_grad=True)
        tracing.backward_span("test.bwd", x * 1, [])  # no leaf to close on: registers nothing
    assert [s.name for s in tracing.spans()] == ["outer"]
    assert not w1._backward_hooks and not w2._backward_hooks and not x._backward_hooks


def test_an_enet_no_loss_reaches_takes_no_backward_hook():
    """The ScanNet stage (FIX_ENET False, the RPN and the classifier frozen,
    the mask FCN on the TSDF alone): the ENet trains but no loss reaches
    it, so a traced step registers nothing on its parameters."""
    cfg = small_config()
    cfg["train"].update(FIX_RPN=True, FIX_CLASS=True, FIX_BACKBONE=True, MASK_USE_IMAGES=False)
    params = weights.make(cfg["model"], {"file": ""}, SEED, "cpu")
    g = torch.Generator().manual_seed(5)
    anchors = (SHAPE[0] // 4) * (SHAPE[1] // 4) * (SHAPE[2] // 4) * (3 + 6)
    draws = [{"anchor": torch.rand((BATCH, 2, anchors), generator=g),
              "proposal": torch.rand((BATCH, 2, 8 + 4), generator=g)}]
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        with tracing.recording():
            _, opt = program_steps(cfg, params, [make_batch(0)], draws)
    finally:
        torch.set_num_threads(threads)
        tracing.clear()
    first = [v for k, v in opt.params.items() if k.startswith("enet.0.")]
    assert first and all(not p._backward_hooks for p in first)
    assert not any(s.name == "train.enet_bwd" for s in tracing.spans())


# --- K3b's bytes and its roofline's reader --------------------------------------------------

def _hand_case(channels=4):
    """Three views of a 1x1x3 grid through an identity camera (fx = fy = 1,
    cx = cy = 0) and 2x2 depth maps: view 0 accepts voxel z = 1 at pixel 0
    (depth 1), view 1 voxel z = 2 at pixel 0 (depth 2), view 2 would accept
    z = 1 but is not valid. So 2 voxels and 2 (view, pixel) rows."""
    depths = torch.zeros((3, 2, 2))
    depths[0, 0, 0], depths[1, 0, 0], depths[2, 0, 0] = 1.0, 2.0, 1.0
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    intr = [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    args = (depths, poses, np.eye(4, dtype=np.float32), np.array([True, True, False]), intr, (1, 1, 3), 0.1, 4.0,
            0.5)
    by_hand = 3 * 2 * 2 * channels * 4 + 3 * 2 * 2 * 4 + 3 * (12 * 4 + 1) + (2 + 2) * channels * 4
    return args, by_hand


def test_k3b_bytes_by_hand():
    args, by_hand = _hand_case()
    assert k3b.accepted(*args) == (2, 2)
    assert k3b.sample_bytes(*args, channels=4) == by_hand == 451


def test_k3b_bytes_equal_chip_smokes_on_the_steps_call(runs):
    """The step's one K3b call (the plain backward's arguments, recorded):
    the per-sample bytes summed equal ``chip_smoke.py::k3b_bound``'s."""
    grad_out, feats2d, args, kw = runs["k3b_call"]
    depths, poses, w2g, intrinsic, dims, dmin, dmax, vox = args
    valid = kw["view_valid"]
    ours = sum(k3b.sample_bytes(depths[i], poses[i], w2g[i], valid[i], intrinsic, dims, dmin, dmax, vox,
                                feats2d.shape[-1]) for i in range(feats2d.shape[0]))
    theirs = chip_smoke.k3b_bound(dict(grad_out=grad_out, feats2d=feats2d, depths=depths, poses=poses,
                                       world_to_grid=w2g, intrinsic=intrinsic, volume_dims=dims, depth_min=dmin,
                                       depth_max=dmax, voxel_size=vox, view_valid=valid))[2]
    assert ours == theirs
    voxels = sum(k3b.accepted(depths[i], poses[i], w2g[i], valid[i], intrinsic, dims, dmin, dmax, vox)[0]
                 for i in range(feats2d.shape[0]))
    assert voxels > 0


def test_k3b_roofline_reader_on_a_synthetic_window():
    """Two window steps over a pool of two chunks (the hand case and the
    same with view 2 valid), K3b's two kernels 30 us in the trace: the
    bytes of each step's chunks over 30 us at the card's bandwidth."""
    args, by_hand = _hand_case()
    depths, poses, w2g, valid, intr, dims, dmin, dmax, vox = args
    other = k3b.sample_bytes(depths, poses, w2g, np.ones(3, bool), intr, dims, dmin, dmax, vox, 4)
    assert other == by_hand + 4 * 4  # view 2 accepts view 0's voxel: the same union, one row more
    kind = types.SimpleNamespace(
        window_batches=[np.array([0, 1]), np.array([1, 0])], device=torch.device("cpu"),
        pool={"depths": [depths, depths], "view_valid": [torch.from_numpy(valid), torch.ones(3, dtype=torch.bool)]},
        host={"poses": [poses, poses], "world_to_grid": [w2g, w2g]},
        train_cfg={"INTRINSIC": intr, "TPU_TILE_SIZE": list(dims), "PROJ_DEPTH_MIN": dmin, "PROJ_DEPTH_MAX": dmax,
                   "VOXEL_SIZE": vox})
    trace = {"kernels": [("void k3b_list_pass(float const*)", 0.0, 10.0), ("void k3b_grad_pass<4>(float const*)",
                                                                          10.0, 30.0), ("fuse_views_kernel", 30, 90)],
             "host": [], "window": (0.0, 100.0)}
    ctx = {"kind": kind, "cfg": {"model": {"NUM_IMAGE_CHANNELS": 4}}, "trace": trace}
    read = harness.reader("k3b_roofline.train")
    want = 100.0 * (2 * by_hand + 2 * other) / PEAKS["hbm_bytes_per_s"] / 30e-6
    assert read(ctx) == pytest.approx(want, rel=1e-12)
    assert read(dict(ctx, trace=None)) is None
    assert read(dict(ctx, trace=dict(trace, kernels=trace["kernels"][2:]))) is None  # a step without K3b
