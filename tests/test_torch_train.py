"""The port's training slice against the JAX package's, on the CPU.

(a) three train steps of ``build_train_step`` against the JAX package's, in
float32, with the same weights, batch and per-step draws (the JAX step's own
``jax.random`` draws): every metric of every step within 1e-4 relative and
the final parameters within 1e-4 of each parameter's largest magnitude;
geometry-only and with the color stream (2D feature images, fused by K3's
plain version); (b) the non-finite guard and the freezes of
``rpn_class_mask_5.yml``; (c) the SGD update, the LR schedule and
``param_groups``; (d) snapshots in both directions; (e) ``pad_sample``,
``paint_mask_canvas`` and ``Logger``'s JSONL; (f) ``Trainer``: train,
snapshot, resume and validate, what it refuses, and a step with the ENet
trained (the entry module's train mode runs in
``tests/test_torch_imports.py``). ``tests/test_torch_train_enet.py`` runs
the three steps with the ENet trained through the view fusion
(``FIX_ENET: False``: the ENet's weights, PReLU slopes and BatchNorm
statistics held too) and on the SUNCG backbone.
"""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dsis.config import default_config as jax_default_config
from tpu3dsis.io import dataset as jax_dataset
from tpu3dsis.models import Detector as JaxDetector
from tpu3dsis.train import checkpoint as jax_ckpt
from tpu3dsis.train import solver as jax_solver
from tpu3dsis.train.trainstep import TrainState
from tpu3dsis.train.trainstep import build_train_step as jax_build_train_step
from tpu3dsis.utils.logger import Logger as JaxLogger
from tpu3dsis_torch import checkpoint as ckpt
from tpu3dsis_torch.config import DetectorConfig, default_config
from tpu3dsis_torch.io import dataset as port_dataset
from tpu3dsis_torch.io import write_chunk_file
from tpu3dsis_torch.models.detector import Detector
from tpu3dsis_torch.train import solver
from tpu3dsis_torch.train.trainstep import anchor_count, build_train_step
from tpu3dsis_torch.utils.logger import Logger

SHAPE = (32, 16, 32)
BATCH = 2
STEPS = 3
F = 6.0  # focal length in pixels of the 5x4 feature maps


def tiny_cfg(base, color=False, enet=False, net="ScanNet_Backbone", mask_color=False, no_rpn=False):
    """``tiny_ci.yml``'s capacities on the ScanNet (or SUNCG) detector, 16^3
    mask canvas; with ``color`` the color stream on 5x4 feature images, and
    with ``enet`` on 2 views of 40x32 images through a trained ENet
    (``FIX_ENET: False``); with ``mask_color`` the mask FCN's color branch
    (``MASK_USE_IMAGES``) too; with ``no_rpn`` no RPN (``USE_RPN: False``:
    the gt boxes are the proposals)."""
    cfg = base
    anchors = {"ScanNet_Backbone": (3, 11, "scannet14_3.txt", "scannet14_11.txt"),
               "SUNCG_Backbone": (3, 6, "suncg9_3.txt", "suncg9_6.txt")}[net]
    for k, v in dict(NUM_CLASSES=19, NORMALIZE_WEIGHTS=[0.3] + [1.0] * 18, LABEL_MAP="", NET=net,
                     MASK_BACKBONE="MaskBackbone", NUM_ANCHORS_LEVEL1=anchors[0], NUM_ANCHORS_LEVEL2=anchors[1],
                     NUM_ANCHORS_LEVEL3=0, ANCHORS_TYPE_LEVEL1=anchors[2], ANCHORS_TYPE_LEVEL2=anchors[3],
                     CLASS_POOLING_SIZE=4, USE_MASK=True, USE_RPN=True, USE_CLASS=True, RPN_BATCHSIZE=16,
                     CLASS_BATCH_SIZE=8, TPU_MAX_GT=4, TPU_MAX_MASK_ROIS=2, RPN_POSITIVE_OVERLAP=0.35,
                     RPN_NEGATIVE_OVERLAP=0.15, LEARNING_RATE=0.01, TPU_MASK_CANVAS=[16, 16, 16]).items():
        cfg[k] = v
    cfg.TRAIN.RPN_PRE_NMS_TOP_N = 32
    cfg.TRAIN.RPN_POST_NMS_TOP_N = 8
    cfg.TRAIN.RPN_NMS_THRESH = 0.5
    if color or enet:
        cfg.update(USE_IMAGES=True, USE_IMAGES_GT=True, NUM_IMAGES=3, IMAGE_SHAPE=[5, 4], DEPTH_SHAPE=[5, 4],
                   VOXEL_SIZE=0.25, INTRINSIC=[[F, 0, 2.5, 0], [0, F, 2.0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    if enet:
        cfg.update(USE_IMAGES_GT=False, FIX_ENET=False, NUM_IMAGES=2, IMAGE_SHAPE=[40, 32])
    if mask_color:
        cfg.MASK_USE_IMAGES = True
    if no_rpn:
        cfg.USE_RPN = False
    return cfg


def make_batch(seed, color=False, enet=False):
    """Objects as solid boxes in noise (distinct scores), their gt boxes and
    a random mask canvas inside each box; with color, three 5x4 views of
    128-channel features looking into the volume; with enet, two views of
    40x32 uint8 images (normalised on the device; their ENet features are
    5x4)."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((BATCH, 4, 7), np.float32)
    gt[..., :3] = -1e4
    gt[..., 3:6] = -1e4 + 1
    valid = np.zeros((BATCH, 4), bool)
    data = rng.randn(BATCH, *SHAPE, 2).astype(np.float32) * 0.5
    canvas = np.zeros((BATCH, *SHAPE), np.float32)
    boxes = [[4, 4, 4, 12, 12, 12, 3], [14, 2, 10, 26, 12, 20, 5], [2, 1, 16, 20, 14, 30, 7]]
    for b in range(BATCH):
        for j, box in enumerate(boxes[:2 + b]):
            gt[b, j], valid[b, j] = box, True
            x0, y0, z0, x1, y1, z1 = box[:6]
            canvas[b, x0:x1, y0:y1, z0:z1] = rng.rand(x1 - x0, y1 - y0, z1 - z0) > 0.3
            data[b, x0:x1, y0:y1, z0:z1, 0] += 1.5
    batch = {"data": data, "gt_box": gt, "gt_valid": valid, "mask_canvas": canvas}
    if color or enet:
        v = 2 if enet else 3
        poses = np.tile(np.eye(4, dtype=np.float32), (BATCH, v, 1, 1))
        poses[..., :3, 3] = [[4.0, 2.0, -1.0], [3.5, 2.5, -1.5], [4.5, 2.0, -2.0]][:v]
        images = (rng.randint(0, 256, (BATCH, v, 32, 40, 3)).astype(np.uint8) if enet
                  else rng.randn(BATCH, v, 4, 5, 128).astype(np.float32))
        batch.update(images=images, depths=rng.uniform(1.0, 3.5, (BATCH, v, 4, 5)).astype(np.float32), poses=poses,
                     world_to_grid=np.tile(np.diag([4.0, 4.0, 4.0, 1.0]).astype(np.float32), (BATCH, 1, 1)),
                     view_valid=np.array([[True, True], [False, True]] if enet
                                         else [[True, True, True], [True, False, True]]))
    return batch


def jax_step_draws(key, n_anchor, n_cand):
    """The uniform draws the JAX step makes from `key`: per sample
    split(key, B) -> (k_anchor, k_prop), each split again into the fg and
    the bg draw."""
    out = {"anchor": [], "proposal": []}
    for k in jax.random.split(key, BATCH):
        ka, kp = jax.random.split(k)
        out["anchor"].append([np.asarray(jax.random.uniform(kk, (n_anchor,))) for kk in jax.random.split(ka)])
        out["proposal"].append([np.asarray(jax.random.uniform(kk, (n_cand,))) for kk in jax.random.split(kp)])
    return {k: np.asarray(v) for k, v in out.items()}


# the three-step cases: geometry, the color stream (feature images, frozen
# ENet path), a trained ENet through the view fusion (FIX_ENET False), the
# SUNCG backbone with the color stream, the trained ENet with the mask
# FCN's color branch (MASK_USE_IMAGES), and no RPN (USE_RPN False). The last
# four are the fixture's params in tests/test_torch_train_enet.py,
# tests/test_torch_train_mask_color.py and tests/test_torch_train_no_rpn.py,
# which run this module's three-step tests on them, so that test workers of
# their own take their JAX compiles.
KINDS = {"geometry": {}, "color": {"color": True}, "enet": {"enet": True},
         "suncg": {"color": True, "net": "SUNCG_Backbone"}, "mask_color": {"enet": True, "mask_color": True},
         "no_rpn": {"no_rpn": True}}
# kinds whose ENet starts from the trained color fixture's, as a shipped
# config's PRETRAINED_ENET_PATH has it, and kinds that take one step, not
# three, and whose JAX step XLA compiles without its fusion pass and LLVM
# without optimisation: their compile is the test's cost (see
# test_torch_train_mask_color.py)
PRETRAINED_ENET = {"mask_color"}
ONE_STEP = {"mask_color", "no_rpn"}


@pytest.fixture(scope="module", params=["geometry", "color"])
def three_steps(request):
    """Both packages' metrics over three steps, and their final params."""
    return _three_steps(request.param)


@functools.cache
def _three_steps(name):
    kind = KINDS[name]
    color = kind.get("color", False) or kind.get("enet", False)
    jcfg, tcfg = tiny_cfg(jax_default_config(), **kind), tiny_cfg(default_config(), **kind)
    jdet = JaxDetector(jcfg, anchor_dir="experiments/anchors")
    # the port's seeded initialisation, handed to the JAX package (its own
    # init_params takes ~15 s on the CPU)
    det = Detector(DetectorConfig.from_cfg(tcfg), device="cpu", param_dtype=torch.float32)
    # copies: a 1-D parameter's array shares memory with the tensor the step updates in place
    det.init_params(torch.Generator().manual_seed(0))
    if name in PRETRAINED_ENET:
        with np.load("tests/fixtures/color_loop_params.npz") as fx:
            ckpt.load_jax_params(det.enet, {k[len("enet."):]: fx[k] for k in fx.files if k.startswith("enet.")})
    init = {k: v.copy() for k, v in ckpt.module_params(det).items()}
    assert set(init) == set(jdet.param_names())
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_init, step = build_train_step(det, tcfg, SHAPE)
    opt = opt_init()
    jinit, jstep = jax_build_train_step(jdet, jcfg, SHAPE)
    state = TrainState(params=params, opt=jinit(params))
    n_anchor = anchor_count(det, SHAPE)
    jm, tm = [], []
    for i in range(1 if name in ONE_STEP else STEPS):
        batch = make_batch(i, color, kind.get("enet", False))
        key = jax.random.PRNGKey(10 + i)
        if i == 0 and (kind.get("enet") or name in ONE_STEP):
            # the same step compiled without XLA's fusion pass, which on the
            # CPU takes minutes over the trained ENet's ~430 small parameters
            options = {"xla_disable_hlo_passes": "fusion"}
            if name in ONE_STEP:
                options["xla_backend_optimization_level"] = 0
            jstep = jstep.lower(state, batch, key).compile(compiler_options=options)
        state, m = jstep(state, batch, key)
        jm.append({k: float(v) for k, v in m.items()})
        # the proposal targets' candidates: 8 proposals (without the RPN the 4 gt boxes), then the 4 gt boxes
        n_cand = (4 if kind.get("no_rpn") else 8) + 4
        tm.append({k: float(v) for k, v in step(opt, batch, draws=jax_step_draws(key, n_anchor, n_cand)).items()})
    return jm, tm, {k: np.asarray(v) for k, v in state.params.items()}, ckpt.module_params(det), int(opt.step), init


def test_three_steps_match_jax_metrics(three_steps):
    jm, tm, _, _, opt_step, _ = three_steps
    assert opt_step == len(jm) == len(tm)
    for want, got in zip(jm, tm):
        assert set(got) == set(want)
        assert want["step_finite"] == 1.0 and want["loss_mask"] > 0 and want["cross_entropy"] > 0
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k], w)


def test_three_steps_match_jax_params(three_steps):
    _, _, want, got, _, init = three_steps
    assert set(got) == set(want)
    for k, w in want.items():
        # every weight moves (weight decay at least); a bias behind a dead ReLU may not
        assert k.endswith("bias") or not np.array_equal(w, init[k]), f"{k} did not move"
        assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max(), k


def test_nonfinite_step_changes_nothing():
    cfg = tiny_cfg(default_config())
    det = Detector(DetectorConfig.from_cfg(cfg), device="cpu", param_dtype=torch.float32)
    det.init_params(torch.Generator().manual_seed(0))
    opt_init, step = build_train_step(det, cfg, SHAPE)
    opt = opt_init()
    before = {k: v.clone() for k, v in det.state_dict().items()}
    bad = make_batch(0)
    bad["data"][0, 0, 0, 0, 0] = np.nan
    m = step(opt, bad, generator=torch.Generator().manual_seed(0))
    assert float(m["step_finite"]) == 0.0 and int(opt.step) == 0
    assert all(torch.equal(v, before[k]) for k, v in det.state_dict().items())
    assert all(not m.any() for m in opt.momentum.values())
    m = step(opt, make_batch(0), generator=torch.Generator().manual_seed(0))
    assert float(m["step_finite"]) == 1.0 and int(opt.step) == 1
    assert any(not torch.equal(v, before[k]) for k, v in det.state_dict().items())


def test_rpn_class_mask_5_trains_the_mask_head_only():
    """``rpn_class_mask_5.yml``'s freezes: the backbone, RPN and classifier
    keep their weights, no RPN or class loss is taken, the mask head moves."""
    cfg = tiny_cfg(default_config())
    cfg.update(FIX_BACKBONE=True, FIX_RPN=True, FIX_CLASS=True)
    det = Detector(DetectorConfig.from_cfg(cfg), device="cpu", param_dtype=torch.float32)
    det.init_params(torch.Generator().manual_seed(1))
    opt_init, step = build_train_step(det, cfg, SHAPE)
    opt = opt_init()
    before = {k: v.clone() for k, v in det.named_parameters()}
    m = step(opt, make_batch(1), generator=torch.Generator().manual_seed(0))
    assert set(m) == {"loss_mask", "mask_windows_dropped", "total_loss", "step_finite"}
    for k, v in det.named_parameters():
        assert torch.equal(v, before[k]) != k.startswith("mask_backbone."), k


def test_sgd_and_schedule_match_jax():
    """Three updates of mixed groups (weights, biases, frozen, NYUV2
    unfreeze) equal the JAX solver's on the same gradients, LR decays
    included; a non-finite flag changes nothing."""
    cfg, jcfg = default_config(), jax_default_config()
    for c in (cfg, jcfg):
        c.update(LEARNING_RATE=0.1, MOMENTUM=0.9, WEIGHT_DECAY=0.01, DOUBLE_BIAS=True, BIAS_DECAY=False,
                 STEPSIZE=[1, 2], GAMMA=0.3, FIX_BACKBONE=True, NYUV2_FINETUNE=True, FIX_CLASS=True)
    rng = np.random.RandomState(0)
    names = ["rpn_net_level1.weight", "rpn_net_level1.bias", "geometry1.0.weight", "classifier.4.weight",
             "classifier.0.weight", "mask_backbone.geometry.0.weight", "classifier_bbox_pred_net.bias"]
    init = {k: rng.randn(3, 4).astype(np.float32) for k in names}
    assert solver.param_groups(names, cfg) == jax_solver.param_groups(names, jcfg)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = solver.SGD(params.items(), cfg)
    jinit, jupdate = jax_solver.make_solver(jcfg, names)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jinit(jparams)
    for i in range(3):
        grads = {k: rng.randn(3, 4).astype(np.float32) for k in names}
        upd, jstate = jupdate({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = jax_solver.apply_updates(jparams, upd)
        opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, torch.tensor(True))
        for k in names:
            np.testing.assert_array_equal(params[k].numpy(), np.asarray(jparams[k]), err_msg=f"step {i} {k}")
            np.testing.assert_array_equal(opt.momentum[k].numpy(), np.asarray(jstate.momentum[k]))
        assert float(opt.lr()) == float(jax_solver.lr_at_step(jstate.step + 1, jcfg))
    for step in (0, 1, 2, 3, 10):
        assert solver.lr_at_step(step, cfg) == np.float32(jax_solver.lr_at_step(jnp.asarray(step), jcfg))
    frozen = {k: v.clone() for k, v in params.items()}
    opt.update({k: torch.full((3, 4), float("nan")) for k in names}, torch.tensor(False))
    assert all(torch.equal(params[k], frozen[k]) for k in names) and int(opt.step) == 3


def test_snapshots_load_across_packages(tmp_path):
    rng = np.random.RandomState(1)
    params = {"geometry1.0.weight": rng.randn(2, 2, 2, 2, 4).astype(np.float32),
              "classifier.0.bias": rng.randn(5).astype(np.float32)}
    momentum = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
    port = ckpt.save_snapshot(str(tmp_path / "port"), 7, params, momentum, 6)
    p, m, s = jax_ckpt.load_snapshot(port)
    assert s == 6 and all(np.array_equal(p[k], params[k]) and np.array_equal(m[k], momentum[k]) for k in params)

    class Opt:
        pass

    opt = Opt()
    opt.momentum, opt.step = {k: jnp.asarray(v) for k, v in momentum.items()}, jnp.asarray(6, jnp.int32)
    jpath = jax_ckpt.save_snapshot(str(tmp_path / "jax"), 7, params, opt)
    with open(port, "rb") as a, open(jpath, "rb") as b:
        ours, theirs = np.load(a), np.load(b)
        assert sorted(ours.files) == sorted(theirs.files)
        for k in ours.files:
            assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k
    p, m, s = ckpt.load_snapshot(jpath)
    assert s == 6 and all(np.array_equal(m[k], momentum[k]) for k in params)
    for step in (9, 11, 12):
        ckpt.save_snapshot(str(tmp_path / "port"), step, params)
    assert ckpt.find_previous(str(tmp_path / "port"), [10]) == jax_ckpt.find_previous(str(tmp_path / "port"), [10])
    assert ckpt.snapshot_step(jpath) == jax_ckpt.snapshot_step(jpath) == 7
    ckpt.prune_snapshots(str(tmp_path / "port"), 2)
    assert sorted(os.listdir(tmp_path / "port")) == ["step_11.npz", "step_12.npz"]


def test_pad_sample_and_canvas_are_the_jax_packages(tmp_path):
    """Byte-equal, with and without frames, for boxes past the volume."""
    rng = np.random.RandomState(2)
    boxes = np.array([[2, 1, 3, 10, 7, 9, 4], [20, 8, 24, 36, 20, 40, 5], [-3, 0, 0, 4, 4, 4, 6]], np.float32)
    masks = [(rng.rand(*(b[3:6] - b[:3]).astype(int)) > 0.5).astype(np.uint8) for b in boxes]
    kw = dict(sample_id="s", data=rng.randn(*SHAPE, 2).astype(np.float32), gt_box=boxes, gt_mask=masks,
              world_to_grid=np.eye(4, dtype=np.float32), frame_ids=np.zeros(2, np.uint32),
              images=rng.randint(0, 255, (2, 4, 5, 3)).astype(np.uint8), depths=rng.rand(2, 4, 5).astype(np.float32),
              poses=np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)))
    for use_images in (False, True):
        cfg, jcfg = default_config(), jax_default_config()
        for c in (cfg, jcfg):
            c.update(TPU_MAX_GT=4, USE_IMAGES=use_images, NUM_IMAGES=3)
        got = port_dataset.pad_sample(port_dataset.Sample(**kw), cfg)
        want = jax_dataset.pad_sample(jax_dataset.Sample(**kw), jcfg)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    assert port_dataset.paint_mask_canvas(port_dataset.Sample(**kw)).tobytes() == \
        jax_dataset.paint_mask_canvas(jax_dataset.Sample(**kw)).tobytes()


def test_logger_jsonl_is_the_jax_packages(tmp_path, no_tensorboard):
    lines = {}
    for name, cls in (("port", Logger), ("jax", JaxLogger)):
        log = cls(str(tmp_path / name))
        assert log._tb is None
        log.scalar_summary("total_loss", np.float32(1.25), 3)
        log.histo_summary("w", np.arange(10.0), 3)
        log.close()
        with open(tmp_path / name / "metrics.jsonl") as f:
            lines[name] = [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 2


def write_chunks(tmp_path, n=3):
    """`.chunk` files of one solid object each with its box and mask
    (``tests/test_integration.py``'s recipe)."""
    rng = np.random.RandomState(0)
    paths = []
    for i in range(n):
        sdf = (rng.randn(*SHAPE) * 2).astype(np.float32)
        sdf[4:12, 3:10, 5:13] = 0.2
        p = str(tmp_path / f"s{i}__0__.chunk")
        write_chunk_file(p, sdf, np.array([[4, 3, 5, 12, 10, 13]], np.float64), np.array([5], np.uint32),
                         [np.ones((8, 7, 8), np.uint16)], np.ones(1, np.float32), np.eye(4, dtype=np.float32),
                         np.zeros(0, np.uint32))
        paths.append(p)
    filelist = tmp_path / "train.txt"
    filelist.write_text("".join(p + "\n" for p in paths))
    return str(filelist)


@pytest.fixture
def no_tensorboard(monkeypatch):
    """TensorBoard's import fails, so the loggers write JSONL only (where
    TensorFlow is installed, TensorBoard imports it, and it imports JAX)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_trainer_trains_snapshots_resumes_and_validates(tmp_path, no_tensorboard):
    from tpu3dsis_torch.infer.validate import ChunkValidator
    from tpu3dsis_torch.io import SceneDataset
    from tpu3dsis_torch.train.loop import Trainer

    cfg = tiny_cfg(default_config())
    filelist = write_chunks(tmp_path)
    cfg.update(TRAIN_FILELIST=filelist, VAL_FILELIST=filelist, TRAINVAL_FILELIST="", KEEP_THRESH=0.0,
               TPU_DATA_PARALLEL=1, VAL_TIME=0.0, SNAPSHOT_KEPT=2, CLASS_THRESH=0.0, ROI_THRESH=0.0, DISPLAY=2,
               TPU_TILE_SIZE=list(SHAPE))
    cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_POST_NMS_TOP_N = 64, 8
    out = str(tmp_path / "run")
    trainer = Trainer(cfg, out, device="cpu")
    opt, step = trainer.train(epochs=2, max_steps=4)
    assert step == 4 and int(opt.step) == 4
    assert os.listdir(trainer.checkpoint_dir) == ["step_4.npz"]
    with open(os.path.join(out, "logs", "train", "metrics.jsonl")) as f:
        tags = {k for line in f for k in json.loads(line) if k not in ("ts", "step")}
    assert {"total_loss", "rpn_cross_entropy_level1", "cross_entropy", "loss_mask", "step_finite"} <= tags
    # the snapshot loads in the JAX package, and a second trainer resumes from it
    p, m, s = jax_ckpt.load_snapshot(os.path.join(trainer.checkpoint_dir, "step_4.npz"))
    assert s == 4 and set(p) == set(m) == set(ckpt.module_params(trainer.detector))
    trainer2 = Trainer(cfg, out, device="cpu")
    opt2, step2 = trainer2.restore_or_init()
    assert step2 == 4 and int(opt2.step) == 4
    assert all(torch.equal(a, b) for a, b in zip(trainer.detector.state_dict().values(),
                                                  trainer2.detector.state_dict().values()))
    assert all(torch.equal(opt.momentum[k], opt2.momentum[k]) for k in opt.momentum)
    _, step3 = trainer2.train(epochs=1, max_steps=1)
    assert step3 == 5 and sorted(os.listdir(trainer.checkpoint_dir)) == ["step_4.npz", "step_5.npz"]
    res = ChunkValidator(trainer2.detector, cfg, SHAPE).run(SceneDataset(filelist, "chunk", cfg), max_samples=2)
    assert set(res) == {"AP_ROI", "mAP_CLASSIFICATION", "mAP_MASK"} and all(0.0 <= v <= 1.0 for v in res.values())


def test_trainer_refuses_what_is_not_ported(tmp_path, monkeypatch, capsys, no_tensorboard):
    """``TPU_DATA_PARALLEL: 2`` is the global batch: one process on the CPU
    loads both chunks a step, and the batch is clamped to the cards present
    (here one) with a note; the JAX package's launch variables join a
    process group (here of one process, over gloo), whose step takes the
    all-reduce; ``MASK_USE_IMAGES`` without the color stream raises; the
    ENet trains (``FIX_ENET: False``) and its snapshots resume across
    packages."""
    import socket

    import torch.distributed as dist

    from tpu3dsis_torch.parallel import distributed as pdist
    from tpu3dsis_torch.train.loop import Trainer

    cfg = tiny_cfg(default_config())
    cfg.update(TPU_DATA_PARALLEL=2, TPU_TILE_SIZE=list(SHAPE))
    trainer = Trainer(cfg, str(tmp_path), device="cpu")
    assert (trainer.n_dp, trainer.local_batch, trainer.process_count, trainer.group) == (2, 2, 1, None)
    with monkeypatch.context() as m:
        m.setattr(pdist, "card_count", lambda device: 1)
        trainer = Trainer(cfg, str(tmp_path), device="cpu")
    assert (trainer.n_dp, trainer.local_batch) == (1, 1)
    assert "TPU_DATA_PARALLEL=2 clamped to the 1 card(s) present" in capsys.readouterr().out
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for k, v in (("TPU3DSIS_COORDINATOR", f"127.0.0.1:{port}"), ("TPU3DSIS_NUM_PROCESSES", "1"),
                 ("TPU3DSIS_PROCESS_ID", "0")):
        monkeypatch.setenv(k, v)
    try:
        trainer = Trainer(cfg, str(tmp_path), device="cpu")
        assert trainer.group is dist.group.WORLD and dist.get_backend() == "gloo"
        assert (trainer.n_dp, trainer.local_batch, trainer.process_id, trainer.process_count) == (2, 2, 0, 1)
        opt = trainer.init_state(seed=0)
        m = trainer.step_fn(opt, make_batch(0), generator=torch.Generator().manual_seed(0))
        assert float(m["step_finite"]) == 1.0 and int(opt.step) == 1
    finally:
        dist.destroy_process_group()
    for k in ("TPU3DSIS_COORDINATOR", "TPU3DSIS_NUM_PROCESSES", "TPU3DSIS_PROCESS_ID"):
        monkeypatch.delenv(k)
    mask_color = tiny_cfg(default_config())  # the mask FCN's color branch without the color stream
    mask_color.MASK_USE_IMAGES = True
    with pytest.raises(ValueError, match="MASK_USE_IMAGES needs USE_IMAGES"):
        Trainer(mask_color, str(tmp_path), device="cpu")
    # ENet training (FIX_ENET False) is ported: the trainer takes a step, and
    # the ENet's weights, slopes and statistics move
    enet = tiny_cfg(default_config(), enet=True)
    enet.TPU_TILE_SIZE = list(SHAPE)
    trainer = Trainer(enet, str(tmp_path), device="cpu")
    opt = trainer.init_state(seed=0)
    before = {k: v.clone() for k, v in trainer.detector.enet.named_parameters()}
    m = trainer.step_fn(opt, make_batch(0, True, True), generator=torch.Generator().manual_seed(0))
    assert float(m["step_finite"]) == 1.0 and int(opt.step) == 1
    for k in ("4.0.0.0.weight", "4.0.0.2.weight", "4.0.0.1.running_mean", "4.0.0.1.running_var"):
        assert not torch.equal(trainer.detector.enet.get_parameter(k), before[k]), k
    # its snapshot resumes in the JAX package with the statistics and their
    # momentum, and a JAX snapshot resumes here with them
    stat = "enet.4.0.0.1.running_var"
    p, m, s = jax_ckpt.load_snapshot(trainer._snapshot(opt, 1))
    assert s == 1 and np.array_equal(p[stat], ckpt.module_params(trainer.detector)[stat])
    assert np.array_equal(m[stat], opt.momentum[stat].numpy()) and m[stat].any()

    class JaxOpt:
        momentum = {k: jnp.asarray(v) + 1.0 for k, v in m.items()}
        step = jnp.asarray(7, jnp.int32)

    jax_ckpt.save_snapshot(trainer.checkpoint_dir, 8, p, JaxOpt)
    opt2, step2 = Trainer(enet, str(tmp_path), device="cpu").restore_or_init()
    assert step2 == 7 and np.array_equal(opt2.momentum[stat].numpy(), m[stat] + 1.0)
