"""The training step: forward, targets, losses, backward and the SGD update
(``tpu3dsis/train/trainstep.py``; the reference's ``trainval.py:317-384``
and ``Network.forward``'s TRAIN branch, ``network.py:78-185``).

The JAX package traces one sample's loss and vmaps it over the batch; here
the batch runs together (one backbone and RPN pass, batched targets, one K2
launch for every sample's proposals, one K1 launch for every roi's pool and
one K1b launch for its gradient, one mask-FCN queue over every sample's
windows), and every loss is kept per sample, so the total and each metric
are the batch means the JAX step takes. Proposal selection runs under
``no_grad`` (the JAX step's ``stop_gradient``), and so does the color
stream's ENet and view fusion (K3, forward only) while ``FIX_ENET`` holds
(every shipped config). With ``FIX_ENET: False`` the ENet and each sample's
view fusion run under autograd: the ENet's float32 features are fused in
float32 (K3 forward, K3b backward on the card), and the fused volume is
then cast to the compute dtype, as in the JAX package; a cast before the
fusion would give the same forward values but ties in the backward that
float32 does not have. Under ``MASK_USE_IMAGES`` the mask FCN's windows
also crop that volume, so its cotangent is the sum of the backbone's and
the mask branch's, and one K3b launch still takes it to the ENet. On the
card the ENet over the batch's views replays from captured CUDA graphs,
its backward too where it trains (``train/enet_graph.py``); on the CPU it
runs eagerly.

The random subsampling of the targets takes uniform draws (``make_draws``):
the step makes them with a ``torch.Generator`` on the parameters' device
unless the caller passes them, as the tests do with the JAX package's own.
Parameters are updated in place (``solver.SGD``); a step whose loss or any
gradient is not finite changes nothing (the ``step_finite`` metric is 0),
frozen parameters' gradients included, as in the JAX package.

Data parallelism (the JAX step under ``shard_map``, ``trainstep.py:414``):
one process a card, each with its own share of the batch, joined in a
``torch.distributed`` process group. Each rank's gradients and metrics go
into one flat buffer, averaged over the group by one all-reduce (the JAX
``pmean``), before the guard and the update, so every rank takes the same
decision on the same numbers and its parameters stay equal to the others'.

``USE_RPN: False`` (the JAX step's ablation, ``trainstep.py:261-275``):
no RPN, and the ground-truth boxes are the proposals.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from tpu3dsis_torch.models.detector import Detector, device_anchors
from tpu3dsis_torch.models.rpn import select_proposals
from tpu3dsis_torch.ops.mask_windows import plan_windows
from tpu3dsis_torch.train import losses as L
from tpu3dsis_torch.train import targets as T
from tpu3dsis_torch.train.enet_graph import EnetFeatures
from tpu3dsis_torch.train.solver import SGD
from tpu3dsis_torch.utils import tracing


class StageTimer:
    """Milliseconds by stage of a step: CUDA events on the card (read after
    a sync), the host clock on the CPU. ``with timer("targets"):`` adds the
    block's time to its stage and, as every stage does without a timer,
    opens the recorder's span ``train.targets`` (``utils/tracing.py``),
    which it yields."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._events = []  # (stage, start, end) CUDA events not yet read
        self._ms = {}

    def _add(self, stage: str, ms: float) -> None:
        self._ms[stage] = self._ms.get(stage, 0.0) + ms

    @contextlib.contextmanager
    def __call__(self, stage: str):
        with _no_timer(stage) as sp:
            if self.cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                yield sp
                end.record()
                self._events.append((stage, start, end))
            else:
                t0 = time.perf_counter()
                yield sp
                self._add(stage, 1e3 * (time.perf_counter() - t0))

    def ms(self) -> dict:
        if self._events:
            torch.cuda.synchronize()
        for stage, start, end in self._events:
            self._add(stage, start.elapsed_time(end))
        self._events.clear()
        return dict(self._ms)


def _no_timer(stage: str):
    """A stage without a timer: its recorder span alone."""
    return tracing.span("train." + stage)


def _window_region_mask(local6: torch.Tensor, canvas) -> torch.Tensor:
    """(N, 6) boxes in window coordinates -> (N, *canvas) float32 masks."""
    dev = local6.device
    ix = torch.arange(canvas[0], device=dev)[None, :, None, None]
    iy = torch.arange(canvas[1], device=dev)[None, None, :, None]
    iz = torch.arange(canvas[2], device=dev)[None, None, None, :]
    l = local6[:, :, None, None, None]
    return ((ix >= l[:, 0]) & (ix < l[:, 3]) & (iy >= l[:, 1]) & (iy < l[:, 4])
            & (iz >= l[:, 2]) & (iz < l[:, 5])).to(torch.float32)


def _crop(vol: torch.Tensor, sample: torch.Tensor, starts: torch.Tensor, canvas) -> torch.Tensor:
    """vol (B, X, Y, Z, ...) -> (N, *canvas, ...): window n of sample
    sample[n] at starts[n] (inside the volume, as the planner places it)."""
    dev = vol.device
    ix = (starts[:, 0, None] + torch.arange(canvas[0], device=dev))[:, :, None, None]
    iy = (starts[:, 1, None] + torch.arange(canvas[1], device=dev))[:, None, :, None]
    iz = (starts[:, 2, None] + torch.arange(canvas[2], device=dev))[:, None, None, :]
    return vol[sample[:, None, None, None], ix.long(), iy.long(), iz.long()]


def _plan_queue(rois, roi_valid, scene_shape, canvas, capacity, extra_windows, allow_drop, single_window):
    """One sample's window queue (``_mask_forward_scan``'s planning, JAX
    ``trainstep.py:59-89``): a dict of starts (C, 3), locals6, own6 (C, 6),
    roi_idx, valid (C,) and dropped (a 0-d count)."""
    m = rois.shape[0]
    if tuple(canvas) == tuple(scene_shape):
        # windows degenerate to the whole volume
        if capacity is not None and capacity < m:
            # valid first, so a reduced queue drops only invalid rois where it can
            order = torch.argsort((~roi_valid).to(torch.int32), stable=True)[:capacity]
            rois, item_valid = rois[order], roi_valid[order]
            dropped = roi_valid.sum() - item_valid.sum()
            roi_idx = order.to(torch.int32)
            m = capacity
        else:
            roi_idx = torch.arange(m, dtype=torch.int32, device=rois.device)
            item_valid = roi_valid
            dropped = torch.zeros((), dtype=torch.int64, device=rois.device)
        locals6 = torch.round(rois).to(torch.int32)
        return {"starts": torch.zeros((m, 3), dtype=torch.int32, device=rois.device), "locals6": locals6,
                "own6": locals6, "roi_idx": roi_idx, "valid": item_valid, "dropped": dropped}
    return plan_windows(rois, roi_valid, scene_shape, canvas, m + extra_windows if capacity is None else capacity,
                        allow_drop=allow_drop, single_window=single_window)


def _mask_forward_scan(detector: Detector, scene, rois, roi_valid, scene_shape, canvas, imageft=None, chunk=4,
                       extra_windows=4, capacity=None, allow_drop=False, single_window=False):
    """The mask FCN over every sample's roi crop windows
    (``tpu3dsis/train/trainstep.py:43``).

    scene (B, X, Y, Z, 2); rois (B, M, 6); roi_valid (B, M); imageft (B, X,
    Y, Z, C), the color volume the mask FCN's color branch crops at each
    window's start (``MASK_USE_IMAGES``), or None. Each roi that fits the
    canvas gets one window, with the roi's region re-masked after
    every conv (the reference's exact-size crop); larger rois get halo
    windows, each exact on the segment it owns (``ops/mask_windows.py``).
    Only the valid windows of the queues run (an invalid window adds
    nothing to the loss or its gradient), in blocks of ``chunk`` windows,
    each checkpointed (recomputed in the backward pass, as
    ``jax.checkpoint`` does). Returns dict(logits (N, *canvas, NC),
    own_masks (N, *canvas), starts (N, 3), sample (N,), roi_idx (N,) into
    the batch's B*M rois, valid (N,), dropped (B,)), N the valid windows.
    """
    canvas = tuple(int(min(c, s)) for c, s in zip(canvas, scene_shape))
    b, m = rois.shape[:2]
    plans = [_plan_queue(rois[i], roi_valid[i], scene_shape, canvas, capacity, extra_windows, allow_drop,
                         single_window) for i in range(b)]
    cap = plans[0]["valid"].shape[0]
    dev = rois.device
    sample = torch.arange(b, device=dev).repeat_interleave(cap)
    cat = {k: torch.cat([p[k] for p in plans]) for k in ("starts", "locals6", "own6", "roi_idx", "valid")}
    with tracing.span("train.wait.card"):
        keep = torch.nonzero(cat["valid"])[:, 0]  # the queue's one host sync
    starts, locals6, own6 = cat["starts"][keep], cat["locals6"][keep], cat["own6"][keep]
    sample = sample[keep]
    roi_idx = cat["roi_idx"][keep].long() + sample * m

    def one_block(starts, sample, locals6):
        # the crops are made inside the block, so that its backward makes them again
        crops = _crop(scene, sample, starts, canvas)
        masks = _window_region_mask(locals6, canvas)[..., None].to(crops.dtype)
        ift = None if imageft is None else _crop(imageft, sample, starts, canvas) * masks.to(imageft.dtype)
        return detector.mask_backbone(crops * masks, region_mask=masks, training=True, imageft=ift)

    outs = [checkpoint(one_block, starts[i:i + chunk], sample[i:i + chunk], locals6[i:i + chunk],
                       use_reentrant=False) for i in range(0, keep.shape[0], chunk)]
    nc = detector.num_classes
    logits = torch.cat(outs) if outs else scene.new_zeros((0, *canvas, nc))
    return {
        "logits": logits,
        "own_masks": _window_region_mask(own6, canvas),
        "starts": starts,
        "sample": sample,
        "roi_idx": roi_idx,
        "valid": torch.ones(keep.shape[0], dtype=torch.bool, device=dev),
        "dropped": torch.stack([p["dropped"] for p in plans]),
    }


def anchor_count(detector: Detector, scene_shape) -> int:
    return sum(la.anchors.shape[0] for la in detector.level_anchors(scene_shape).values())


def make_draws(batch_size: int, num_anchors: int, num_candidates: int, generator: torch.Generator | None,
               device) -> dict:
    """The targets' uniform draws for one step: {"anchor": (B, 2, anchors),
    "proposal": (B, 2, candidates)} float32 in [0, 1)."""
    return {
        "anchor": torch.rand((batch_size, 2, num_anchors), generator=generator, device=device),
        "proposal": torch.rand((batch_size, 2, num_candidates), generator=generator, device=device),
    }


def gt_proposals(gt_box: torch.Tensor, gt_valid: torch.Tensor) -> dict:
    """``USE_RPN: False``: the ground-truth boxes are the proposals
    (network.py:149-152), scored 1 where valid and -1e9 elsewhere, on level
    1 where every dimension is at most 20 voxels, else level 2."""
    dims = gt_box[..., 3:6] - gt_box[..., :3]
    return {"rois": gt_box[..., :6], "scores": torch.where(gt_valid, 1.0, -1e9),
            "level_inds": torch.where((dims <= 20.0).all(dim=-1), 1.0, 2.0), "valid": gt_valid}


def build_loss_fn(detector: Detector, cfg, scene_shape):
    """The batch loss: f(batch, draws, timer) -> (total (0-d), {metric:
    0-d}), the batch means of the per-sample losses of the JAX
    ``build_loss_fn`` (``tpu3dsis/train/trainstep.py:161``)."""
    shape = tuple(int(s) for s in scene_shape)
    anchors = device_anchors(detector, shape)
    anchor_arrays = {lvl: a for lvl, (a, _) in anchors.items()}
    inside_masks = {lvl: inside for lvl, (_, inside) in anchors.items()}
    dev = detector.device
    class_weights = torch.tensor(cfg.NORMALIZE_WEIGHTS, dtype=torch.float32, device=dev)
    pre_n = int(cfg.TRAIN.RPN_PRE_NMS_TOP_N)
    post_n = int(cfg.TRAIN.RPN_POST_NMS_TOP_N)
    nms_thresh = float(cfg.TRAIN.RPN_NMS_THRESH)
    max_mask_rois = int(cfg.get("TPU_MAX_MASK_ROIS", 16))
    mask_extra_windows = int(cfg.get("TPU_MASK_EXTRA_WINDOWS", 4))
    mask_canvas_dims = tuple(int(c) for c in cfg.get("TPU_MASK_CANVAS", list(shape)))
    # the opt-in small-canvas queue (TPU_MASK_CANVAS_SMALL, 0s = off): rois
    # that fit it run on far fewer voxels (exact: the region-masked FCN does
    # not depend on the canvas size), the large queue takes the rest, with
    # its overflow counted in mask_windows_dropped
    mask_small_dims = tuple(int(c) for c in cfg.get("TPU_MASK_CANVAS_SMALL", [0, 0, 0]))
    use_small_canvas = all(c > 0 for c in mask_small_dims)
    max_large_rois = int(cfg.get("TPU_MAX_LARGE_MASK_ROIS", max_mask_rois))
    use_mask = bool(cfg.USE_MASK) and detector.mask_backbone is not None
    use_images = bool(cfg.USE_IMAGES)
    use_rpn = bool(cfg.USE_RPN)
    fix_rpn = bool(cfg.FIX_RPN) or not use_rpn
    fix_class = (bool(cfg.FIX_CLASS) and not cfg.NYUV2_FINETUNE) or not bool(cfg.USE_CLASS)
    # the ENet trains (FIX_ENET False): its features keep their gradient through the fusion
    train_enet = use_images and not bool(cfg.FIX_ENET) and detector.enet is not None
    # the mask FCN's color branch crops the color volume (JAX trainstep.py:310-314)
    mask_use_images = use_mask and bool(cfg.MASK_USE_IMAGES)
    # the ENet's backward span closes on its first parameters' gradients: only where a
    # trained loss reaches its features (the RPN's and the classifier's exist where they train)
    enet_grad = train_enet and (not fix_rpn or not fix_class or mask_use_images)
    enet_first = detector.enet.first_params() if enet_grad else []
    # the ENet over the batch's views: replayed from captured graphs on the card (train/enet_graph.py)
    enet_features = EnetFeatures(detector.color_projector, detector.compute_dtype) if use_images else None
    if mask_use_images and not use_images:
        raise ValueError("MASK_USE_IMAGES needs USE_IMAGES: the mask FCN's color branch reads the color volume")

    def to_dev(x, dtype=None):
        return torch.as_tensor(x).to(dev, dtype=dtype, non_blocking=True)

    def loss_fn(batch: dict, draws: dict, timer=_no_timer):
        data = to_dev(batch["data"])
        gt_box = to_dev(batch["gt_box"], torch.float32)
        gt_valid = to_dev(batch["gt_valid"], torch.bool)
        b = data.shape[0]
        imageft = None
        if use_images:
            # The ENet takes every view of the batch in one call (on the
            # card a replay of its captured graphs from the third step of a
            # batch shape on); K3 fuses each chunk's views into its volume,
            # on matrices made once for the batch. A frozen ENet (every
            # shipped config) runs without a gradient, its features cast to
            # the compute dtype before K3; a trained one keeps them float32
            # through the fusion (one K3b launch for the batch in the
            # backward), and the volume is cast.
            with torch.set_grad_enabled(train_enet), timer("color"):
                proj = detector.color_projector
                images = to_dev(batch["images"])
                with tracing.span("train.enet"):
                    feats2d = enet_features(images.reshape(-1, *images.shape[2:]))
                tracing.backward_span("train.enet_bwd", feats2d, enet_first)
                feats2d = feats2d.reshape(*images.shape[:2], *feats2d.shape[1:])
                depths = to_dev(batch["depths"], torch.float32)
                view_valid = to_dev(batch["view_valid"], torch.bool)
                with tracing.span("train.fuse"):
                    imageft = proj.project_batch(feats2d, depths, batch["poses"], batch["world_to_grid"], shape,
                                                 view_valid=view_valid).to(detector.compute_dtype)
        feats = detector.features(data, imageft)
        per_sample = {}
        rpn_out = detector.rpn_forward(feats) if use_rpn else None
        if not fix_rpn:
            with timer("targets"):
                atargets = T.anchor_targets(draws["anchor"], anchor_arrays, inside_masks, gt_box, gt_valid,
                                            int(cfg.RPN_BATCHSIZE), float(cfg.RPN_FG_FRACTION),
                                            float(cfg.RPN_POSITIVE_OVERLAP), float(cfg.RPN_NEGATIVE_OVERLAP))
            for lvl, tgt in atargets.items():
                cls_score, _, bbox_pred = rpn_out[lvl]
                ce, box = L.rpn_level_losses(cls_score, bbox_pred, tgt)
                per_sample[f"rpn_cross_entropy_level{lvl}"] = ce
                per_sample[f"rpn_loss_box_level{lvl}"] = box

        # proposals: no gradient through the selection (network.py:666-674)
        if use_rpn:
            with torch.no_grad():
                prop = select_proposals({lvl: tuple(t.detach() for t in out) for lvl, out in rpn_out.items()},
                                        anchors, shape, pre_n, post_n, nms_thresh)
        else:
            prop = gt_proposals(gt_box, gt_valid)

        if not fix_class:
            with timer("targets"):
                ptargets = T.proposal_targets(
                    draws["proposal"], prop["rois"], prop["valid"], prop["level_inds"], gt_box, gt_valid,
                    int(cfg.NUM_CLASSES), int(cfg.CLASS_BATCH_SIZE), float(cfg.FG_FRACTION),
                    float(cfg.FG_THRESH), float(cfg.BG_THRESH), float(cfg.BG_THRESH_LO), bool(cfg.USE_GT))
            cls_score, _, _, bbox_pred = detector.classify_rois(feats, ptargets["rois"], ptargets["level_inds"])
            ce, box = L.class_losses(cls_score, bbox_pred, ptargets, class_weights)
            per_sample["cross_entropy"] = ce
            per_sample["loss_box"] = box

        if use_mask:
            canvas_vol = to_dev(batch["mask_canvas"])
            with timer("targets"):
                mtargets = T.mask_targets(prop["rois"], prop["valid"], gt_box, gt_valid,
                                          float(cfg.MASK_FG_THRESH), max_mask_rois)

            def queue(valid, canvas, capacity, allow_drop, single_window=False):
                mw = _mask_forward_scan(detector, data, mtargets["rois"], valid, shape, canvas,
                                        imageft=imageft if mask_use_images else None,
                                        extra_windows=mask_extra_windows, capacity=capacity,
                                        allow_drop=allow_drop, single_window=single_window)
                win = mw["logits"].shape[1:4]
                targets = _crop(canvas_vol, mw["sample"], mw["starts"], win).to(torch.float32)  # may be uint8
                return (mw["logits"], targets, mw["own_masks"], mw["valid"], mw["roi_idx"]), mw["dropped"]

            if use_small_canvas:
                r = torch.round(mtargets["rois"]).to(torch.int32)
                small = torch.tensor(mask_small_dims, dtype=torch.int32, device=dev)
                fits = ((r[..., 3:6] - r[..., :3]) <= small).all(dim=-1)
                g_small, d_small = queue(mtargets["valid"] & fits, mask_small_dims, max_mask_rois, False,
                                         single_window=True)
                g_large, d_large = queue(mtargets["valid"] & ~fits, mask_canvas_dims,
                                         max_large_rois + mask_extra_windows, True)
                groups, dropped = [g_small, g_large], d_small + d_large
            else:
                g, dropped = queue(mtargets["valid"], mask_canvas_dims, None, False)
                groups = [g]
            per_sample["loss_mask"] = L.mask_loss_window_groups(groups, mtargets["labels"], mtargets["valid"],
                                                                class_weights, max_mask_rois)
            per_sample["mask_windows_dropped"] = dropped.to(torch.float32)

        total = sum(v for k, v in per_sample.items() if k != "mask_windows_dropped")
        if not torch.is_tensor(total):  # every loss fixed: nothing to train
            total = torch.zeros((b,), dtype=torch.float32, device=dev)
        metrics = {k: v.detach().mean() for k, v in per_sample.items()}
        metrics["total_loss"] = total.detach().mean()
        return total.mean(), metrics

    return loss_fn


def apply_step_update(opt: SGD, grads: dict, metrics: dict) -> dict:
    """The SGD update with the non-finite guard (JAX ``trainstep.py:393``):
    a non-finite loss or gradient leaves the parameters, the momentum and
    the update count as they were. ``grads`` may also hold the gradients of
    frozen parameters: the update leaves them out, the guard reads them, as
    the JAX package's reads every leaf of its gradient. Returns the metrics
    with ``step_finite``. No host sync."""
    finite = torch.isfinite(metrics["total_loss"])
    gs = [g for g in grads.values() if g is not None]
    if gs:
        # the max |g| of each gradient is finite exactly when all of it is
        finite = finite & torch.isfinite(torch.stack(torch._foreach_norm(gs, float("inf")))).all()
    opt.update(grads, finite)
    metrics = dict(metrics)
    metrics["step_finite"] = finite.to(torch.float32)
    return metrics


def all_reduce_mean(grads: list, params: list, metrics: dict, group) -> tuple[list, dict]:
    """The gradients (None for a parameter no loss reached: zeros) and the
    metrics averaged over ``group``'s ranks, with one all-reduce of one flat
    float32 buffer (the JAX step's ``pmean``). Every rank gets the same
    numbers back, the gradients as contiguous tensors of their parameters'
    shapes."""
    keys = sorted(metrics)
    parts = [g.reshape(-1).float() if g is not None else p.new_zeros(p.numel(), dtype=torch.float32)
             for g, p in zip(grads, params)]
    parts.append(torch.stack([metrics[k].float() for k in keys]))
    flat = torch.cat(parts)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    chunks = flat.split([p.numel() for p in params] + [len(keys)])
    grads = [c.view(p.shape) for c, p in zip(chunks, params)]
    return grads, dict(zip(keys, chunks[-1].unbind()))


def build_train_step(detector: Detector, cfg, scene_shape, group=None):
    """Returns (opt_init, step): ``opt_init()`` freezes the parameters the
    config fixes and returns the ``SGD`` state over the detector's float32
    parameters; ``step(opt, batch, draws=None, generator=None, timer=None)``
    runs one step on a batch (a dict of stacked per-sample arrays:
    ``pad_sample``'s, with the frames under ``USE_IMAGES``), updates the
    parameters in place and returns its metrics, 0-d tensors on the card.

    With a ``torch.distributed`` process group (``group=``, in the JAX
    package's ``mesh=`` place; ``torch.distributed.group.WORLD`` for the
    default group) the step is data parallel: ``batch`` is this rank's
    share, the gradients and metrics are averaged over the group before the
    update (``all_reduce_mean``), and without ``draws`` the generator makes
    the draws of the whole batch (every rank's share, in rank order) and
    the rank takes its own, so that the ranks draw differently (the JAX
    step's ``fold_in(key, axis_index)``) and together draw what one process
    would for the whole batch. A group of one rank runs the same code,
    collective included.
    """
    rank, world = (dist.get_rank(group), dist.get_world_size(group)) if group is not None else (0, 1)
    if any(p.dtype != torch.float32 for p in detector.parameters()):
        raise ValueError("training needs float32 master weights: build the detector with param_dtype=torch.float32")
    shape = tuple(int(s) for s in scene_shape)
    loss_fn = build_loss_fn(detector, cfg, shape)
    n_anchors = anchor_count(detector, shape)
    use_gt = bool(cfg.USE_GT)
    # the proposal targets' candidates: the proposals (the gt boxes themselves
    # under USE_RPN False), then the gt boxes with USE_GT
    post_n = int(cfg.TRAIN.RPN_POST_NMS_TOP_N) if bool(cfg.USE_RPN) else None

    def opt_init() -> SGD:
        # frozen parameters keep requires_grad: their gradients are taken
        # only to be read by the non-finite guard, and autograd takes them
        # only where a loss reaches them (a frozen backbone under trained
        # class losses), as the JAX package differentiates every leaf
        opt = SGD(detector.named_parameters(), cfg)
        for p in opt.params.values():
            p.requires_grad_(True)
        return opt

    def step(opt: SGD, batch: dict, draws: dict | None = None, generator: torch.Generator | None = None,
             timer: StageTimer | None = None) -> dict:
        t = timer or _no_timer
        with tracing.span("train.step", request=tracing.new_request()):
            b, n_gt = (int(d) for d in np.shape(batch["gt_box"])[:2])
            if draws is None:
                n_candidates = (n_gt if post_n is None else post_n) + (n_gt if use_gt else 0)
                draws = make_draws(b * world, n_anchors, n_candidates, generator, detector.device)
                draws = {k: v[rank * b:(rank + 1) * b] for k, v in draws.items()}
            else:
                draws = {k: torch.as_tensor(v, dtype=torch.float32).to(detector.device) for k, v in draws.items()}
            names = list(opt.params)  # trainable and frozen: the guard reads both
            params = [opt.params[k] for k in names]
            with t("forward"):
                total, metrics = loss_fn(batch, draws, t)
            with t("backward"):
                grads = (torch.autograd.grad(total, params, allow_unused=True) if total.requires_grad
                         else [None] * len(names))
            if group is not None:
                with t("all_reduce"):
                    grads, metrics = all_reduce_mean(grads, params, metrics, group)
            with t("update") as sp:
                sp.set(tensors=sum(map(len, opt.buckets.values())))  # the tensors the update moves
                return apply_step_update(opt, dict(zip(names, grads)), metrics)

    return opt_init, step
