"""The comparisons that decide ``correct``: the numbers compared, each
against its limit from ``portbench/limits/<workload>.json``.

Served rooms, over the rooms sampled after the window. A detection's cost
against another is |confidence difference| + (1 - IoU of the boxes).
  - ``det_cost_p90``: for each served detection, its least cost against
    the reference's candidates (every tile's top proposals, classified, each
    class's probability and box, in room coordinates), read at the served
    class; the 90th percentile over the served detections;
  - ``ref_cost_median``: for each of the reference's own detections with
    confidence >= 0.5, its least cost against the served detections of its
    class (2 where there is none); the median;
  - ``mask_flip``: the share of the served boxes' voxels whose mask differs
    from the reference's mask of the same box and class.

Training (the first three steps of the window's own call, against the
reference's three from the same weights, batches and draws):
  - ``loss_gap``: the largest relative gap of a step's total loss;
  - ``grad_gap``: of the first step's gradient as the optimizer took it,
    the largest gap of a leaf's norm, over the reference's norm of that leaf
    or of the median leaf, whichever is larger;
  - ``change_gap``: the same of the parameters' change over the three
    steps, leaves whose reference gradient is under a thousandth of the
    median leaf's left out (they move by round-off alone);
  - ``change_gap_median``: the median over those leaves of the same gap,
    steady where a proposal that bf16 ranks otherwise changes a later
    step's targets (which moves the loss and the worst leaf by turns).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import geometry as G


def room_numbers(det: dict, masks: list, ref_det: dict, pool: dict, ref_masks: list) -> dict:
    """One room's parts of the numbers: the served detections' costs, the
    reference's confident detections' costs, the masks' differing voxels."""
    boxes = torch.as_tensor(np.asarray(det["pred_box"], np.float32)).reshape(-1, 6)
    classes = np.asarray(det["pred_class"]).reshape(-1)
    conf = np.asarray(det["pred_conf"], np.float64).reshape(-1)
    served = []
    pb, pp = pool["boxes"].float(), pool["prob"].double().numpy()
    for i in range(len(boxes)):
        c = int(classes[i])
        ov = G.iou(boxes[i:i + 1], pb[:, c]).numpy()[0] if len(pb) else np.zeros(0)
        cost = np.abs(pp[:, c] - conf[i]) + (1.0 - ov)
        served.append(float(cost.min()) if len(cost) else 2.0)
    rb = torch.as_tensor(np.asarray(ref_det["pred_box"], np.float32)).reshape(-1, 6)
    rconf = np.asarray(ref_det["pred_conf"], np.float64).reshape(-1)
    rcls = np.asarray(ref_det["pred_class"]).reshape(-1)
    ov = G.iou(rb, boxes).numpy() if len(boxes) and len(rb) else np.zeros((len(rb), len(boxes)))
    back = []
    for i in np.nonzero(rconf >= 0.5)[0]:
        same = classes == rcls[i]
        back.append(float((np.abs(conf[same] - rconf[i]) + (1.0 - ov[i, same])).min()) if same.any() else 2.0)
    diff = total = 0
    for m, r in zip(masks, ref_masks):
        n = max(m.size, r.size, 1)
        diff += n if m.shape != r.shape else int((m != r).sum())
        total += n
    return {"served": served, "back": back, "mask_diff": diff, "mask_voxels": total}


def combine_rooms(rooms: list) -> dict:
    served = [c for r in rooms for c in r["served"]]
    back = [c for r in rooms for c in r["back"]]
    voxels = sum(r["mask_voxels"] for r in rooms)
    if not served:  # nothing served to compare: every number fails
        return {"det_cost_p90": math.inf, "ref_cost_median": math.inf, "mask_flip": math.inf, "served": 0}
    return {"det_cost_p90": float(np.percentile(served, 90)),
            "ref_cost_median": float(np.median(back)) if back else 0.0,
            "mask_flip": sum(r["mask_diff"] for r in rooms) / voxels if voxels else 0.0,
            "served": len(served)}


# --- training -------------------------------------------------------------------------------
def leaf_gaps(prog: dict, ref: dict, names=None) -> list:
    """Each leaf's |norm(prog leaf) - norm(ref leaf)| over max(norm(ref
    leaf), the median leaf's reference norm)."""
    names = list(names if names is not None else ref)
    if not names:
        return [0.0]
    rn = {k: float(ref[k].double().norm()) for k in names}
    med = float(np.median(list(rn.values())))
    return [abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med, 1e-30) for k in names]


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog and ref: {"losses": [3 floats], "grad": {leaf: first step's
    gradient as the optimizer took it}, "change": {leaf: parameters after
    step 3 minus before step 1}}."""
    gaps = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(prog["losses"], ref["losses"])]
    norms = {k: float(v.double().norm()) for k, v in ref["grad"].items()}
    med = float(np.median(list(norms.values()))) if norms else 0.0
    moving = [k for k, n in norms.items() if n >= 1e-3 * med]
    grad, change = leaf_gaps(prog["grad"], ref["grad"]), leaf_gaps(prog["change"], ref["change"], moving)
    return {"loss_gap": max(gaps), "grad_gap": max(grad), "change_gap": max(change),
            "change_gap_median": float(np.median(change)), "leaves": len(norms), "leaves_moving": len(moving)}


# --- limits -------------------------------------------------------------------------------------
def decide(numbers: dict, lim: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the limits
    name; a number above its limit, or not finite, fails."""
    out, ok = {}, True
    for name, limit in lim["limits"].items():
        value = float(numbers[name])
        out[name] = {"value": value, "limit": float(limit)}
        if not (math.isfinite(value) and value <= float(limit)):
            ok = False
    return ok, out
