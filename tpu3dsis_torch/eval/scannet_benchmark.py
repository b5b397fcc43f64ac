"""ScanNet benchmark export + official semantic-instance evaluation.

Three stages, mirroring ``tools/scannet_benchmark/`` in the reference:

1. vox2mesh (``vox2mesh.py:25-148``): paint per-instance predictions into a
   400x200x400 voxel canvas with the ``instance*100 + class + conf - 0.01``
   encoding, map mesh vertices through world2grid (with the fixed
   [10, 16, 10] padding subtraction), nearest-neighbor snap within a 3^3
   neighborhood, and emit per-scene benchmark .txt + per-instance vertex
   masks. The reference's per-voxel / per-vertex python loops are
   vectorized here (same outputs, orders of magnitude faster on 312 scenes).

2. proj_label (``proj_label.py:5-26``): consecutive ids -> nyu40 ids for
   submission.

3. evaluate (``evaluate_semantic_instance.py:75-385``): CityScapes-derived
   AP over overlaps {0.5:0.05:0.95} + 0.25, min region 100 verts, greedy
   per-gt matching with confidence bookkeeping — a faithful behavioral port.

A copy of the JAX package's ``tpu3dsis/eval/scannet_benchmark.py``, held
equal to it on synthetic meshes and predictions by
``tests/test_torch_export.py``.
"""

from __future__ import annotations

import os
from copy import deepcopy

import numpy as np

from tpu3dsis_torch.tools.ply import read_mesh_vertices

CLASS_LABELS = [
    "cabinet", "bed", "chair", "sofa", "table", "door", "window", "bookshelf",
    "picture", "counter", "desk", "curtain", "refrigerator", "shower curtain",
    "toilet", "sink", "bathtub", "otherfurniture",
]
VALID_CLASS_IDS = np.arange(1, 19)
ID_TO_LABEL = {i: l for i, l in zip(VALID_CLASS_IDS, CLASS_LABELS)}
LABEL_TO_ID = {l: i for i, l in zip(VALID_CLASS_IDS, CLASS_LABELS)}

# consecutive id -> nyu40 id for submission (proj_label.py:5-26)
CONSECUTIVE_TO_NYU40 = {
    0: 0, 1: 3, 2: 4, 3: 5, 4: 6, 5: 7, 6: 8, 7: 9, 8: 10, 9: 11, 10: 12,
    11: 14, 12: 16, 13: 24, 14: 28, 15: 33, 16: 34, 17: 36, 18: 39,
}

OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
MIN_REGION_SIZE = 100


# ---------------------------------------------------------------------------
# vox2mesh
# ---------------------------------------------------------------------------


def paint_pred_canvas(pred_folder, canvas_shape=(400, 200, 400)):
    """Reference ``load_pred`` (vox2mesh.py:42-72), vectorized.

    Encoding per voxel: instance*100 + class + conf - 0.01; first-writer-wins
    (earlier instances take precedence where masks overlap).
    """
    import pickle

    scene = np.zeros(canvas_shape)
    pred_box = np.load(os.path.join(pred_folder, "pred_box.npy"))[:, :6]
    pred_class = np.load(os.path.join(pred_folder, "pred_class.npy"))
    pred_conf = np.load(os.path.join(pred_folder, "pred_conf.npy"))
    with open(os.path.join(pred_folder, "pred_mask"), "rb") as f:
        pred_mask = pickle.load(f)
    with open(os.path.join(pred_folder, "pred_mask_index"), "rb") as f:
        sort_index = pickle.load(f)

    pred_box = pred_box[np.asarray(sort_index, bool)]
    pred_conf = pred_conf[np.asarray(sort_index, bool)]
    pred_class = pred_class[np.asarray(sort_index, bool)]

    for box_ind, box in enumerate(pred_box):
        r = np.round(box).astype(int)
        r = np.clip(r, 0, [*canvas_shape, *canvas_shape])
        m = np.asarray(pred_mask[box_ind])
        sub = scene[r[0] : r[3], r[1] : r[4], r[2] : r[5]]
        msub = m[: sub.shape[0], : sub.shape[1], : sub.shape[2]]
        value = box_ind * 100 + pred_class[box_ind] + pred_conf[box_ind] - 0.01
        write = (msub != 0) & (sub == 0)
        sub[write] = value
    return scene


def vertices_to_instances(mesh_vertices, world2grid, scene):
    """Reference ``export`` + ``nn_search`` (vox2mesh.py:74-109), vectorized.

    Returns (instance_class, instance_mask, instance_conf) dicts keyed by
    instance id; masks are vertex-index lists.
    """
    n = mesh_vertices.shape[0]
    homo = np.concatenate([mesh_vertices, np.ones((n, 1))], axis=1)
    grid = np.round(homo @ np.asarray(world2grid).T)
    coords = np.round(grid[:, :3]).astype(np.int64)

    shape = np.asarray(scene.shape)
    values = np.zeros(n)
    found = np.zeros(n, bool)
    # nn_search order: self first, then the 3^3 neighborhood in (-1,0,1)^3
    # lexicographic order (vox2mesh.py:74-84)
    offsets = [(0, 0, 0)] + [
        (i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
        if not (i == 0 and j == 0 and k == 0)
    ]
    for off in offsets:
        c = coords + np.asarray(off)
        inb = ((c >= 0) & (c < shape)).all(axis=1)
        take = inb & ~found
        if not take.any():
            continue
        vals = scene[c[take, 0], c[take, 1], c[take, 2]]
        hit = vals != 0
        idx = np.where(take)[0][hit]
        values[idx] = vals[hit]
        found[idx] = True

    instance_class, instance_mask, instance_conf = {}, {}, {}
    ints = values.astype(np.int64)
    for ind in np.where(found)[0]:
        instance_id = ints[ind] // 100
        if instance_id not in instance_class:
            instance_class[instance_id] = int(ints[ind] % 100)
            instance_conf[instance_id] = float(np.modf(values[ind])[0])
            instance_mask[instance_id] = [int(ind)]
        else:
            instance_mask[instance_id].append(int(ind))
    return instance_class, instance_mask, instance_conf


def save_scannet_benchmark(
    instance_class, instance_mask, instance_conf, verts_len, output_dir,
    scene_id,
):
    """Reference ``save_scannet_benchmark`` (vox2mesh.py:25-40)."""
    os.makedirs(output_dir, exist_ok=True)
    os.makedirs(os.path.join(output_dir, "predicted_masks"), exist_ok=True)
    with open(os.path.join(output_dir, scene_id + ".txt"), "w") as f:
        for instance_id in instance_class:
            cls = instance_class[instance_id]
            score = instance_conf[instance_id]
            mask_file = (
                f"predicted_masks/{scene_id}_{instance_id:03d}.txt"
            )
            f.write(f"{mask_file} {cls} {float(score)}\n")
            mask = np.zeros(verts_len, np.uint8)
            mask[instance_mask[instance_id]] = 1
            np.savetxt(os.path.join(output_dir, mask_file), mask, fmt="%u")


def load_world2grid_padded(filename, padding=(10, 16, 10, 0)):
    """Reference ``load_matrix`` (vox2mesh.py:111-121)."""
    m = np.zeros((4, 4))
    with open(filename) as f:
        lines = [l.split() for l in f.read().splitlines() if l.strip()]
    for i in range(4):
        m[i] = [float(x) for x in lines[i][:4]]
        m[i][3] -= padding[i]
    return m


def export_scene(pred_folder, mesh_file, world2grid_file, output_dir, scene_id):
    """One scene: vox2mesh end-to-end (vox2mesh.py:130-145)."""
    world2grid = load_world2grid_padded(world2grid_file)
    mesh_vertices = read_mesh_vertices(mesh_file)
    scene = paint_pred_canvas(pred_folder)
    ic, im, cf = vertices_to_instances(mesh_vertices, world2grid, scene)
    save_scannet_benchmark(ic, im, cf, len(mesh_vertices), output_dir, scene_id)


def remap_benchmark_labels(benchmark_path):
    """Consecutive ids -> nyu40 in submission .txt files (proj_label.py)."""
    for txt_file in os.listdir(benchmark_path):
        path = os.path.join(benchmark_path, txt_file)
        if os.path.isdir(path) or not txt_file.endswith(".txt"):
            continue
        out = []
        for line in open(path):
            parts = line.split()
            parts[1] = str(CONSECUTIVE_TO_NYU40[int(parts[1])])
            out.append(" ".join(parts) + "\n")
        with open(path, "w") as f:
            f.writelines(out)


# ---------------------------------------------------------------------------
# official evaluator
# ---------------------------------------------------------------------------


def load_ids(filename):
    return np.array(open(filename).read().splitlines(), dtype=np.int64)


def get_instances(ids, class_ids, class_labels, id2label):
    """gt instance table (utils.py:171-183): instance_id = label*1000 + k."""
    instances = {label: [] for label in class_labels}
    for iid in np.unique(ids):
        if iid == 0:
            continue
        label_id = int(iid // 1000)
        if label_id in class_ids:
            instances[id2label[label_id]].append(
                {
                    "instance_id": int(iid),
                    "label_id": label_id,
                    "vert_count": int((ids == iid).sum()),
                    "med_dist": -1,
                    "dist_conf": 0.0,
                }
            )
    return instances


def read_instance_prediction_file(filename):
    instance_info = {}
    for line in open(filename).read().splitlines():
        parts = line.split(" ")
        mask_file = os.path.abspath(
            os.path.join(os.path.dirname(filename), parts[0])
        )
        instance_info[mask_file] = {
            "label_id": int(float(parts[1])),
            "conf": float(parts[2]),
        }
    return instance_info


def assign_instances_for_scan(pred_file, gt_file):
    """Port of evaluate_semantic_instance.py:248-313."""
    pred_info = read_instance_prediction_file(pred_file)
    gt_ids = load_ids(gt_file)
    gt_instances = get_instances(
        gt_ids, VALID_CLASS_IDS, CLASS_LABELS, ID_TO_LABEL
    )
    gt2pred = deepcopy(gt_instances)
    for label in gt2pred:
        for gt in gt2pred[label]:
            gt["matched_pred"] = []
    pred2gt = {label: [] for label in CLASS_LABELS}
    num_pred_instances = 0
    bool_void = np.logical_not(np.isin(gt_ids // 1000, VALID_CLASS_IDS))

    for pred_mask_file, info in pred_info.items():
        label_id = int(info["label_id"])
        if label_id not in ID_TO_LABEL:
            continue
        label_name = ID_TO_LABEL[label_id]
        pred_mask = load_ids(pred_mask_file)
        assert len(pred_mask) == len(gt_ids), pred_mask_file
        pred_mask = np.not_equal(pred_mask, 0)
        num = np.count_nonzero(pred_mask)
        if num < MIN_REGION_SIZE:
            continue

        pred_instance = {
            "filename": pred_mask_file,
            "pred_id": num_pred_instances,
            "label_id": label_id,
            "vert_count": num,
            "confidence": info["conf"],
            "void_intersection": np.count_nonzero(bool_void & pred_mask),
        }
        matched_gt = []
        for gt_num, gt_inst in enumerate(gt2pred[label_name]):
            intersection = np.count_nonzero(
                (gt_ids == gt_inst["instance_id"]) & pred_mask
            )
            if intersection > 0:
                gt_copy = gt_inst.copy()
                pred_copy = pred_instance.copy()
                gt_copy["intersection"] = intersection
                pred_copy["intersection"] = intersection
                matched_gt.append(gt_copy)
                gt2pred[label_name][gt_num]["matched_pred"].append(pred_copy)
        pred_instance["matched_gt"] = matched_gt
        num_pred_instances += 1
        pred2gt[label_name].append(pred_instance)

    return gt2pred, pred2gt


def evaluate_matches(matches):
    """Port of evaluate_semantic_instance.py:75-226."""
    overlaps = OVERLAPS
    ap = np.zeros((1, len(CLASS_LABELS), len(overlaps)))
    min_region_size = MIN_REGION_SIZE
    distance_thresh = float("inf")
    distance_conf = -float("inf")
    for oi, overlap_th in enumerate(overlaps):
        pred_visited = {}
        for m in matches:
            for label_name in CLASS_LABELS:
                for p in matches[m]["pred"][label_name]:
                    if "filename" in p:
                        pred_visited[p["filename"]] = False
        for li, label_name in enumerate(CLASS_LABELS):
            y_true = np.empty(0)
            y_score = np.empty(0)
            hard_false_negatives = 0
            has_gt = False
            has_pred = False
            for m in matches:
                pred_instances = matches[m]["pred"][label_name]
                gt_instances = [
                    gt
                    for gt in matches[m]["gt"][label_name]
                    if gt["instance_id"] >= 1000
                    and gt["vert_count"] >= min_region_size
                    and gt["med_dist"] <= distance_thresh
                    and gt["dist_conf"] >= distance_conf
                ]
                has_gt = has_gt or bool(gt_instances)
                has_pred = has_pred or bool(pred_instances)

                cur_true = np.ones(len(gt_instances))
                cur_score = np.full(len(gt_instances), -float("inf"))
                cur_match = np.zeros(len(gt_instances), bool)
                for gti, gt in enumerate(gt_instances):
                    found_match = False
                    for pred in gt["matched_pred"]:
                        if pred_visited[pred["filename"]]:
                            continue
                        overlap = float(pred["intersection"]) / (
                            gt["vert_count"]
                            + pred["vert_count"]
                            - pred["intersection"]
                        )
                        if overlap > overlap_th:
                            confidence = pred["confidence"]
                            if cur_match[gti]:
                                max_score = max(cur_score[gti], confidence)
                                min_score = min(cur_score[gti], confidence)
                                cur_score[gti] = max_score
                                cur_true = np.append(cur_true, 0)
                                cur_score = np.append(cur_score, min_score)
                                cur_match = np.append(cur_match, True)
                            else:
                                found_match = True
                                cur_match[gti] = True
                                cur_score[gti] = confidence
                                pred_visited[pred["filename"]] = True
                    if not found_match:
                        hard_false_negatives += 1
                cur_true = cur_true[cur_match]
                cur_score = cur_score[cur_match]

                for pred in pred_instances:
                    found_gt = False
                    for gt in pred["matched_gt"]:
                        overlap = float(gt["intersection"]) / (
                            gt["vert_count"]
                            + pred["vert_count"]
                            - gt["intersection"]
                        )
                        if overlap > overlap_th:
                            found_gt = True
                            break
                    if not found_gt:
                        num_ignore = pred["void_intersection"]
                        for gt in pred["matched_gt"]:
                            if gt["instance_id"] < 1000:
                                num_ignore += gt["intersection"]
                            if (
                                gt["vert_count"] < min_region_size
                                or gt["med_dist"] > distance_thresh
                                or gt["dist_conf"] < distance_conf
                            ):
                                num_ignore += gt["intersection"]
                        if float(num_ignore) / pred["vert_count"] <= overlap_th:
                            cur_true = np.append(cur_true, 0)
                            cur_score = np.append(cur_score, pred["confidence"])

                y_true = np.append(y_true, cur_true)
                y_score = np.append(y_score, cur_score)

            if has_gt and has_pred:
                order = np.argsort(y_score)
                y_score_sorted = y_score[order]
                y_true_sorted = y_true[order]
                y_true_sorted_cumsum = np.cumsum(y_true_sorted)
                thresholds, unique_indices = np.unique(
                    y_score_sorted, return_index=True
                )
                num_prec_recall = len(unique_indices) + 1
                num_examples = len(y_score_sorted)
                num_true_examples = (
                    y_true_sorted_cumsum[-1] if len(y_true_sorted_cumsum) else 0
                )
                precision = np.zeros(num_prec_recall)
                recall = np.zeros(num_prec_recall)
                y_true_sorted_cumsum = np.append(y_true_sorted_cumsum, 0)
                for idx_res, idx_scores in enumerate(unique_indices):
                    cumsum = y_true_sorted_cumsum[idx_scores - 1]
                    tp = num_true_examples - cumsum
                    fp = num_examples - idx_scores - tp
                    fn = cumsum + hard_false_negatives
                    precision[idx_res] = float(tp) / (tp + fp)
                    recall[idx_res] = float(tp) / (tp + fn)
                precision[-1] = 1.0
                recall[-1] = 0.0
                recall_for_conv = np.copy(recall)
                recall_for_conv = np.append(recall_for_conv[0], recall_for_conv)
                recall_for_conv = np.append(recall_for_conv, 0.0)
                step_widths = np.convolve(
                    recall_for_conv, [-0.5, 0, 0.5], "valid"
                )
                ap_current = np.dot(precision, step_widths)
            elif has_gt:
                ap_current = 0.0
            else:
                ap_current = float("nan")
            ap[0, li, oi] = ap_current
    return ap


def compute_averages(aps):
    o50 = np.where(np.isclose(OVERLAPS, 0.5))
    o25 = np.where(np.isclose(OVERLAPS, 0.25))
    o_all_but25 = np.where(np.logical_not(np.isclose(OVERLAPS, 0.25)))
    avg = {
        "all_ap": np.nanmean(aps[0, :, o_all_but25]),
        "all_ap_50%": np.nanmean(aps[0, :, o50]),
        "all_ap_25%": np.nanmean(aps[0, :, o25]),
        "classes": {},
    }
    for li, label in enumerate(CLASS_LABELS):
        avg["classes"][label] = {
            "ap": np.average(aps[0, li, o_all_but25]),
            "ap50%": np.average(aps[0, li, o50]),
            "ap25%": np.average(aps[0, li, o25]),
        }
    return avg


def evaluate(pred_files, gt_files, output_file=None, verbose=True):
    matches = {}
    for pred_file, gt_file in zip(pred_files, gt_files):
        gt2pred, pred2gt = assign_instances_for_scan(pred_file, gt_file)
        matches[os.path.abspath(gt_file)] = {"gt": gt2pred, "pred": pred2gt}
    avgs = compute_averages(evaluate_matches(matches))
    if verbose:
        print_results(avgs)
    if output_file:
        write_result_file(avgs, output_file)
    return avgs


def print_results(avgs):
    line_len = 64
    print("#" * line_len)
    print(
        "{:<15}:{:>15}{:>15}{:>15}".format("what", "AP", "AP_50%", "AP_25%")
    )
    print("#" * line_len)
    for label in CLASS_LABELS:
        c = avgs["classes"][label]
        print(
            "{:<15}:{:>15.3f}{:>15.3f}{:>15.3f}".format(
                label, c["ap"], c["ap50%"], c["ap25%"]
            )
        )
    print("-" * line_len)
    print(
        "{:<15}:{:>15.3f}{:>15.3f}{:>15.3f}".format(
            "average", avgs["all_ap"], avgs["all_ap_50%"], avgs["all_ap_25%"]
        )
    )


def write_result_file(avgs, filename):
    with open(filename, "w") as f:
        f.write(",".join(["class", "class id", "ap", "ap50", "ap25"]) + "\n")
        for i, label in enumerate(CLASS_LABELS):
            c = avgs["classes"][label]
            f.write(
                ",".join(
                    str(x)
                    for x in [
                        label, VALID_CLASS_IDS[i], c["ap"], c["ap50%"],
                        c["ap25%"],
                    ]
                )
                + "\n"
            )
