"""Ground-truth export: ScanNet annotations -> benchmark gt id files.

Port of ``tools/scannet_benchmark/export_train_mesh_for_evaluation.py``:
per-vertex label / instance ids from the ``*.aggregation.json`` +
``*_vh_clean_2.0.010000.segs.json`` annotation files, written as one id per
line (instance encoding = label * 1000 + 1-indexed object id).

A copy of the JAX package's ``tpu3dsis/eval/gt_export.py``, held equal to
it by ``tests/test_torch_export.py``.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np


def read_label_mapping(filename, label_from, label_to, delimiter="\t"):
    """utils.py:32-42."""
    mapping = {}
    with open(filename) as f:
        for row in csv.DictReader(f, delimiter=delimiter):
            mapping[row[label_from]] = int(row[label_to])
    try:
        int(next(iter(mapping.keys())))
        mapping = {int(k): v for k, v in mapping.items()}
    except ValueError:
        pass
    return mapping


def read_aggregation(filename):
    object_id_to_segs = {}
    label_to_segs = {}
    with open(filename) as f:
        data = json.load(f)
    for group in data["segGroups"]:
        object_id = group["objectId"] + 1  # 1-indexed instance ids
        label = group["label"]
        segs = group["segments"]
        object_id_to_segs[object_id] = segs
        label_to_segs.setdefault(label, []).extend(segs)
    return object_id_to_segs, label_to_segs


def read_segmentation(filename):
    seg_to_verts = {}
    with open(filename) as f:
        data = json.load(f)
    num_verts = len(data["segIndices"])
    for i, seg_id in enumerate(data["segIndices"]):
        seg_to_verts.setdefault(seg_id, []).append(i)
    return seg_to_verts, num_verts


def export_gt_ids(
    agg_file,
    seg_file,
    raw_to_nyu40,
    nyu40_to_consecutive,
    task_type,
    output_file,
):
    """task_type in {'label', 'instance'}; writes one id per vertex line."""
    object_id_to_segs, label_to_segs = read_aggregation(agg_file)
    seg_to_verts, num_verts = read_segmentation(seg_file)
    label_ids = np.zeros(num_verts, np.uint32)
    for label, segs in label_to_segs.items():
        label_id = nyu40_to_consecutive[raw_to_nyu40[label]]
        for seg in segs:
            label_ids[seg_to_verts[seg]] = label_id
    if task_type == "label":
        out = label_ids
    elif task_type == "instance":
        instance_ids = np.zeros(num_verts, np.uint32)
        for object_id, segs in object_id_to_segs.items():
            for seg in segs:
                instance_ids[seg_to_verts[seg]] = object_id
        out = label_ids * 1000 + instance_ids
    else:
        raise ValueError(task_type)
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    with open(output_file, "w") as f:
        for v in out:
            f.write(f"{v}\n")
    return out


def export_scans(scan_path, filelist, label_map_file, label_map_file2,
                 task_type, output_dir):
    """Directory driver (export_train_mesh_for_evaluation.py:99-112)."""
    raw_to_nyu40 = read_label_mapping(
        label_map_file, "raw_category", "nyu40id"
    )
    nyu40_to_consec = read_label_mapping(
        label_map_file2, "nyu40id", "mappedIdConsecutive", delimiter=","
    )
    wanted = {l.strip() for l in open(filelist) if l.strip()}
    for scan in sorted(os.listdir(scan_path)):
        if scan not in wanted:
            continue
        export_gt_ids(
            os.path.join(scan_path, scan, scan + ".aggregation.json"),
            os.path.join(scan_path, scan, scan + "_vh_clean_2.0.010000.segs.json"),
            raw_to_nyu40,
            nyu40_to_consec,
            task_type,
            os.path.join(output_dir, scan + ".txt"),
        )
