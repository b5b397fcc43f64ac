"""The port's ScanNet benchmark export against the JAX package's, on the CPU.

The port keeps copies of ``tpu3dsis/tools/ply.py``,
``tpu3dsis/eval/scannet_benchmark.py`` and ``tpu3dsis/eval/gt_export.py``
(and ``python -m tpu3dsis_torch.tools.*`` entries for the root ``tools/``
scripts): each writes the same files and numbers as its original on the same
inputs, here synthetic meshes, predictions and annotations
(``tests/test_benchmark_eval.py``'s scene, made imperfect).
"""

import filecmp
import json
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
from test_benchmark_eval import make_scene_fixture

from tpu3dsis.eval import gt_export as jax_gt
from tpu3dsis.eval import scannet_benchmark as jax_sb
from tpu3dsis.tools import ply as jax_ply
from tpu3dsis_torch.eval import gt_export, scannet_benchmark
from tpu3dsis_torch.tools import ply

PACKAGES = {"port": (scannet_benchmark, gt_export, ply), "jax": (jax_sb, jax_gt, jax_ply)}


def _same_tree(a, b):
    """Every file under a and b byte for byte equal, and the same names."""
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.funny_files, (a, b)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    assert not mismatch and not errors, mismatch
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))


def _binary_ply(path, verts, colors, faces):
    """A binary_little_endian PLY as ScanNet's meshes are: float x, y, z and
    uchar colors a vertex, uchar-counted int faces."""
    head = ("ply\nformat binary_little_endian 1.0\nelement vertex {}\nproperty float x\nproperty float y\n"
            "property float z\nproperty uchar red\nproperty uchar green\nproperty uchar blue\nelement face {}\n"
            "property list uchar int vertex_indices\nend_header\n").format(len(verts), len(faces))
    vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    v = np.zeros(len(verts), vdt)
    v["x"], v["y"], v["z"] = verts.T
    v["red"], v["green"], v["blue"] = np.asarray(colors, np.uint8).T
    f = np.zeros(len(faces), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    f["n"], f["i"] = 3, faces
    with open(path, "wb") as out:
        out.write(head.encode() + v.tobytes() + f.tobytes())


@pytest.mark.parametrize("binary", [False, True])
def test_ply_copy_matches_jax(tmp_path, binary):
    """``write_ply`` writes the same bytes (ascii, the only format it
    writes); ``read_ply`` and ``read_mesh_vertices`` read the same arrays
    from it and from a binary little-endian mesh."""
    rng = np.random.RandomState(int(binary))
    verts = rng.randn(50, 3).astype(np.float32)
    colors = [tuple(int(c) for c in rng.randint(0, 256, 3)) for _ in range(50)]
    faces = rng.randint(0, 50, (20, 3))
    if binary:
        _binary_ply(tmp_path / "mesh.ply", verts, colors, faces)
    else:
        for name, (_, _, mod) in PACKAGES.items():
            mod.write_ply(str(tmp_path / f"{name}.ply"), verts, colors=colors, faces=faces.tolist())
        assert filecmp.cmp(tmp_path / "port.ply", tmp_path / "jax.ply", shallow=False)
        os.replace(tmp_path / "port.ply", tmp_path / "mesh.ply")
    mesh = str(tmp_path / "mesh.ply")
    got, want = ply.read_ply(mesh), jax_ply.read_ply(mesh)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    got = ply.read_mesh_vertices(mesh)
    np.testing.assert_array_equal(got, jax_ply.read_mesh_vertices(mesh))
    np.testing.assert_allclose(got, verts, atol=0 if binary else 5e-5)


def _imperfect_scene(tmp_path):
    """``make_scene_fixture``'s two instances, one mask cut in half, and a
    third, false, detection overlapping the first."""
    pred_dir, mesh_file, w2g_file, gt_file = make_scene_fixture(tmp_path, np.random.RandomState(0))
    boxes = np.concatenate([np.load(os.path.join(pred_dir, "pred_box.npy")),
                            np.array([[22, 10, 22, 30, 16, 30]], np.float32)])
    np.save(os.path.join(pred_dir, "pred_box.npy"), boxes)
    np.save(os.path.join(pred_dir, "pred_class.npy"), np.array([3, 5, 3]))
    np.save(os.path.join(pred_dir, "pred_conf.npy"), np.array([0.9, 0.8, 0.95], np.float32))
    masks = [np.ones((6, 6, 6), np.uint8), np.ones((6, 6, 6), np.uint8), np.ones((8, 6, 8), np.uint8)]
    masks[1][:3] = 0
    with open(os.path.join(pred_dir, "pred_mask"), "wb") as f:
        pickle.dump(masks, f)
    with open(os.path.join(pred_dir, "pred_mask_index"), "wb") as f:
        pickle.dump([True, True, True], f)
    return pred_dir, mesh_file, w2g_file, gt_file


def test_export_remap_and_evaluate_match_jax(tmp_path):
    """``export_scene`` writes the same benchmark files, instance masks
    included; ``remap_benchmark_labels`` rewrites them alike; ``evaluate``
    gives the same averages and result file, on a scene whose AP is neither
    0 nor 1."""
    pred_dir, mesh_file, w2g_file, gt_file = _imperfect_scene(tmp_path)
    outs = {}
    for name, (sb, _, _) in PACKAGES.items():
        out = str(tmp_path / f"bench_{name}")
        sb.export_scene(pred_dir, mesh_file, w2g_file, out, "scene0000_00")
        outs[name] = out
    _same_tree(outs["port"], outs["jax"])
    assert len(open(os.path.join(outs["port"], "scene0000_00.txt")).read().splitlines()) == 3
    avgs = {}
    for name, (sb, _, _) in PACKAGES.items():
        avgs[name] = sb.evaluate([os.path.join(outs[name], "scene0000_00.txt")], [gt_file],
                                 output_file=str(tmp_path / f"eval_{name}.txt"), verbose=False)
    assert filecmp.cmp(tmp_path / "eval_port.txt", tmp_path / "eval_jax.txt", shallow=False)
    np.testing.assert_equal(avgs["port"], avgs["jax"])
    assert 0.0 < avgs["port"]["all_ap"] < 1.0
    for name, (sb, _, _) in PACKAGES.items():
        sb.remap_benchmark_labels(outs[name])
    _same_tree(outs["port"], outs["jax"])


def test_gt_export_matches_jax(tmp_path):
    """``export_scans`` writes the same label and instance id files from
    synthetic aggregation and segmentation annotations; the scan that is
    not in the file list is left out."""
    rng = np.random.RandomState(2)
    raw = ["chair", "table", "wall", "bed"]
    with open(tmp_path / "labels.tsv", "w") as f:
        f.write("id\traw_category\tnyu40id\n")
        for i, (name, nyu) in enumerate(zip(raw, (5, 7, 1, 4))):
            f.write(f"{i + 1}\t{name}\t{nyu}\n")
    scans = tmp_path / "scans"
    for s in ("scene0001_00", "scene0002_00", "scene0003_00"):
        os.makedirs(scans / s)
        seg = rng.randint(0, 12, 300).tolist()
        groups = [{"objectId": j, "label": raw[rng.randint(len(raw))], "segments": [2 * j, 2 * j + 1]}
                  for j in range(5)]
        json.dump({"segIndices": seg}, open(scans / s / f"{s}_vh_clean_2.0.010000.segs.json", "w"))
        json.dump({"segGroups": groups}, open(scans / s / f"{s}.aggregation.json", "w"))
    (tmp_path / "list.txt").write_text("scene0001_00\nscene0003_00\n")
    for task in ("label", "instance"):
        for name, (_, gt, _) in PACKAGES.items():
            gt.export_scans(str(scans), str(tmp_path / "list.txt"), str(tmp_path / "labels.tsv"),
                            "experiments/labelmaps/nyu40labels_scannet.csv", task, str(tmp_path / f"{task}_{name}"))
        _same_tree(tmp_path / f"{task}_port", tmp_path / f"{task}_jax")
        assert sorted(os.listdir(tmp_path / f"{task}_port")) == ["scene0001_00.txt", "scene0003_00.txt"]


def test_tool_entries_match_the_root_scripts(tmp_path, monkeypatch):
    """``python -m tpu3dsis_torch.tools.vox2mesh``, ``proj_label`` and
    ``evaluate_benchmark`` take the root scripts' arguments and write what
    the root scripts write (both run here in this process, as ``__main__``;
    ``tests/test_torch_imports.py`` checks that the entries import no JAX)."""
    pred_dir, mesh_file, w2g_file, gt_file = _imperfect_scene(tmp_path)
    scan, frames = tmp_path / "scans" / "scene0000_00", tmp_path / "frames" / "scene0000_00"
    os.makedirs(scan)
    os.makedirs(frames)
    os.replace(mesh_file, scan / "scene0000_00_vh_clean_2.ply")
    os.replace(w2g_file, frames / "world2grid.txt")
    for name in ("port", "jax"):
        out = str(tmp_path / f"bench_{name}")
        for script, args in (("vox2mesh", ["--pred_dir", os.path.dirname(pred_dir), "--output_dir", out,
                                           "--scan_path", str(tmp_path / "scans"), "--frames", str(tmp_path / "frames")]),
                             ("proj_label", ["--pred_path", out]),
                             ("evaluate_benchmark", ["--pred_path", out, "--gt_path", os.path.dirname(gt_file)])):
            monkeypatch.setattr(sys, "argv", [script, *args])
            if name == "port":
                runpy.run_module(f"tpu3dsis_torch.tools.{script}", run_name="__main__")
            else:
                runpy.run_path(f"tools/{script}.py", run_name="__main__")
    _same_tree(tmp_path / "bench_port", tmp_path / "bench_jax")
    assert os.path.isfile(tmp_path / "bench_port" / "semantic_instance_evaluation.txt")
