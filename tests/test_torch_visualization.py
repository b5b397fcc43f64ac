"""The port's PLY views (``tpu3dsis_torch/tools/visualization.py`` and
``python -m tpu3dsis_torch.tools.visualize | visualize_benchmark``) against
the JAX package's and the root scripts: the same PLY files byte for byte."""

import filecmp
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
from test_torch_export import _same_tree

from tpu3dsis.config import default_config as jax_default_config
from tpu3dsis.io import write_chunk_file
from tpu3dsis.tools import visualization as jax_vis
from tpu3dsis_torch.config import default_config
from tpu3dsis_torch.tools import ply, visualization


def _same_plys(a, b):
    assert any(f.endswith(".ply") for f in os.listdir(a)), a
    _same_tree(a, b)


@pytest.mark.parametrize("case", ["mask", "empty_mask", "bbox_classes", "bbox_plain", "empty_bbox"])
def test_writers_match_jax(tmp_path, case):
    rng = np.random.RandomState(1)
    for name, mod in (("port", visualization), ("jax", jax_vis)):
        path = str(tmp_path / f"{name}.ply")
        if case == "mask":
            mod.write_mask(rng.rand(6, 5, 7), path, color=(10, 20, 30), threshold=0.7)
        elif case == "empty_mask":
            mod.write_mask(np.zeros((3, 3, 3)), path)
        elif case == "bbox_classes":
            boxes = np.concatenate([rng.rand(4, 3) * 10, 10 + rng.rand(4, 3) * 5, rng.randint(0, 45, (4, 1))], 1)
            mod.write_bbox(boxes, path, edge_radius=0.2)
        elif case == "bbox_plain":
            mod.write_bbox(rng.rand(3, 6) * 20, path)
        else:
            mod.write_bbox(np.zeros((0, 7)), path)
        rng = np.random.RandomState(1)
    assert filecmp.cmp(tmp_path / "port.ply", tmp_path / "jax.ply", shallow=False)
    assert visualization.create_color_palette() == jax_vis.create_color_palette()


def _chunk(tmp_path):
    rng = np.random.RandomState(2)
    sdf = (rng.randn(24, 20, 22) * 2).astype(np.float32)
    boxes = np.array([[1.2, 2.0, 3.5, 9.0, 8.4, 11.0], [10, 4, 6, 16, 12, 15]], np.float32)
    masks = [(rng.rand(8, 7, 8) * 3).astype(np.uint16), np.ones((6, 8, 9), np.uint16)]
    path = str(tmp_path / "scene0001_00__0__.chunk")
    write_chunk_file(path, sdf, boxes, np.array([5, 7], np.uint32), masks, np.ones(2, np.float32),
                     np.eye(4, dtype=np.float32), np.zeros(0, np.uint32))
    return path


def _result_dir(tmp_path):
    rng = np.random.RandomState(3)
    d = tmp_path / "res" / "scene0001_00"
    os.makedirs(d)
    np.save(d / "scene.npy", (rng.rand(20, 12, 18) > 0.8).astype(np.int64))
    boxes = np.array([[1, 1, 1, 6, 5, 7], [8, 2, 3, 14, 9, 12.4], [15, 0, 10, 25, 14, 20]], np.float32)
    np.save(d / "pred_box.npy", boxes)
    np.save(d / "pred_class.npy", np.array([3, 5, 9], np.int32))
    with open(d / "pred_mask", "wb") as f:
        pickle.dump([(rng.rand(*(np.round(b[3:]) - np.round(b[:3])).astype(int)) > 0.5).astype(np.uint8)
                     for b in boxes], f)
    return str(d)


@pytest.mark.parametrize("mode", ["chunk", "result"])
def test_visualize_matches_jax(tmp_path, mode):
    """``visualize_chunk`` / ``visualize_result`` write the JAX package's
    files (with the label map's remap for the chunk)."""
    if mode == "chunk":
        path = _chunk(tmp_path)
        for name, mod, cfg in (("port", visualization, default_config()), ("jax", jax_vis, jax_default_config())):
            cfg.LABEL_MAP = "experiments/labelmaps/nyu40labels_scannet.csv"
            mod.visualize_chunk(path, str(tmp_path / name), cfg)
    else:
        res = _result_dir(tmp_path)
        for name, mod in (("port", visualization), ("jax", jax_vis)):
            mod.visualize_result(res, str(tmp_path / name))
    _same_plys(tmp_path / "port", tmp_path / "jax")


def test_cli_entries_match_the_root_scripts(tmp_path, monkeypatch):
    """``python -m tpu3dsis_torch.tools.visualize --mode chunk|result`` and
    ``visualize_benchmark`` write what ``tools/visualize.py`` (``--mode
    data|result``) and ``tools/visualize_benchmark.py`` write."""
    chunk, res = _chunk(tmp_path), _result_dir(tmp_path)
    scan = tmp_path / "scans" / "scene0001_00"
    os.makedirs(scan)
    rng = np.random.RandomState(4)
    verts = rng.rand(40, 3).astype(np.float32)
    ply.write_ply(str(scan / "scene0001_00_vh_clean_2.ply"), verts, faces=rng.randint(0, 40, (10, 3)).tolist())
    sub = tmp_path / "sub"
    os.makedirs(sub / "pred_mask")
    for i in range(2):
        np.savetxt(sub / "pred_mask" / f"scene0001_00_{i}.txt", rng.rand(40) > 0.5, fmt="%d")
    (sub / "scene0001_00.txt").write_text("pred_mask/scene0001_00_0.txt 5 0.9\npred_mask/scene0001_00_1.txt 39 0.4\n")
    (sub / "semantic_instance_evaluation.txt").write_text("not a scene\n")
    for name in ("port", "jax"):
        out = tmp_path / name
        runs = [("visualize", ["--mode", "chunk" if name == "port" else "data", "--chunk", chunk, "--out",
                               str(out / "chunk"), "--cfg", "experiments/cfgs/ScanNet/tiny_ci.yml"]),
                ("visualize", ["--mode", "result", "--result_dir", res, "--out", str(out / "result")]),
                ("visualize_benchmark", ["--pred_path", str(sub), "--scan_path", str(tmp_path / "scans"),
                                         "--output_dir", str(out / "bench")])]
        for script, args in runs:
            monkeypatch.setattr(sys, "argv", [script, *args])
            if name == "port":
                runpy.run_module(f"tpu3dsis_torch.tools.{script}", run_name="__main__")
            else:
                runpy.run_path(f"tools/{script}.py", run_name="__main__")
    for sub_dir in ("chunk", "result", "bench"):
        _same_plys(tmp_path / "port" / sub_dir, tmp_path / "jax" / sub_dir)
