"""The harness on the CPU: the rate and the tail over the window on
synthetic timestamps, the traffic from a seed, the benchmark file's names
and units, the guard against JAX, and what the reference imports."""

from __future__ import annotations

import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, traffic
from portbench.kinds import serve_rooms

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_p95_is_the_tail_of_all_values():
    values = list(range(1, 101))
    assert harness.p95(values) == pytest.approx(95.05)
    assert harness.p95([3.0]) == 3.0
    assert math.isnan(harness.p95([]))


def test_rooms_rate_and_tail_are_over_the_whole_window():
    k = serve_rooms.ServeRooms.__new__(serve_rooms.ServeRooms)
    # 10 rooms over 5 s of window, latencies 100..1000 ms
    k.records = [(0, 0.0, 0.1 * (i + 1), {}, []) for i in range(10)]
    e2e = k.end_to_end({"t_start": 0.0, "t_end": 5.0})
    assert e2e["scenes_per_min"] == pytest.approx(10 / 5 * 60)
    p95 = harness.reader("scene_p95_ms.serve")({"kind": k})
    assert p95 == pytest.approx(harness.p95([100.0 * (i + 1) for i in range(10)]))


def test_busy_union_and_idle_gaps():
    trace = {"kernels": [("a", 0, 10), ("b", 5, 20), ("a", 30, 40)], "host": [("sync", 20, 30), ("step", 0, 50)],
             "window": (0, 50)}
    busy, window = harness.device_busy(trace)
    assert busy == pytest.approx(30e-6) and window == pytest.approx(50e-6)
    brk = harness.breakdown(trace["kernels"], trace["host"], trace["window"])
    assert brk["device_ops"][0][0] == "a" and brk["device_ops"][0][1] == pytest.approx(20e-6)
    assert brk["idle_gaps"][0] == ["sync", pytest.approx(10e-6)]


def _small_rooms():
    return {"kind": "serve_rooms", "pool": 2, "extents": [[96, 48, 96], [144, 48, 144]], "views": [3, 5],
            "objects": [3, 5]}


def test_rooms_are_the_same_from_the_same_seed_and_differ_otherwise():
    intr = harness.config("scannet.rpn_class_mask_5")["serve"]["INTRINSIC"]
    a = traffic.rooms(_small_rooms(), 2**33 + 5, intr, "cpu")
    b = traffic.rooms(_small_rooms(), 2**33 + 5, intr, "cpu")
    c = traffic.rooms(_small_rooms(), 2**33 + 6, intr, "cpu")
    for (ta, ga, fa), (tb, gb, fb) in zip(a, b):
        assert np.array_equal(ta, tb) and np.array_equal(ga, gb)
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert not all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(a, c))
    # the same set of sizes for every seed
    assert sorted(t.shape for t, _, _ in a) == sorted(t.shape for t, _, _ in c)


def test_serving_and_batch_orders():
    order = traffic.serve_order(5, 200, 2**40)
    assert order == traffic.serve_order(5, 200, 2**40)
    assert all(x != y for x, y in zip(order, order[1:]))
    assert sorted(order[:5]) == list(range(5))
    batches = traffic.batch_order(24, 8, 9, 123)
    assert all(len(set(b)) == 8 for b in batches)
    assert len(set(np.concatenate(batches[:3]))) == 24


def test_training_chunks_are_the_same_from_the_same_seed():
    cfg = harness.config("suncg.rpn_class_mask_5")
    mix = dict(traffic.load("train_chunks"), pool=1, extents=[[144, 48, 144]], views=[6, 6], objects=[6, 6],
               chunks_per_room=2)
    a = traffic.train_pool(mix, 99, cfg["train"]["INTRINSIC"], cfg["kind_labels"], 64, "cpu")
    b = traffic.train_pool(mix, 99, cfg["train"]["INTRINSIC"], cfg["kind_labels"], 64, "cpu")
    assert len(a) == 2
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
        assert x["gt_valid"].any() and x["mask_canvas"].any() and x["images"].shape[0] == 5


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_names_units_and_files_keep_to_the_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        assert 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in bench["workloads"]:
        reported = [m for m in bench["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert reported and any(w["name"] in m.get("workloads", [w["name"]]) for m in bench["end_to_end"]
                                if m["name"] != "setup_s")
    assert len(json.dumps(bench)) < 64 * 1024


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu3dsis_torch_lookalike", object())
    assert "tpu3dsis" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu3dsis.fake", object())
    assert "tpu3dsis" in harness.forbidden_modules()
    with pytest.raises(harness.RunError):
        harness.guard_jax("test")


def test_the_benchmark_loads_no_jax():
    code = ("import sys; from portbench import run, harness, judge, weights, traffic, calls; "
            "from portbench.kinds import serve_rooms, train_step; "
            "import tpu3dsis_torch, tpu3dsis_torch.train.trainstep, tpu3dsis_torch.infer.tiling; "
            "harness.prepare_environment(); print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("sub", ["reference", "counts"])
def test_the_yardstick_imports_nothing_of_the_program(sub):
    for path in (ROOT / "portbench" / sub).glob("*.py"):
        assert not _imports(path) & {"tpu3dsis_torch", "tpu3dsis", "jax", "jaxlib", "flax"}, path


def test_without_the_program_a_run_prints_no_result(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "scannet.rooms", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_a_card_a_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "suncg.train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
