"""The port's span recorder (``tpu3dsis_torch/utils/tracing.py``) on the
CPU: off it records nothing, reads no clock and enters no
``record_function``; under ``torch.profiler`` it records every thread, with
names, parents and request ids, on the profiler's clock; the served room
(``SceneInference.infer``, a tiny color room as ``test_torch_scene.py``
builds one) and the training step (``build_train_step``, three steps)
record their span trees."""

import threading
import time

import pytest
import torch
from test_torch_scene import COLOR_VIEWS, DEPTH_WH, INTRINSIC, TORCH_THREADS, _frames, _scene, _small_cfg
from test_torch_train import make_batch, tiny_cfg
from torch.profiler import ProfilerActivity, profile

from tpu3dsis_torch import Detector, DetectorConfig, SceneInference
from tpu3dsis_torch.config import default_config
from tpu3dsis_torch.train.trainstep import StageTimer, build_train_step
from tpu3dsis_torch.utils import tracing


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def _worker(fn, name="span-worker"):
    t = threading.Thread(target=fn, name=name)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()


def test_off_records_nothing_reads_no_clock_and_adds_no_profiler_event(monkeypatch):
    def refuse(*args):
        raise AssertionError("an off span read the clock or entered a record_function")

    monkeypatch.setattr(tracing, "time_ns", refuse)
    monkeypatch.setattr(tracing, "_RecordFunction", refuse)
    a, b = tracing.span("a", request=3, views=2), tracing.span("b")
    assert a is b  # the one shared no-op
    with a as sp:
        sp.set(detections=4)
        with tracing.span("a.child"):
            pass
    _worker(lambda: tracing.span("w").__enter__().__exit__(None, None, None))
    assert tracing.spans() == []


def test_an_off_span_costs_a_flag_check():
    """A loose bound here (PERF.md gives the measured cost): the off path
    stays far from a span's cost when on (a ``record_function`` is ~13 us)."""
    n, best = 20000, float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("x"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 3e-6, best


def test_on_under_the_profiler_records_every_thread():
    def work():
        with tracing.span("w.outer", request=7, views=3) as sp:
            with tracing.span("w.inner"):
                torch.ones(8).sum()
            sp.set(tiles=2)

    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.span("x") is not tracing.span("y")
        with tracing.span("m.outer", request=5):
            with tracing.span("m.inner"):
                torch.ones(8).sum()
        _worker(work)
    assert tracing.span("x") is tracing.span("y")
    got = {s.name: s for s in tracing.spans()}
    assert set(got) == {"m.outer", "m.inner", "w.outer", "w.inner"}
    assert got["m.outer"].thread == threading.current_thread().name and got["w.outer"].thread == "span-worker"
    assert got["m.outer"].tid == threading.get_native_id() != got["w.outer"].tid
    assert got["m.inner"].parent is got["m.outer"] and got["m.outer"].parent is None
    assert got["w.inner"].parent is got["w.outer"] and got["w.outer"].parent is None
    assert (got["m.outer"].request, got["m.inner"].request) == (5, 5)  # a child takes its parent's
    assert (got["w.outer"].request, got["w.inner"].request) == (7, 7)
    assert got["w.outer"].attrs == {"views": 3, "tiles": 2}
    for s in got.values():
        assert 0 < s.start_ns <= s.end_ns
    assert got["m.outer"].start_ns <= got["m.inner"].start_ns <= got["m.inner"].end_ns <= got["m.outer"].end_ns


def test_recording_turns_it_on_without_the_profiler():
    with tracing.recording():
        with tracing.span("r"):
            pass
        _worker(lambda: tracing.span("r.worker").__enter__().__exit__(None, None, None))
    with tracing.span("after"):
        pass
    assert [s.name for s in tracing.spans()] == ["r", "r.worker"]
    tracing.clear()
    assert tracing.spans() == []


def test_spans_lie_on_the_profilers_clock():
    """Each main-thread span's start and end against the profiler's
    ``record_function`` event of its name, within 50 us."""
    names = [f"clock.{i}" for i in range(5)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in names:
            with tracing.span(name):
                x = torch.randn(64, 64)
                (x @ x).sum()
            time.sleep(0.002)
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name() in names}
    assert set(events) == set(names)
    for s in tracing.spans():
        e = events[s.name]
        assert abs(e.start_ns() - s.start_ns) < 50_000 and abs(e.end_ns() - s.end_ns) < 50_000, s


# --- the served room ------------------------------------------------------------------

FUSED_CHILDREN = {"si.tiles", "si.stitch", "si.plan", "si.masks"}


@pytest.fixture(scope="module")
def color_det():
    """``test_torch_scene``'s small color configuration (128-channel feature
    images, 48^3 tiles) on a detector with the port's seeded weights."""
    from __graft_entry__ import _scannet_cfg

    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    cfg = _small_cfg(_scannet_cfg())
    cfg.USE_IMAGES, cfg.USE_IMAGES_GT, cfg.NUM_IMAGE_CHANNELS = True, True, 128
    cfg.DEPTH_SHAPE, cfg.INTRINSIC, cfg.VOXEL_SIZE = list(DEPTH_WH), INTRINSIC, 0.1
    cfg.PROJ_DEPTH_MIN, cfg.PROJ_DEPTH_MAX = 0.4, 4.0
    cfg.TPU_MAX_TILE_VIEWS = COLOR_VIEWS
    tcfg = DetectorConfig.from_cfg(cfg)
    det = Detector(tcfg, device="cpu")
    det.init_params(torch.Generator().manual_seed(0))
    yield tcfg, det
    torch.set_num_threads(threads)


def _children(recorded, parent):
    return [s for s in recorded if s.parent is parent]


def _self_ns(recorded, s):
    return s.duration_ns - sum(c.duration_ns for c in _children(recorded, s))


def _subtree(recorded, root):
    out = [root]
    for c in _children(recorded, root):
        out += _subtree(recorded, c)
    return out


def test_a_served_room_records_its_span_tree(color_det):
    tcfg, det = color_det
    rooms = [(_scene(31 + i, (60, 40, 40)), _frames(41 + i)) for i in range(2)]
    si = SceneInference(det, tcfg, tile_batch=2)
    with tracing.recording():
        si.prefetch_scene(rooms[0][0])
        si.prefetch_frames(rooms[0][1], rooms[0][0].shape)
        served = []
        for j, (scene, frames) in enumerate(rooms):
            if j + 1 < len(rooms):
                si.prefetch_scene(rooms[j + 1][0])
                si.prefetch_frames(rooms[j + 1][1], rooms[j + 1][0].shape)
            served.append(si.infer(scene, frames))
            assert si.last_fused
    si.close()
    recorded = tracing.spans()
    infers = [s for s in recorded if s.name == "si.infer"]
    assert len(infers) == 2 and len({s.request for s in infers}) == 2
    main, redone = threading.get_native_id(), 0
    for root, (det_out, masks) in zip(infers, served):
        assert root.tid == main and root.parent is None
        kids = {c.name: c for c in _children(recorded, root)}
        assert set(kids) - {"si.mask_redo"} == {"si.device_color", "si.device_scene", "si.fused", "si.to_host",
                                                "si.paste"}
        if "si.mask_redo" in kids:  # short rois redone through predict_masks, its syncs waits
            redone += 1
            assert "si.wait.card" in {s.name for s in _subtree(recorded, kids["si.mask_redo"])}
        assert {c.name for c in _children(recorded, kids["si.fused"])} == FUSED_CHILDREN
        assert {c.name for c in _children(recorded, kids["si.to_host"])} == {"si.wait.card"}
        for stage in ("si.device_color", "si.device_scene"):
            assert {c.name for c in _children(recorded, kids[stage])} == {"si.wait.prefetch"}
        tree = _subtree(recorded, root)
        assert {s.request for s in tree} == {root.request}
        # the serving thread's self times add up to the room's span
        assert sum(_self_ns(recorded, s) for s in tree) == pytest.approx(root.duration_ns, rel=0.05)
        assert root.attrs["views"] == COLOR_VIEWS and root.attrs["tiles"] == 3
        assert root.attrs["detections"] == len(det_out["pred_box"]) > 0
        assert root.attrs["windows"] >= len(masks)
        # the upload thread prepared this room under its id, handed over at its prefetch
        jobs = [s for s in recorded if s.request == root.request and s.tid != main]
        assert {s.name for s in jobs} == {"si.upload_scene", "si.prepare_color"}
        assert all(s.thread.startswith("scene-upload") and s.parent is None for s in jobs)
        assert [s.attrs for s in jobs if s.name == "si.prepare_color"] == [{"views": COLOR_VIEWS}]
        prefetches = [s for s in recorded if s.name == "si.prefetch" and s.request == root.request]
        assert len(prefetches) == 2 and all(s.tid == main for s in prefetches)
    assert redone  # these rooms' large boxes overflow the large window queue


def test_an_overflow_records_the_host_planned_path(color_det):
    tcfg, det = color_det
    scene, frames = _scene(33, (60, 40, 40)), _frames(43)
    over = SceneInference(det, tcfg.replace(TPU_FUSED_PRE_NMS=8), tile_batch=2)
    with tracing.recording():
        det_out, masks = over.infer(scene, frames)
    assert over.host_path_scenes == 1 and not over.last_fused
    recorded = tracing.spans()
    root = next(s for s in recorded if s.name == "si.infer")
    kids = {c.name: c for c in _children(recorded, root)}
    assert "si.host_path" in kids and "si.paste" not in kids
    assert root.attrs["detections"] == len(det_out["pred_box"]) == len(masks) > 0
    host = _subtree(recorded, kids["si.host_path"])
    assert {"si.device_color", "si.device_scene", "si.wait.card"} <= {s.name for s in host}
    assert all(s.request == root.request for s in host)


# --- the training step ------------------------------------------------------------------

def test_three_training_steps_record_their_stages():
    """``StageTimer.ms()`` keeps its stages; each step is a ``train.step``
    root with its stages nested as they run, and the mask queue's one host
    sync a ``train.wait.card``."""
    cfg = tiny_cfg(default_config())
    det = Detector(DetectorConfig.from_cfg(cfg), device="cpu", param_dtype=torch.float32)
    det.init_params(torch.Generator().manual_seed(0))
    opt_init, step = build_train_step(det, cfg, (32, 16, 32))
    opt = opt_init()
    timer = StageTimer(torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    with tracing.recording():
        for i in range(3):
            m = step(opt, make_batch(i), generator=gen, timer=timer)
            assert float(m["step_finite"]) == 1.0
    ms = timer.ms()
    assert set(ms) == {"forward", "targets", "backward", "update"} and all(v > 0 for v in ms.values())
    recorded = tracing.spans()
    roots = [s for s in recorded if s.parent is None]
    assert [s.name for s in roots] == ["train.step"] * 3 and len({s.request for s in roots}) == 3
    for root in roots:
        assert [c.name for c in _children(recorded, root)] == ["train.forward", "train.backward", "train.update"]
        forward = _children(recorded, root)[0]
        inner = [c.name for c in _children(recorded, forward)]
        assert set(inner) == {"train.targets", "train.wait.card"} and inner.count("train.wait.card") == 1
        assert {s.request for s in _subtree(recorded, root)} == {root.request}
    # the same stage spans without a timer
    tracing.clear()
    with tracing.recording():
        step(opt, make_batch(3), generator=gen)
    assert [s.name for s in tracing.spans() if s.parent is not None and s.parent.parent is None] == \
        ["train.forward", "train.backward", "train.update"]
