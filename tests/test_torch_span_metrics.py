"""The benchmark's span readers (``portbench/metrics/*.py`` that read the
port's recorder through ``portbench/spans.py``) on hand-built contexts: a
synthetic device trace and spans recorded on a fake clock, on the serving
or training thread and on an upload thread, each reader against the number
worked out by hand; each returns None where nothing was recorded."""

import threading

import pytest

from portbench import harness
from tpu3dsis_torch.utils import tracing

BASE_US = 1_000_000_000_000  # the window's start on the clock, in us (whole ns stay exact in a float)

# (name, start us, end us, children) from the window's start; requests by root
SERVE_MAIN = [
    ("si.prefetch", 0, 20, []),
    ("si.infer", 20, 500, [
        ("si.device_color", 20, 60, [("si.wait.prefetch", 30, 50, [])]),
        ("si.device_scene", 60, 80, [("si.wait.prefetch", 65, 75, [])]),
        ("si.fused", 80, 200, [("si.tiles", 80, 150, []), ("si.stitch", 150, 170, []), ("si.plan", 170, 180, []),
                               ("si.masks", 180, 200, [])]),
        ("si.to_host", 200, 350, [("si.wait.card", 210, 340, [])]),
        ("si.paste", 350, 400, []),
        ("si.mask_redo", 400, 480, [("si.wait.card", 420, 440, [])]),
    ]),
    ("si.prefetch", 520, 540, []),
    ("si.infer", 540, 900, [("si.fused", 545, 595, [("si.tiles", 545, 580, []), ("si.replay", 580, 595, [])]),
                            ("si.to_host", 600, 800, [("si.wait.card", 610, 790, [])]), ("si.paste", 800, 850, [])]),
]
SERVE_UPLOAD = [("si.upload_scene", 25, 100, []), ("si.prepare_color", 100, 180, [])]
SERVE_KERNELS = [(100, 300), (600, 800)]  # idle: [0, 100], [300, 600], [800, 1000]

TRAIN_MAIN = [
    ("train.step", 10, 400, [
        ("train.forward", 10, 250, [("train.color", 12, 48, [("train.enet", 14, 30, []), ("train.fuse", 32, 46, [])]),
                                    ("train.targets", 50, 80, []), ("train.wait.card", 100, 140, [])]),
        ("train.backward", 250, 380, []),
        ("train.update", 380, 400, []),
    ]),
    ("train.step", 450, 900, [("train.forward", 450, 700, [("train.color", 452, 480, [("train.enet", 455, 470, [
        ("train.enet_replay", 456, 469, [])]), ("train.fuse", 470, 478, [])]),
                                                           ("train.wait.card", 500, 560, [])]),
                              ("train.backward", 700, 880, []), ("train.update", 880, 900, [])]),
]
# the backward's spans on the card: autograd's device thread
TRAIN_AUTOGRAD = [("train.fuse_bwd", 260, 270, []), ("train.enet_bwd", 270, 330, []),
                  ("train.fuse_bwd", 710, 716, []), ("train.enet_bwd", 716, 766, [])]
TRAIN_KERNELS = [(0, 300), (500, 850)]  # idle: [300, 500], [850, 1000]

# by hand, from the spans above; rooms 2, steps 2
EXPECTED = {
    # si.infer 480 + 360 us, less waits and pastes 230 + 230, a room
    "enqueue_ms.serve": (480 + 360 - 460) / 1e3 / 2,
    "card_wait_ms.serve": (130 + 20 + 180) / 1e3 / 2,
    "prefetch_wait_ms.serve": (20 + 10) / 1e3 / 2,
    "paste_ms.serve": (50 + 50) / 1e3 / 2,
    "upload_ms.serve": (75 + 80) / 1e3 / 2,
    # of 600 us idle the serving thread is out of the port in [500, 520] and [900, 1000]
    "idle_outside_port.serve": 100.0 * 120 / 600,
    "mask_redo_share.serve": 50.0,
    # room 2's si.fused holds a si.replay, room 1's ran its chain eagerly
    "graph_share.serve": 50.0,
    "enqueue_ms.train": (390 + 450 - 40 - 60) / 1e3 / 2,
    "card_wait_ms.train": (40 + 60) / 1e3 / 2,
    # of 350 us idle the training thread is out of the port in [400, 450] and [900, 1000]
    "idle_outside_port.train": 100.0 * 150 / 350,
    "enet_ms.train": (16 + 15) / 1e3 / 2,
    "enet_bwd_ms.train": (60 + 50) / 1e3 / 2,
    # step 2's train.enet holds a train.enet_replay, step 1's ran the ENet eagerly
    "enet_graph_share.train": 50.0,
}


class Clock:
    now_ns = 0

    def __call__(self):
        return self.now_ns


def _record(clock, tree, request=None):
    for name, start, end, children in tree:
        clock.now_ns = (BASE_US + start) * 1000
        with tracing.span(name, request=request):
            _record(clock, children)
            clock.now_ns = (BASE_US + end) * 1000


def _ctx(main, upload, kernels, counters, monkeypatch, thread="scene-upload_0"):
    clock = Clock()
    monkeypatch.setattr(tracing, "time_ns", clock)
    tracing.clear()
    with tracing.recording():
        _record(clock, main, request=1)
        if upload:
            t = threading.Thread(target=_record, args=(clock, upload, 2), name=thread)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
    trace = {"kernels": [("k", BASE_US + a, BASE_US + b) for a, b in kernels], "host": [],
             "window": (BASE_US, BASE_US + 1000)}
    return {"trace": trace, "counters": counters, "window_s": 1e-3}


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def _served(monkeypatch):
    return _ctx(SERVE_MAIN, SERVE_UPLOAD, SERVE_KERNELS, {"rooms": 2, "host_path_scenes": 0}, monkeypatch)


def _trained(monkeypatch):
    return _ctx(TRAIN_MAIN, TRAIN_AUTOGRAD, TRAIN_KERNELS, {"steps": 2}, monkeypatch, thread="autograd")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_the_number_worked_out_by_hand(name, monkeypatch):
    ctx = (_served if name.endswith(".serve") else _trained)(monkeypatch)
    assert harness.reader(name)(ctx) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_without_spans(name, monkeypatch):
    ctx = (_served if name.endswith(".serve") else _trained)(monkeypatch)
    read = harness.reader(name)
    tracing.clear()  # a program that recorded nothing in the window
    assert read(ctx) is None
    assert read(dict(ctx, trace=None)) is None  # an untraced run


def test_the_clipped_window(monkeypatch):
    """A span that straddles the window counts its part inside."""
    ctx = _served(monkeypatch)
    ctx["trace"]["window"] = (BASE_US + 100, BASE_US + 1000)  # the first prefetch and part of room 1 fall out
    read = harness.reader("paste_ms.serve")
    assert read(ctx) == pytest.approx(0.05)
    ctx["trace"]["window"] = (BASE_US + 375, BASE_US + 1000)  # half of room 1's paste
    assert read(ctx) == pytest.approx((25 + 50) / 1e3 / 2)


def test_graph_share_finds_nothing_without_a_replay(monkeypatch):
    """A program that replays no chain (its rooms' ``si.fused`` spans hold
    the eager stages alone) reads None, not 0."""
    eager = [item if item[0] != "si.infer" or item[1] != 540 else
             ("si.infer", 540, 900, [("si.fused", 545, 595, [("si.tiles", 545, 580, []), ("si.masks", 580, 595, [])])])
             for item in SERVE_MAIN]
    ctx = _ctx(eager, SERVE_UPLOAD, SERVE_KERNELS, {"rooms": 2, "host_path_scenes": 0}, monkeypatch)
    assert harness.reader("graph_share.serve")(ctx) is None


def test_graph_share_counts_the_rooms_whole_in_the_window(monkeypatch):
    """A third room whose ``si.fused`` the window's end cuts, before its
    ``si.replay``, is left out: of the two whole ``si.fused`` spans, room
    2's replays (50%), not one of three (33%)."""
    cut = SERVE_MAIN + [("si.infer", 950, 1100, [("si.fused", 960, 1050, [("si.tiles", 960, 1020, []),
                                                                          ("si.replay", 1020, 1050, [])])])]
    ctx = _ctx(cut, SERVE_UPLOAD, SERVE_KERNELS, {"rooms": 3, "host_path_scenes": 0}, monkeypatch)
    assert harness.reader("graph_share.serve")(ctx) == pytest.approx(50.0, rel=1e-9)


def _renamed(tree, old, new):
    """The span tree with every span named ``old`` named ``new`` (its
    subtree dropped where ``new`` is None)."""
    return [(new if name == old else name, a, b, _renamed(kids, old, new)) for name, a, b, kids in tree
            if name != old or new is not None]


def test_enet_graph_share_finds_nothing_without_a_replay(monkeypatch):
    """A program that replays no ENet (its ``train.enet`` spans hold no
    ``train.enet_replay``, as before graphs, or a capture alone) reads
    None, not 0."""
    read = harness.reader("enet_graph_share.train")
    for new in (None, "train.enet_capture"):
        tree = _renamed(TRAIN_MAIN, "train.enet_replay", new)
        ctx = _ctx(tree, TRAIN_AUTOGRAD, TRAIN_KERNELS, {"steps": 2}, monkeypatch, thread="autograd")
        assert harness.reader("enet_ms.train")(ctx) is not None and read(ctx) is None


def test_enet_graph_share_counts_the_steps_whole_in_the_window(monkeypatch):
    """A third step whose ``train.enet`` the window's end cuts, before its
    ``train.enet_replay``, is left out, and so is a first one that its
    start cuts: of the whole ``train.enet`` spans, step 2's replays."""
    cut = TRAIN_MAIN + [("train.step", 950, 1100, [("train.forward", 950, 1100, [
        ("train.color", 960, 1060, [("train.enet", 970, 1040, [("train.enet_replay", 1010, 1030, [])])])])])]
    ctx = _ctx(cut, TRAIN_AUTOGRAD, TRAIN_KERNELS, {"steps": 3}, monkeypatch, thread="autograd")
    read = harness.reader("enet_graph_share.train")
    assert read(ctx) == pytest.approx(50.0, rel=1e-9)
    ctx["trace"]["window"] = (BASE_US + 20, BASE_US + 1000)  # step 1's train.enet starts before the window
    assert read(ctx) == pytest.approx(100.0, rel=1e-9)
