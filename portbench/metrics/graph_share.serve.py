"""The share of the window's ``si.fused`` spans that hold an ``si.replay``:
rooms whose chain after the tiles (stitch, window plans, mask FCN) the card
ran as the bucket's captured CUDA graph
(``tpu3dsis_torch/infer/tiling.py::SceneInference._replay``). Only the
``si.fused`` spans wholly inside the window count: one that the window's
edge cuts may hold its replay outside it. A program that recorded no
``si.replay`` in the window replays nothing, and reads None."""

from portbench import spans


def read(ctx):
    items = spans.window_spans(ctx, "si.")
    if items is None:
        return None
    fused = {id(s) for s, a, b in items if s.name == "si.fused" and (a, b) == (s.start_ns / 1e3, s.end_ns / 1e3)}
    replayed = {id(s.parent) for s, _, _ in items if s.name == "si.replay" and s.parent is not None}
    if not fused or not replayed:
        return None
    return 100.0 * len(fused & replayed) / len(fused)
