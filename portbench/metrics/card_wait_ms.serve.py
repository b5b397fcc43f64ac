"""The served path's host syncs with the card (``si.wait.card`` spans of
``tpu3dsis_torch/infer/tiling.py::SceneInference``), in ms a room over the
window's rooms: the part of a room the host waits on the card."""

from portbench import spans


def read(ctx):
    items = spans.window_spans(ctx, "si.")
    if items is None:
        return None
    return spans.per(ctx, "rooms", spans.total_us(items, lambda s: s.name == "si.wait.card") / 1e3)
