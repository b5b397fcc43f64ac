"""The host's paste of the mask windows into the boxes' masks (``si.paste``
spans of ``tpu3dsis_torch/infer/tiling.py::SceneInference``), in ms a room
over the window's rooms."""

from portbench import spans


def read(ctx):
    items = spans.window_spans(ctx, "si.")
    if items is None:
        return None
    return spans.per(ctx, "rooms", spans.total_us(items, lambda s: s.name == "si.paste") / 1e3)
