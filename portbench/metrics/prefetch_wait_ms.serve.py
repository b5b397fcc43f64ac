"""The served path's joins of the upload thread's prefetches
(``si.wait.prefetch`` spans of ``tpu3dsis_torch/infer/tiling.py``), in ms a
room over the window's rooms: what the upload thread holds the room up."""

from portbench import spans


def read(ctx):
    items = spans.window_spans(ctx, "si.")
    if items is None:
        return None
    return spans.per(ctx, "rooms", spans.total_us(items, lambda s: s.name == "si.wait.prefetch") / 1e3)
