"""The serving thread's time in the port's ``si.infer`` spans less their
waits (``si.wait.*``: on the card, on the upload thread) and the host's
paste (``si.paste``), in ms a room over the window's rooms: the host's work
to enqueue a room (``tpu3dsis_torch/infer/tiling.py::SceneInference``)."""

from portbench import spans


def read(ctx):
    items = spans.window_spans(ctx, "si.")
    if items is None:
        return None
    infer = spans.total_us(items, lambda s: s.name == "si.infer")
    off = spans.total_us(items, lambda s: (s.name.startswith("si.wait.") or s.name == "si.paste")
                         and spans.under(s, "si.infer"))
    return spans.per(ctx, "rooms", (infer - off) / 1e3)
