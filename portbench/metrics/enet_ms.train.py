"""The ENet's forward over the batch's views (``train.enet`` spans, inside
``train.color``: ``tpu3dsis_torch/train/trainstep.py::build_loss_fn``), in
ms a step over the window's steps: the host's time to enqueue it. None
where the program records no such span."""

from portbench import spans

NAME = "train.enet"


def read(ctx):
    items = [it for it in spans.window_spans(ctx, NAME) or [] if it[0].name == NAME]
    if not items:
        return None
    return spans.per(ctx, "steps", spans.total_us(items, lambda s: s.name == NAME) / 1e3)
