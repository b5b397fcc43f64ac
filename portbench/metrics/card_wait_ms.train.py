"""The training step's host syncs with the card (``train.wait.card`` spans:
the mask queue's ``torch.nonzero``,
``tpu3dsis_torch/train/trainstep.py::_mask_forward_scan``), in ms a step
over the window's steps."""

from portbench import spans


def read(ctx):
    items = spans.window_spans(ctx, "train.")
    if items is None:
        return None
    return spans.per(ctx, "steps", spans.total_us(items, lambda s: s.name == "train.wait.card") / 1e3)
