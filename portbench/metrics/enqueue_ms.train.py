"""The training thread's time in the port's ``train.step`` spans less their
waits on the card (``train.wait.*``), in ms a step over the window's steps:
the host's work to enqueue a step
(``tpu3dsis_torch/train/trainstep.py::build_train_step``)."""

from portbench import spans


def read(ctx):
    items = spans.window_spans(ctx, "train.")
    if items is None:
        return None
    step = spans.total_us(items, lambda s: s.name == "train.step")
    waits = spans.total_us(items, lambda s: s.name.startswith("train.wait.") and spans.under(s, "train.step"))
    return spans.per(ctx, "steps", (step - waits) / 1e3)
