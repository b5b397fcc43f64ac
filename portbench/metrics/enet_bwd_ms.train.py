"""The ENet's share of the backward (``train.enet_bwd`` spans: from its
features' gradient to its first op's parameters' gradients, on the thread
autograd runs it on; ``tpu3dsis_torch/utils/tracing.py::backward_span``),
in ms a step over the window's steps: the host's time to enqueue it. None
where the program records no such span."""

from portbench import spans

NAME = "train.enet_bwd"


def read(ctx):
    items = [it for it in spans.window_spans(ctx, NAME) or [] if it[0].name == NAME]
    if not items:
        return None
    return spans.per(ctx, "steps", spans.total_us(items, lambda s: s.name == NAME) / 1e3)
