"""The model FLOPs of the rooms served in the window (``counts/flops.py``:
the ENet over each room's views, the tiles' backbone and RPN, the
classifier over every tile's rois, the mask FCN over the windows its
served detections need) over the window's time and the card's dense bf16
peak."""

from portbench.counts import PEAKS, flops


def read(ctx):
    kind = ctx["kind"]
    work = kind.work()
    if not work:
        return None
    model, serve = ctx["cfg"]["model"], ctx["cfg"]["serve"]
    total = sum(sum(flops.room(model, serve, w["shape"], w["views"], w["boxes"]).values()) for w in work)
    return 100.0 * total / (ctx["window_s"] * PEAKS["bf16_flops_per_s"])
