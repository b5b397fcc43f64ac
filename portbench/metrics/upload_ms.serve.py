"""The upload thread's jobs (``si.upload_scene``: padding, pinning and the
scene's copy; ``si.prepare_color``: the frames' pinning and copies, the
ENet and K3 queued, the frusta; ``tpu3dsis_torch/infer/tiling.py``), on
threads other than the serving thread, in ms a room over the window's
rooms."""

from portbench import spans

JOBS = ("si.upload_scene", "si.prepare_color")


def read(ctx):
    items = spans.window_spans(ctx, "si.")
    if items is None:
        return None
    serving = spans.threads_of(items, "si.infer")
    return spans.per(ctx, "rooms", spans.total_us(items, lambda s: s.name in JOBS and s.tid not in serving) / 1e3)
