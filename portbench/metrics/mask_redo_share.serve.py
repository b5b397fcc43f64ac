"""The share of the window's rooms with a ``si.mask_redo`` span: rooms
whose large mask-window queue dropped windows, so that their short rois
were served again through the host-planned ``predict_masks``
(``tpu3dsis_torch/infer/tiling.py::SceneInference.infer``)."""

from portbench import spans


def read(ctx):
    items = spans.window_spans(ctx, "si.")
    if items is None:
        return None
    redone = sum(1 for s, _, _ in items if s.name == "si.mask_redo")
    share = spans.per(ctx, "rooms", redone)
    return None if share is None else 100.0 * share
