"""The train step's ``backward`` span (``train/trainstep.py::StageTimer``,
CUDA events), in ms a step over the window's steps."""


def read(ctx):
    spans = ctx["kind"].stage_ms()
    return None if not spans or "backward" not in spans else spans["backward"]
