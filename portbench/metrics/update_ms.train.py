"""The train step's ``update`` span (``train/trainstep.py::StageTimer``:
the guard and the SGD update, ``train/solver.py``), in ms a step over the
window's steps."""


def read(ctx):
    spans = ctx["kind"].stage_ms()
    return None if not spans or "update" not in spans else spans["update"]
