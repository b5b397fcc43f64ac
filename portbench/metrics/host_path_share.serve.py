"""The share of the window's rooms that an overflow of the fused program's
queues sent to the host-planned path (``SceneInference.host_path_scenes``
over the rooms served)."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("rooms"):
        return None
    return 100.0 * c["host_path_scenes"] / c["rooms"]
