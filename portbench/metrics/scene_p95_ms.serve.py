"""The 95th percentile over all the window's rooms of a room's time from
its ``prefetch_scene`` to its ``infer``'s return (host clock). The cell is
a closed loop at the port's capacity, where the tail swings with the
rooms' contents, so it is read here and bounds nothing; in the traced run
it carries the profiler's cost."""

from portbench import harness


def read(ctx):
    lat = ctx["kind"].latencies_ms()
    return harness.p95(lat) if lat else None
