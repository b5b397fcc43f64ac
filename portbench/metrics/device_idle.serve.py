"""The share of the served window in which no operation ran on the card,
from the profiler's trace (the union of the device's operations)."""

from portbench import harness


def read(ctx):
    if ctx["trace"] is None:
        return None
    busy, window = harness.device_busy(ctx["trace"])
    return 100.0 * (1.0 - busy / window)
