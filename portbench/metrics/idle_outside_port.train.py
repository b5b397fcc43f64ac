"""The share of the card's idle time in the training window (the window
less the union of its operations, from the profiler's trace) during which
the training thread was in no ``train.*`` span of the port: the benchmark's
batch upload and draws, and the interpreter between steps."""

from portbench import spans


def read(ctx):
    items = spans.window_spans(ctx, "train.")
    if items is None:
        return None
    return spans.idle_outside_share(ctx, items, spans.threads_of(items, "train.step"))
