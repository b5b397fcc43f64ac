"""The share of the card's idle time in the served window (the window less
the union of its operations, from the profiler's trace) during which the
serving thread was in no ``si.*`` span of the port: the client's and the
interpreter's time between the port's calls."""

from portbench import spans


def read(ctx):
    items = spans.window_spans(ctx, "si.")
    if items is None:
        return None
    return spans.idle_outside_share(ctx, items, spans.threads_of(items, "si.infer"))
