"""The share of the window's ``train.enet`` spans that hold a
``train.enet_replay``: steps whose ENet over the batch's views (and, where
it trains, its backward) the card ran from captured CUDA graphs
(``tpu3dsis_torch/train/enet_graph.py``). Only the ``train.enet`` spans
wholly inside the window count: one that the window's edge cuts may hold
its replay outside it. A program that recorded no ``train.enet_replay`` in
the window replays nothing, and reads None."""

from portbench import spans


def read(ctx):
    items = spans.window_spans(ctx, "train.enet")
    if items is None:
        return None
    enet = {id(s) for s, a, b in items if s.name == "train.enet" and (a, b) == (s.start_ns / 1e3, s.end_ns / 1e3)}
    replayed = {id(s.parent) for s, _, _ in items if s.name == "train.enet_replay" and s.parent is not None}
    if not enet or not replayed:
        return None
    return 100.0 * len(enet & replayed) / len(enet)
