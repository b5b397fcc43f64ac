"""The model FLOPs of the window's training steps (``counts/flops.py``:
forward, and twice the forward of each part a gradient passes or that
trains) over the window's time and the card's dense bf16 peak."""

from portbench.counts import PEAKS, flops


def read(ctx):
    kind = ctx["kind"]
    steps = kind.window_steps()
    if not steps:
        return None
    model, train = ctx["cfg"]["model"], kind.train_cfg
    total = 0.0
    for gt in steps:
        f = flops.train_step(model, train, len(gt), gt)
        total += sum(f["forward"].values()) + sum(f["backward"].values())
    return 100.0 * total / (ctx["window_s"] * PEAKS["bf16_flops_per_s"])
