"""The port's recorder spans (``tpu3dsis_torch/utils/tracing.py``) as the
span readers in ``metrics/`` take them: the spans of the traced window,
clipped to it, in microseconds on the profiler's clock (the recorder stamps
spans with ``time.time_ns()``, the clock of the profiler's CPU events).

A program without the recorder, or a window in which it recorded nothing,
gives None, and the reader then returns None.
"""

from __future__ import annotations

from portbench import harness


def window_spans(ctx: dict, prefix: str):
    """[(span, start_us, end_us)] of the recorded spans whose name starts
    with ``prefix`` and that overlap the traced window, clipped to it; None
    without a trace, without the recorder, or where none was recorded."""
    if ctx.get("trace") is None:
        return None
    try:
        from tpu3dsis_torch.utils import tracing
    except ImportError:
        return None
    w0, w1 = ctx["trace"]["window"]
    out = []
    for s in tracing.spans():
        a, b = s.start_ns / 1e3, s.end_ns / 1e3
        if s.name.startswith(prefix) and b > w0 and a < w1:
            out.append((s, max(a, w0), min(b, w1)))
    return out or None


def under(s, name: str) -> bool:
    """Is a span named ``name`` among ``s``'s ancestors?"""
    p = s.parent
    while p is not None:
        if p.name == name:
            return True
        p = p.parent
    return False


def total_us(items, keep) -> float:
    """The clipped time of the spans that ``keep`` takes, a span inside
    another taken one counted once (with its outermost)."""
    total = 0.0
    for s, a, b in items:
        if keep(s):
            p, inner = s.parent, False
            while p is not None and not inner:
                inner = keep(p)
                p = p.parent
            if not inner:
                total += b - a
    return total


def per(ctx: dict, key: str, value: float):
    """``value`` over the window's ``key`` count (rooms, steps); None
    where the count is 0."""
    n = ctx.get("counters", {}).get(key)
    return value / n if n else None


def threads_of(items, name: str) -> set:
    """The threads (native ids) that ran a span named ``name``."""
    return {s.tid for s, _, _ in items if s.name == name}


def idle_outside_share(ctx: dict, items, threads: set) -> float | None:
    """The share (%) of the card's idle time in the window (the window less
    the union of its operations) during which none of ``threads`` was in
    one of ``items``' spans."""
    w0, w1 = ctx["trace"]["window"]
    busy = harness.busy_union([(s, e) for _, s, e in ctx["trace"]["kernels"]])
    idle, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    idle_us = sum(b - a for a, b in idle)
    if idle_us <= 0:
        return None
    inside = harness.busy_union([(a, b) for s, a, b in items if s.tid in threads])
    covered, j = 0.0, 0
    for a, b in idle:  # both lists sorted and disjoint within themselves
        while j < len(inside) and inside[j][1] <= a:
            j += 1
        k = j
        while k < len(inside) and inside[k][0] < b:
            covered += min(b, inside[k][1]) - max(a, inside[k][0])
            k += 1
    return 100.0 * (idle_us - covered) / idle_us
