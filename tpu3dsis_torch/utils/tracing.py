"""Spans of the port's host work, on every thread, on the profiler's clock.

A span is one named interval of one thread's time:

    from tpu3dsis_torch.utils import tracing

    with tracing.span("si.infer", request=room) as sp:
        ...
        sp.set(detections=n)

Names are ``<layer>.<stage>``; a wait on the card or on another thread has
a ``wait.`` segment (``si.wait.card``, ``si.wait.prefetch``,
``train.wait.card``), so that a reader can take waits out of a layer's
time by name.

Recording is on while ``torch.profiler`` records, whichever thread started
it, and inside ``recording()``; else ``span`` checks the process-wide flags
and returns a shared no-op: no clock read, no span, no ``record_function``.
An active span records its name, its thread's name and native id, its
start and end in ``time.time_ns()`` (CLOCK_REALTIME, the clock of the
profiler's CPU events, so spans lie on the profiler's timeline as they
are), its parent (the innermost open span of its thread), a request id (the
room or the step: given, else its parent's) and its attributes (the counts
at that boundary). On the thread that runs the profiler it also enters a
``record_function`` of its name, so the profiler's own trace carries it.

``backward_span`` records a span over part of a backward pass, from
autograd hooks on the thread that runs it.

Finished spans go to one in-memory list per thread; ``spans()`` returns a
snapshot of all of them, ``clear()`` empties them and ``chrome_events``
writes them as Chrome trace events (``utils/profiling.py::trace`` adds them
to its trace).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
from time import time_ns

import torch
from torch.autograd import profiler as _autograd_profiler

_RecordFunction = torch._C._profiler._RecordFunctionFast  # record_function's context manager without its op

_lock = threading.Lock()
_forced = 0  # recording() blocks open, on any thread
_threads = []  # each thread's _Thread that has recorded, in order of its first span
_local = threading.local()
_requests = itertools.count(1)
_pending = {}  # backward_span's name: the hooks of its last call


class _Thread:
    __slots__ = ("name", "tid", "stack", "done", "thread")

    def __init__(self):
        self.thread = threading.current_thread()
        self.name = self.thread.name
        self.tid = threading.get_native_id()
        self.stack = []  # open spans, innermost last
        self.done = []  # finished spans, in the order they ended


def _this_thread() -> _Thread:
    t = getattr(_local, "state", None)
    if t is None:
        t = _local.state = _Thread()
        with _lock:
            _threads.append(t)
    return t


class Span:
    """One recorded interval; ``start_ns``/``end_ns`` on ``time.time_ns()``'s
    clock, ``parent`` the enclosing span of the same thread or None."""

    __slots__ = ("name", "thread", "tid", "start_ns", "end_ns", "parent", "request", "attrs", "_rf", "_owner")

    def __init__(self, name: str, request, attrs: dict):
        self.name, self.request, self.attrs = name, request, attrs
        self.parent = self._rf = None
        self.start_ns = self.end_ns = 0

    def set(self, **attrs) -> None:
        """Add counts to the span's attributes."""
        self.attrs.update(attrs)

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self):
        t = self._owner = _this_thread()
        self.thread, self.tid = t.name, t.tid
        if t.stack:
            self.parent = t.stack[-1]
            if self.request is None:
                self.request = self.parent.request
        t.stack.append(self)
        if torch.autograd._profiler_enabled():  # the profiler's own thread
            self._rf = _RecordFunction(self.name)
            self._rf.__enter__()
        self.start_ns = time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        t = self._owner
        t.stack.pop()
        t.done.append(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, thread={self.thread!r}, request={self.request}, "
                f"ms={self.duration_ns / 1e6:.3f}, attrs={self.attrs})")


class _Off:
    """The span handed out while nothing records."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, request=None, **attrs):
    """A context manager that records ``name`` over its block while
    recording is on, and a shared no-op otherwise."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return Span(name, request, attrs)


def backward_span(name: str, output: torch.Tensor, last) -> None:
    """Record ``name`` over a part of the coming backward pass: from the
    moment ``output``'s gradient is whole to the moment the gradients of
    the leaves ``last`` are (those the part's backward takes last: the
    inputs of its first op), on the thread autograd runs them on (on the
    card its device thread), with the request of the caller's innermost
    open span. The span enters no thread's stack and no profiler range: it
    is written finished, once every leaf has its gradient. Each call first
    removes the hooks of the last call of ``name``, whose pass may have
    left a leaf without a gradient. Off, or where ``output`` takes no
    gradient, it registers nothing."""
    for h in _pending.pop(name, ()):
        h.remove()
    if not (_forced or _autograd_profiler._is_profiler_enabled) or not output.requires_grad:
        return
    leaves = [t for t in last if t.requires_grad]
    if not leaves:
        return
    caller = getattr(_local, "state", None)
    sp = Span(name, caller.stack[-1].request if caller is not None and caller.stack else None, {})
    handles, left = [], [len(leaves)]

    def opened(grad):
        t = sp._owner = _this_thread()
        sp.thread, sp.tid = t.name, t.tid
        if t.stack:
            sp.parent = t.stack[-1]
            if sp.request is None:
                sp.request = sp.parent.request
        sp.start_ns = time_ns()

    def taken(grad):
        left[0] -= 1
        if left[0] == 0 and sp.start_ns:
            sp.end_ns = time_ns()
            sp._owner.done.append(sp)
            for h in handles:
                h.remove()

    handles.append(output.register_hook(opened))
    handles += [t.register_hook(taken) for t in leaves]
    _pending[name] = handles


@contextlib.contextmanager
def recording():
    """Record spans on every thread for the block, with or without the
    profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def new_request() -> int:
    """A fresh request id (a room, a step), unique in the process."""
    return next(_requests)


def spans(since_ns: int = 0) -> list:
    """A snapshot of the finished spans of every thread that started at or
    after ``since_ns``, by start."""
    with _lock:
        threads = list(_threads)
    out = [s for t in threads for s in list(t.done) if s.start_ns >= since_ns]
    out.sort(key=lambda s: s.start_ns)
    return out


def clear() -> None:
    """Drop every finished span, and the state of threads that have ended."""
    with _lock:
        for t in _threads:
            t.done.clear()
        _threads[:] = [t for t in _threads if t.thread.is_alive()]


def chrome_events(recorded, base_ns: int = 0) -> list:
    """Chrome trace events of ``recorded`` spans ("X", category ``span``,
    microseconds from ``base_ns``), with one thread-name event per thread."""
    pid = os.getpid()
    out, names = [], {}
    for s in recorded:
        names[s.tid] = s.thread
        args = dict(s.attrs)
        if s.request is not None:
            args["request"] = s.request
        if s.parent is not None:
            args["parent"] = s.parent.name
        out.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.tid,
                    "ts": (s.start_ns - base_ns) / 1e3, "dur": s.duration_ns / 1e3, "args": args})
    out += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": name}}
            for tid, name in names.items()]
    return out
