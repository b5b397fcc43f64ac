"""Profiling on the card: a Chrome trace of a region, and device time from
CUDA events (``tpu3dsis/utils/profiling.py``'s ``trace`` and
``device_time``).

PyTorch returns before the card finishes, so a host clock around a call
measures its enqueue. Every timer here reads CUDA events and refuses a host
without a card: there is no wall-clock fallback.

  - :func:`trace` wraps ``torch.profiler`` and writes a Chrome trace;
  - :func:`cuda_ms`: the median of CUDA events around each call (a call's
    time with any gap while the host enqueues it);
  - :func:`device_ms` / :func:`device_time`: calls queued behind a device
    sleep, so the events see the kernels back to back and no host gap;
  - :func:`host_ms`: the host's clock around the call alone, the stream
    drained between calls (the enqueue: checks, host work, launches).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch


def _require_cuda(device=None) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device timing reads CUDA events: this host has no CUDA device")
    if device is not None and torch.device(device).type != "cuda":
        raise RuntimeError(f"device timing reads CUDA events: {device} is not a CUDA device")


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profile the region (the CPU, and the card where there is one) and
    write its Chrome trace to ``log_dir/name``; yields the profiler, whose
    ``key_averages()`` sums the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, name))


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median time of fn() in ms, CUDA events around each call (the time
    includes any gap while the host enqueues the call)."""
    _require_cuda()
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Device time of one fn() in ms: `iters` calls queued behind a device
    sleep, so the events see the kernels back to back and no host gap."""
    _require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms: longer than enqueueing the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_time(fn, iters: int = 20, device=None) -> float:
    """Mean device seconds per call of fn() on the current CUDA device (or
    ``device``), from :func:`device_ms`. Raises on a host without a card or
    for a device that is not CUDA."""
    _require_cuda(device)
    with torch.cuda.device(device) if device is not None else contextlib.nullcontext():
        return device_ms(fn, iters) / 1e3


def host_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Median host time of one fn() in ms: the host's clock around the call
    alone (the enqueue: the wrapper's checks, host work and launches), the
    stream drained between calls."""
    _require_cuda()
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)
