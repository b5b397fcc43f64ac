"""Wall-clock timer for the display cadence and the VAL_TIME trigger
(``tpu3dsis/utils/timer.py``; the reference's ``lib/utils/timer.py:4-33``).

The reference calls ``torch.cuda.synchronize()`` in tic and toc. Here the
caller passes ``sync=`` a tensor to wait for: its CUDA device is
synchronized first, so the time covers the work queued for it; a CPU
tensor needs no wait.
"""

from __future__ import annotations

import time

import torch


def _wait(sync) -> None:
    if sync is not None and torch.is_tensor(sync) and sync.device.type == "cuda":
        torch.cuda.synchronize(sync.device)


class Timer:
    def __init__(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self, sync=None):
        _wait(sync)
        self.start_time = time.time()

    def toc(self, average=True, sync=None):
        _wait(sync)
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff
