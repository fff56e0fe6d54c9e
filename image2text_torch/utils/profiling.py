"""Profiling of the training loop (counterpart of
``image2text_tpu/utils/profiling.py``): :class:`TraceWindow` captures a
``torch.profiler`` trace (host and, on the card, device activity; a
Chrome trace file) of a window of steps, and :class:`Throughput` reports
steps/s and items/s over the last updates."""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Optional


class TraceWindow:
    """Capture a ``torch.profiler`` trace of steps [start, stop) of a loop
    into ``logdir`` (None: no trace)."""

    def __init__(self, logdir: Optional[str], start: int = 10, stop: int = 13):
        self.logdir = logdir
        self.start = start
        self.stop = stop
        self._prof = None

    def step(self, i: int) -> None:
        if self.logdir is None:
            return
        if i == self.start and self.stop > self.start and self._prof is None:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        elif i >= self.stop and self._prof is not None:
            self.close()

    def close(self) -> None:
        """Stop a running capture and write its trace."""
        if self._prof is None:
            return
        self._prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(
            self.logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
        self._prof = None


class Throughput:
    """Rolling steps/s and items/s over the last ``window`` updates (the
    first, slower steps age out)."""

    def __init__(self, window: int = 50):
        self._times = deque([time.perf_counter()], maxlen=window + 1)
        self._items = deque(maxlen=window)
        self.steps = 0
        self.items = 0

    def update(self, items: int = 0) -> None:
        self.steps += 1
        self.items += items
        self._times.append(time.perf_counter())
        self._items.append(items)

    @property
    def steps_per_sec(self) -> float:
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else 0.0

    @property
    def items_per_sec(self) -> float:
        dt = self._times[-1] - self._times[0]
        return sum(self._items) / dt if dt > 0 else 0.0
