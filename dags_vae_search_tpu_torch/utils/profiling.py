"""Step timing, counters and profiler annotations (torch).

Counterpart of ``dags_vae_search_tpu/utils/profiling.py``: ``trace``
records a ``torch.profiler`` window (host and CUDA events) into a Chrome
trace file; ``annotate`` names a region in it; ``StepTimer`` is a rolling
host-clock step timer with an items/s rate; ``Counters`` holds named
monotonically increasing counts with rates since creation.  The host clock
measures what the host waited for: wrap work that ends in a device
synchronisation to time the device.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block over CPU and CUDA activities (those this build of
    torch supports) and write its Chrome trace, ``*.pt.trace.json``, into
    ``log_dir`` (TensorBoard's profile plugin and Perfetto read it)."""
    from torch.profiler import ProfilerActivity, profile, supported_activities, tensorboard_trace_handler

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name a region in the profiler timeline."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Rolling step timer with items/sec reporting.

    >>> timer = StepTimer()
    >>> for batch in batches:
    ...     with timer.step(items=batch_size):
    ...         run(batch)
    >>> timer.rate()  # items/sec over the window
    """

    def __init__(self, window: int = 50):
        self.window = window
        self._durations: list = []
        self._items: list = []

    @contextlib.contextmanager
    def step(self, items: int = 1) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._durations.append(time.perf_counter() - t0)
            self._items.append(items)
            if len(self._durations) > self.window:
                self._durations.pop(0)
                self._items.pop(0)

    def rate(self) -> float:
        total_t = sum(self._durations)
        return sum(self._items) / total_t if total_t else 0.0

    def mean_step_seconds(self) -> float:
        return sum(self._durations) / len(self._durations) if self._durations else 0.0


class Counters:
    """Named monotonically-increasing counters with rates since start."""

    def __init__(self):
        self._counts: Dict[str, float] = defaultdict(float)
        self._start = time.time()

    def add(self, name: str, value: float = 1.0) -> None:
        self._counts[name] += value

    def get(self, name: str) -> float:
        return self._counts[name]

    def rates(self) -> Dict[str, float]:
        elapsed = max(time.time() - self._start, 1e-9)
        return {k: v / elapsed for k, v in self._counts.items()}

    def summary(self) -> str:
        rates = self.rates()
        return ", ".join(
            f"{k}={self._counts[k]:,.0f} ({rates[k]:,.1f}/s)" for k in sorted(self._counts)
        )
