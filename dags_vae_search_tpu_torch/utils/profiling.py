"""The port's tracer: spans and counters on the profiler's clock (torch).

Counterpart of ``dags_vae_search_tpu/utils/profiling.py``.

- ``span(name, device=False)`` names a region of the program.  While a
  ``torch.profiler`` session records (``profiling.trace`` below, or any
  other), it enters torch's C++ annotation (what
  ``torch.profiler.record_function`` enters, at a tenth of its cost), so the
  region shows in the profiler's timeline, and keeps ``(name, parent,
  start, end)`` in memory, timed by ``time.time_ns()`` inside the
  annotation: the Unix clock the profiler's events carry, so each idle gap
  of the device can be laid against the spans.  With ``device=True`` it also records a pair of CUDA events on the
  current stream.  Outside a session a span is one shared no-op: a check of
  torch's profiler flag, no clock read, no allocation.  Spans never
  synchronise.
- ``count(name, value)`` adds a host number or a device tensor (summed on
  the device, never read before ``snapshot``) to the session's counters;
  outside a session it does nothing.
- ``snapshot()`` synchronises once and returns the session's spans, with
  their self times and the device milliseconds of their event pairs, and
  its counters as numbers.

Each profiler session starts a new record; ``snapshot`` reads the last
one.  Spans nest by the order one host thread opens them.

``trace(log_dir)`` is the operator's exporter: a profiler window over the
block, written as a Chrome trace, with the spans on inside it.
``StepTimer`` is a rolling host-clock step timer with an items/s rate.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


class Counters:
    """Named sums: host numbers, or device tensors summed on the device and
    read by :meth:`values` alone."""

    def __init__(self):
        self._sums: dict = {}

    def add(self, name: str, value) -> None:
        if torch.is_tensor(value):
            value = value.sum()
        self._sums[name] = self._sums.get(name, 0) + value

    def values(self) -> dict:
        return {name: float(v) for name, v in self._sums.items()}


class _Record:
    """One profiler session's spans and counters.  A span is ``[name,
    parent, start_ns, end_ns, events]``: its parent's index (-1 at the top)
    and its CUDA event pair, where it has one."""

    def __init__(self):
        self.spans: list = []
        self.open: list = []  # indices of the spans open now, innermost last
        self.counters = Counters()
        self.warm = False

    def warmed(self) -> "_Record":
        if not self.warm:
            # a session's first annotation takes ~0.1-1 ms inside the
            # profiler, which would skew the first span's clock
            with torch._C._profiler._RecordFunctionFast("profiling.session"):
                pass
            self.warm = True
        return self


_record = _Record()  # the current (or last) session's


def _install_session_hook() -> None:
    """Start a record with each profiler session: torch calls
    ``_run_on_profiler_start`` once as a session starts (it sets the flag
    the spans check)."""
    start = _autograd_profiler._run_on_profiler_start

    def on_start():
        global _record
        _record = _Record()
        start()

    _autograd_profiler._run_on_profiler_start = on_start


_install_session_hook()


class _Span:
    __slots__ = ("name", "device", "_rf", "_span", "_record")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        rec = _record.warmed()
        span = [self.name, rec.open[-1] if rec.open else -1, 0, 0, None]
        # torch's C++ annotation, a tenth of ``record_function``'s cost; the
        # clock is read next to it with nothing allocated in between, so that
        # no garbage collection falls between the profiler's read and this one
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        span[2] = time.time_ns()
        if self.device and torch.cuda.is_initialized():
            span[4] = [torch.cuda.Event(enable_timing=True), None]
            span[4][0].record()
        rec.open.append(len(rec.spans))
        rec.spans.append(span)
        self._span, self._record = span, rec
        return self

    def __exit__(self, *exc):
        span, rec = self._span, self._record
        if span[4] is not None:
            span[4][1] = torch.cuda.Event(enable_timing=True)
            span[4][1].record()
        if rec.open:
            rec.open.pop()
        span[3] = time.time_ns()
        self._rf.__exit__(*exc)
        return False


def enabled() -> bool:
    """Whether a profiler session records, so that spans and counters are
    on: for a caller whose counter value costs work to make."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, device: bool = False):
    """A context manager naming a region of the program; a no-op outside a
    profiler session (see the module's docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def count(name: str, value) -> None:
    """Add ``value`` (a host number, or a tensor summed on its device) to the
    session's counter ``name``; nothing outside a profiler session."""
    if _autograd_profiler._is_profiler_enabled:
        _record.counters.add(name, value)


def snapshot() -> dict:
    """The last session's record, after one device synchronisation:
    ``{"spans": [{name, parent, start_ns, end_ns, self_ns, device_ms}],
    "counts": {name: number}}``.  ``self_ns`` is the span's time less its
    children's; ``device_ms`` the time between its CUDA events (None without
    them); a span still open reads ``end_ns`` 0."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    spans = [{"name": name, "parent": parent, "start_ns": start, "end_ns": end,
              "self_ns": max(end - start, 0),
              "device_ms": ev[0].elapsed_time(ev[1]) if ev and ev[1] is not None else None}
             for name, parent, start, end, ev in _record.spans]
    for s in spans:
        if s["parent"] >= 0:
            spans[s["parent"]]["self_ns"] -= max(s["end_ns"] - s["start_ns"], 0)
    return {"spans": spans, "counts": _record.counters.values()}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block over CPU and CUDA activities (those this build of
    torch supports) and write its Chrome trace, ``*.pt.trace.json``, into
    ``log_dir`` (TensorBoard's profile plugin and Perfetto read it).  The
    port's spans are on inside it and show in the trace."""
    from torch.profiler import ProfilerActivity, profile, supported_activities, tensorboard_trace_handler

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


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
