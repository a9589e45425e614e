"""What the readers of the program's own spans and counters share.

The program (``dags_vae_search_tpu_torch/utils/profiling.py``) records its
spans and counters while a profiler session runs; ``snapshot()`` gives them
once the traced window has closed.  Its spans are timed by the Unix clock
in nanoseconds, the clock of the profiler's events (``ctx.device``, in
microseconds), so each idle gap of the device is split over the innermost
span the host was in during it.  Every reader returns None where the
program recorded nothing it reads (a program without the tracer, or a
span that did not run).
"""

from __future__ import annotations


def record(ctx):
    """The program's record of the traced window, read once a run and kept on
    ``ctx`` (tests give ``ctx.program`` themselves); None where the program
    has no tracer."""
    if not hasattr(ctx, "program"):
        try:
            from dags_vae_search_tpu_torch.utils import profiling

            ctx.program = profiling.snapshot()
        except (ImportError, AttributeError):
            ctx.program = None
    return ctx.program


def _spans(ctx, names) -> list:
    rec = record(ctx)
    if rec is None:
        return []
    return [s for s in rec["spans"] if s["name"] in names]


def self_share(ctx, names) -> float | None:
    """100 x the self time of the spans named in ``names`` over the window."""
    spans = _spans(ctx, names)
    if not spans or ctx.window_s <= 0:
        return None
    return 100.0 * sum(s["self_ns"] for s in spans) / 1e9 / ctx.window_s


def cover_share(ctx, names) -> float | None:
    """100 x the time of the spans named in ``names`` over the window (for
    spans that do not nest in each other)."""
    spans = _spans(ctx, names)
    if not spans or ctx.window_s <= 0:
        return None
    return 100.0 * sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e9 / ctx.window_s


def device_share(ctx, name: str) -> float | None:
    """100 x the stream time between the CUDA events of the spans ``name``
    (the stream's idle stretches between them included) over the window."""
    ms = [s["device_ms"] for s in _spans(ctx, {name}) if s["device_ms"] is not None]
    if not ms or ctx.window_s <= 0:
        return None
    return 100.0 * sum(ms) / 1e3 / ctx.window_s


def count(ctx, name: str) -> float | None:
    rec = record(ctx)
    return None if rec is None else rec["counts"].get(name)


def gaps(device: list) -> list:
    """The device's idle gaps (start, end), in µs, between its operations
    (name, start, end), as the harness finds them."""
    out, end = [], None
    for _, s, t in sorted(device, key=lambda d: d[1]):
        if end is not None and s > end:
            out.append((end, s))
        end = t if end is None else max(end, t)
    return out


def innermost(spans: list) -> list:
    """(start, end, span index) in µs, in time order: the host's time cut
    at every span's bounds, each piece given to the innermost span open over
    it; time in no span is left out.  Spans of one thread nest, so the
    pieces do not overlap."""
    start = [s["start_ns"] for s in spans]
    end = [max(s["end_ns"], s["start_ns"]) for s in spans]  # a span left open: none
    order = sorted(range(len(spans)), key=lambda i: (start[i], -end[i]))
    pieces, stack, at = [], [], None

    def close_until(t):
        nonlocal at
        while stack and end[stack[-1]] <= t:
            top = stack.pop()
            pieces.append((at, end[top], top))
            at = end[top]

    for i in order:
        s = start[i]
        close_until(s)
        if stack:
            pieces.append((at, s, stack[-1]))
        stack.append(i)
        at = s
    close_until(float("inf"))
    return [(a / 1e3, b / 1e3, i) for a, b, i in pieces if b > a]


def idle_by_span(ctx) -> dict | None:
    """{span index: µs of device idle time the host spent innermost in it};
    None without device operations or the program's spans."""
    rec = record(ctx)
    if rec is None or not rec["spans"] or not ctx.device:
        return None
    pieces = innermost(rec["spans"])
    out: dict = {}
    j = 0
    for gs, ge in gaps(ctx.device):
        while j < len(pieces) and pieces[j][1] <= gs:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < ge:
            a, b, i = pieces[k]
            overlap = min(b, ge) - max(a, gs)
            if overlap > 0:
                out[i] = out.get(i, 0.0) + overlap
            k += 1
    return out


def idle_share(ctx, keep) -> float | None:
    """100 x the device's idle time whose innermost host span passes
    ``keep(span, spans)`` over the window; None where no span passes."""
    idle = idle_by_span(ctx)
    if idle is None or ctx.window_s <= 0:
        return None
    spans = record(ctx)["spans"]
    if not any(keep(s, spans) for s in spans):
        return None
    total = sum(us for i, us in idle.items() if keep(spans[i], spans))
    return 100.0 * total / 1e6 / ctx.window_s


def under(name: str):
    """A ``keep`` for :func:`idle_share`: the span ``name`` or one inside it."""

    def keep(span, spans):
        while True:
            if span["name"] == name:
                return True
            if span["parent"] < 0:
                return False
            span = spans[span["parent"]]

    return keep


def unattributed_s(ctx) -> float | None:
    """Seconds of the device's idle time (window less busy) that no program
    span covers."""
    idle = idle_by_span(ctx)
    if idle is None:
        return None
    return ctx.window_s - ctx.busy_s - sum(idle.values()) / 1e6
