"""What the per-layer readers share: the device's idle share, a span's
share of the window, and a kernel's share of its roofline."""


def idle_share(ctx):
    """100 x (1 - busy / window), busy the union of the device operations'
    intervals in the profiler's timeline; None where nothing ran."""
    if ctx.window_s <= 0 or not ctx.device:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def span_share(ctx, span: str):
    """100 x the seconds of the benchmark's span ``span`` over the window."""
    seconds = ctx.spans.get(span)
    if seconds is None or ctx.window_s <= 0:
        return None
    return 100.0 * seconds / ctx.window_s


def roofline(ctx, key: str, routes: dict, bound):
    """100 x (summed bound of the launches recorded under ``key``) / (summed
    device time of their kernels).  ``routes`` maps a launch's route (its
    record's ``route``, 'main' where it has none) to the names its kernels
    carry in the timeline: the first names the kernel launched once a call,
    the rest kernels that finish it.  None where nothing was launched, or
    where a route's launches in the timeline do not match its records one to
    one."""
    records = ctx.kernels.get(key, [])
    if not records:
        return None
    device_s, bound_s = 0.0, 0.0
    for route, names in routes.items():
        mine = [r for r in records if r.get("route", "main") == route]
        main = [t - s for name, s, t in ctx.device if names[0] in name]
        if len(main) != len(mine):
            return None
        device_s += sum(main) + sum(t - s for name, s, t in ctx.device
                                    if any(x in name for x in names[1:]))
        for r in mine:
            r = {k: (int(v) if hasattr(v, "item") else v) for k, v in r.items()}
            bound_s += bound(r)["bound_s"]
    if device_s <= 0:
        return None
    return 100.0 * bound_s / (device_s / 1e6)
