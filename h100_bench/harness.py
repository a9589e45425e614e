"""The benchmark's driver: finds a cell's files by name, runs its set-up and
its measured window, checks what the window produced against the plain
reference, reads the per-layer metrics, and prints the result line.

A cell ``<name>`` is ``BENCHMARK.json``'s workload entry plus
``workloads/<name>.json`` (its configuration, traffic, generator, the
generator's parameters and the limits of its checks).  The generator is
``traffic/<generator>.py``, the configuration ``configs/<config>.json``,
each per-layer metric ``metrics/<metric>.py``.  Adding a cell, a
configuration or a metric adds files; nothing here names one.

A generator module defines ``Traffic(cfg, params, seed, device)``, whose
construction is the set-up (inputs, weights, the program's objects and one
warm unit), with:

- ``unit(k) -> float``: the k-th unit of work of the window, synchronised at
  its end; returns the work it completed in the rate's unit;
- ``instrument(spans, kernels) -> list``: (object, attribute, wrapper
  factory) patches that put the benchmark's spans and kernel-input records
  around the program's calls, for the traced run;
- ``counts``: what the units completed, read by the per-layer metrics;
- ``release()``: frees the program's state once the window has closed;
- ``check(prec) -> list``: the numbers compared, each ``{"name", "value"}``,
  with the reference at ``prec`` ('fp32' for a run, the control's for the
  control).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: modules no run may load, compared by their whole top-level name
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "dags_vae_search_tpu")


def banned_loaded() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(BANNED))


def read_json(*parts: str) -> dict:
    with open(HERE.joinpath(*parts)) as fh:
        return json.load(fh)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"h100_bench_{path.stem.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(name: str, bench: dict) -> tuple:
    """(BENCHMARK.json's entry, the workload file, the configuration) of
    cell ``name``; raises where they disagree."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    wl = read_json("workloads", f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if wl[key] != entry[key]:
            raise SystemExit(f"workloads/{name}.json: {key} {wl[key]!r} != {entry[key]!r}")
    return entry, wl, read_json("configs", f"{wl['config']}.json")


def metric_names(name: str, bench: dict, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in reported else [])]


class Spans:
    """Host-clock spans around calls into a layer, each synchronised at the
    call's end and named in the profiler's timeline; off outside the traced
    run, where a span costs nothing."""

    def __init__(self, device):
        self.device = device
        self.on = False
        self.seconds: dict = {}

    def wrap(self, name: str, fn):
        import torch

        def wrapped(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"bench.{name}"):
                out = fn(*args, **kwargs)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            return out

        return wrapped


@contextlib.contextmanager
def patched(patches: list):
    """Apply (object, attribute, factory) patches: ``factory(original)``
    gives the replacement; restored on exit."""
    saved = []
    try:
        for obj, attr, factory in patches:
            original = getattr(obj, attr)
            saved.append((obj, attr, original, attr in getattr(obj, "__dict__", {})))
            setattr(obj, attr, factory(original))
        yield
    finally:
        for obj, attr, original, own in reversed(saved):
            if own:
                setattr(obj, attr, original)
            else:
                delattr(obj, attr)


def run_window(traffic, seconds: float, sync, max_units: int = 0) -> tuple:
    """Units until ``seconds`` have elapsed (or ``max_units`` are done):
    (work, seconds to the end of the last unit, units, each unit's
    seconds)."""
    work, ends = 0.0, []
    t0 = time.perf_counter()
    while True:
        work += traffic.unit(len(ends))
        sync()
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds or (max_units and len(ends) >= max_units):
            return work, ends[-1], len(ends), list(np.diff([0.0] + ends))


def read_trace(prof, window_s: float) -> SimpleNamespace:
    """Device operations, their busy seconds (the union of their intervals),
    and the benchmark's host spans, from a profiler window (its raw events:
    building the profiler's event tree takes minutes on a long window)."""
    import torch

    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), start, end))
        elif e.name().startswith("bench."):
            spans.append((e.name()[len("bench."):], start, end))
    device.sort(key=lambda x: x[1])
    busy, gaps, end = 0.0, [], None
    for _, s, t in device:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return SimpleNamespace(device=device, spans=spans, gaps=gaps, busy_s=busy / 1e6,
                           window_s=window_s)


def breakdown(tr) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps of the device, each named by the benchmark span the host was
    in halfway through it."""
    by_name: dict = {}
    for name, s, t in tr.device:
        key = name[:120]
        by_name[key] = by_name.get(key, 0.0) + (t - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    for s, t in sorted(tr.gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + t) / 2  # the host's span halfway through the gap
        inside = [sp for sp in tr.spans if sp[1] <= mid < sp[2]]
        label = min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside else "outside the spans"
        gaps.append([label, (t - s) / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}


def card_limits() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or "power limit not read"
    except (OSError, subprocess.TimeoutExpired):
        return "power limit not read"


def judge(checks: list, limits: dict) -> tuple:
    """(correct, numbers over their limits, {name: {value, limit}}):
    correct when every number is at or under its limit (a NaN is not), and
    none is missing."""
    table, failed = {}, 0
    for c in checks:
        limit = limits.get(c["name"])
        failed += not (limit is not None and c["value"] <= limit)
        table[c["name"]] = {"value": c["value"], "limit": limit}
    failed += len(set(limits) - set(table))
    return failed == 0, failed, table


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device_name: str = "cuda", look_for_chip: bool = True, bench=None,
             files=None) -> dict:
    """One run of cell ``name``; returns the result line's object.  Tests
    pass ``look_for_chip=False`` with small ``files`` to run it on the CPU."""
    import torch

    bench = bench if bench is not None else read_json("..", "BENCHMARK.json")
    entry, wl, cfg = files if files is not None else cell_files(name, bench)
    if look_for_chip:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < entry["chips"]:
            raise SystemExit(f"{entry['chips']} cards wanted, {torch.cuda.device_count()} present")
    device = torch.device(device_name)
    generator = load_module(HERE / "traffic" / f"{wl['generator']}.py")
    traffic = generator.Traffic(cfg, wl["params"], seed, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    setup_s = time.perf_counter() - t_start
    spans = Spans(device)
    kernels: dict = {}
    metrics, tr, extra = {}, None, {}
    wanted = metric_names(name, bench, trace)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with patched(traffic.instrument(spans, kernels)):
            prof = profile(activities=acts)
            prof.start()
            spans.on = True
            traffic.counts.clear()
            work, elapsed, units, unit_s = run_window(traffic, seconds, sync,
                                                      int(wl["params"].get("trace_units", 0)))
            spans.on = False
            prof.stop()
        tr = read_trace(prof, elapsed)
        del prof
    else:
        work, elapsed, units, unit_s = run_window(traffic, seconds, sync)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    traffic.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = traffic.check("fp32")
    correct, failed, table = judge(checks, wl["limits"])

    if trace:
        ctx = SimpleNamespace(cell=name, config=cfg, params=wl["params"], window_s=tr.window_s,
                              busy_s=tr.busy_s, device=tr.device, spans=spans.seconds,
                              counts=traffic.counts, kernels=kernels)
        for m in wanted:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["breakdown"] = breakdown(tr)
    else:
        for m in wanted:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] == wl["rate_metric"]:
                metrics[m["name"]] = {"value": work / elapsed, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": entry["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    return {"correct": bool(correct), "attempted": units, "failed": failed, "metrics": metrics,
            "device": dev, **extra, "unit_seconds": unit_s, "checks": table}


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from h100_bench import peaks

    print(f"card: {card_limits()}; peaks: {peaks.FP32_PER_S:.3g} FLOP/s float32, "
          f"{peaks.BYTES_PER_S:.3g} B/s, INT32 {peaks.INT32_PER_S:.4g} op/s", file=sys.stderr)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    found = banned_loaded()
    if found:
        print(f"modules that no run may load are loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    unit_s = result.pop("unit_seconds")
    print(f"units: {len(unit_s)}, seconds each: min {min(unit_s):.4f}, median "
          f"{float(np.median(unit_s)):.4f}, max {max(unit_s):.4f}; in order: "
          + " ".join(f"{u:.3f}" for u in unit_s), file=sys.stderr)
    for key, v in result["checks"].items():
        print(f"check {key}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0
