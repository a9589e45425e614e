"""The readers of the program's own spans and counters
(``metrics_program.py`` and the metrics built on it), on a synthetic
context and snapshot: idle gaps split over the innermost spans by overlap,
time in no span given to none, and None where the program recorded
nothing a reader reads."""

from types import SimpleNamespace

import pytest

from h100_bench import harness, metrics_program

US = 1000  # ns in a µs


def span(name, parent, start_us, end_us, self_us=None, device_ms=None):
    return {"name": name, "parent": parent, "start_ns": start_us * US, "end_ns": end_us * US,
            "self_ns": (end_us - start_us if self_us is None else self_us) * US,
            "device_ms": device_ms}


def ctx_of(spans, counts=None, device=(), window_s=1e-3, busy_s=0.0):
    """A traced run's context: device operations (name, start µs, end µs)
    on the spans' clock, and the program's snapshot."""
    return SimpleNamespace(window_s=window_s, busy_s=busy_s, device=list(device),
                           program={"spans": spans, "counts": counts or {}})


def metric(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


# one climb: 0-100 µs, a score call inside it at 20-60, a read at 70-90;
# the device busy 0-10, 30-40 and 95-200: idle 10-30, 40-95
CLIMB = [span("climb", -1, 0, 100, self_us=40), span("score", 0, 20, 60),
         span("climb.read", 0, 70, 90)]
OPS = [("k", 0, 10), ("k", 30, 40), ("k", 95, 200)]


def test_a_gap_splits_over_the_innermost_spans_by_overlap():
    ctx = ctx_of(CLIMB, device=OPS)
    idle = metrics_program.idle_by_span(ctx)
    # 10-30: climb 10-20, score 20-30; 40-95: score 40-60, climb 60-70 and
    # 90-95, climb.read 70-90
    assert idle == {0: pytest.approx(25.0), 1: pytest.approx(30.0), 2: pytest.approx(20.0)}
    assert metric("climb_host_idle.climb").read(ctx) == pytest.approx(100 * 45e-6 / 1e-3)


def test_time_in_no_span_goes_to_none():
    spans = [span("decode", -1, 20, 50), span("decode.model", 0, 25, 35, device_ms=0.004),
             span("search.read", -1, 70, 80)]
    ops = [("k", 0, 10), ("k", 100, 110)]  # one gap, 10-100
    ctx = ctx_of(spans, device=ops, window_s=110e-6, busy_s=20e-6)
    idle = metrics_program.idle_by_span(ctx)
    assert idle == {0: pytest.approx(20.0), 1: pytest.approx(10.0), 2: pytest.approx(10.0)}
    # 10-20, 50-70 and 80-100 lie in no span
    assert metrics_program.unattributed_s(ctx) == pytest.approx(50e-6)
    assert metric("decode_idle.search").read(ctx) == pytest.approx(100 * 30 / 110)
    assert metric("decode_model_share.search").read(ctx) == pytest.approx(100 * 4 / 110)


def test_shares_and_ratios_of_the_delta_climb():
    spans = [span("climb", -1, 0, 1000, self_us=100), span("delta.frontier", 0, 0, 300),
             span("delta.closure", 0, 300, 400), span("delta.build", 0, 400, 450),
             span("family", 0, 450, 1000, self_us=50), span("family.upload", 4, 450, 500),
             span("family.launch", 4, 500, 700), span("family.reduce", 4, 700, 800),
             span("family.read", 4, 800, 1000)]
    ctx = ctx_of(spans, counts={"delta.families": 600.0, "delta.moves": 4.0}, window_s=2e-3)
    assert metric("frontier_share.delta").read(ctx) == pytest.approx(15.0)
    assert metric("closure_share.delta").read(ctx) == pytest.approx(5.0)
    assert metric("build_share.delta").read(ctx) == pytest.approx(2.5)
    assert metric("family_host_share.delta").read(ctx) == pytest.approx(17.5)
    assert metric("families_per_move.delta").read(ctx) == pytest.approx(150.0)
    assert metrics_program.cover_share(ctx, {"climb", "climb.restart"}) == pytest.approx(50.0)


def test_rows_useful_of_the_dense_climb():
    ctx = ctx_of([], counts={"climb.rows_scored": 8192.0, "climb.moves_feasible": 1229.0})
    assert metric("score_rows_useful.climb").read(ctx) == pytest.approx(100 * 1229 / 8192)


NEW = ["decode_model_share.search", "decode_idle.search", "score_rows_useful.climb",
       "climb_host_idle.climb", "frontier_share.delta", "closure_share.delta",
       "build_share.delta", "family_host_share.delta", "families_per_move.delta"]


@pytest.mark.parametrize("name", NEW)
def test_a_reader_reads_none_where_its_spans_are_absent(name):
    other = [span("elsewhere", -1, 0, 100)]
    assert metric(name).read(ctx_of(other, device=OPS)) is None
    assert metric(name).read(ctx_of(other, counts={"other": 1.0}, device=OPS)) is None


@pytest.mark.parametrize("name", NEW)
def test_a_reader_reads_none_from_a_program_without_the_tracer(name, monkeypatch):
    from dags_vae_search_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    ctx = SimpleNamespace(window_s=1.0, busy_s=0.5, device=OPS)
    assert metric(name).read(ctx) is None
