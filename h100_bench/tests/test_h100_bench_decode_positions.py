"""The reader of ``decode_positions_per_row.search`` on a synthetic context
and snapshot: the program's ``decode.positions`` over ``decode.rows``, and
None where the program counted neither."""

from types import SimpleNamespace

import pytest

from h100_bench import harness

NAME = "decode_positions_per_row.search"


def ctx_of(counts, spans=()):
    return SimpleNamespace(window_s=1e-3, busy_s=0.0, device=[("k", 0, 10)],
                           program={"spans": list(spans), "counts": counts})


def metric():
    return harness.load_module(harness.HERE / "metrics" / f"{NAME}.py")


def test_positions_per_row_of_the_decode():
    # alarm's 40 slots: 2 positions at slot 2, then 1 a slot to slot 39
    ctx = ctx_of({"decode.rows": 4608.0, "decode.positions": 4608.0 * 39})
    assert metric().read(ctx) == pytest.approx(39.0)


@pytest.mark.parametrize("counts", [{}, {"other": 1.0}, {"decode.positions": 8.0},
                                    {"decode.rows": 8.0}, {"decode.rows": 0.0,
                                                           "decode.positions": 0.0}])
def test_the_reader_reads_none_without_its_counters(counts):
    spans = [{"name": "elsewhere", "parent": -1, "start_ns": 0, "end_ns": 100_000,
              "self_ns": 100_000, "device_ms": None}]
    assert metric().read(ctx_of(counts, spans)) is None


def test_the_reader_reads_none_from_a_program_without_the_tracer(monkeypatch):
    from dags_vae_search_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    ctx = SimpleNamespace(window_s=1.0, busy_s=0.5, device=[("k", 0, 10)])
    assert metric().read(ctx) is None
