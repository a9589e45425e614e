"""The reader of ``decode_graph_share.search`` on a synthetic context and
snapshot: 100 x the program's ``decode.graph_rows`` over ``decode.rows``,
and None where the program counted neither."""

from types import SimpleNamespace

import pytest

from h100_bench import harness

NAME = "decode_graph_share.search"


def ctx_of(counts):
    return SimpleNamespace(window_s=1e-3, busy_s=0.0, device=[("k", 0, 10)],
                           program={"spans": [], "counts": counts})


def metric():
    return harness.load_module(harness.HERE / "metrics" / f"{NAME}.py")


@pytest.mark.parametrize("graph_rows,share", [(32_768.0 * 6 + 256.0, 100.0), (0.0, 0.0),
                                              (32_768.0, 100.0 * 32_768 / (32_768 * 6 + 256))])
def test_the_share_of_rows_replayed_from_graphs(graph_rows, share):
    ctx = ctx_of({"decode.rows": 32_768.0 * 6 + 256.0, "decode.graph_rows": graph_rows})
    assert metric().read(ctx) == pytest.approx(share)


@pytest.mark.parametrize("counts", [{}, {"decode.rows": 8.0}, {"decode.graph_rows": 8.0},
                                    {"decode.rows": 0.0, "decode.graph_rows": 0.0}])
def test_the_reader_reads_none_without_its_counters(counts):
    assert metric().read(ctx_of(counts)) is None


def test_the_reader_reads_none_from_a_program_without_the_tracer(monkeypatch):
    from dags_vae_search_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    ctx = SimpleNamespace(window_s=1.0, busy_s=0.5, device=[("k", 0, 10)])
    assert metric().read(ctx) is None
