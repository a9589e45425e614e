"""The controls of the checks: the reference in the program's place one
precision down (and, for training, with half of each batch left out) comes
out beyond a limit, where the program stays within every limit.  On the
CPU at a tiny size for every cell; on the card at each cell's own size."""

import sys

import pytest
from conftest import bench_with_spares, tiny_files

from h100_bench import harness

sys.path.insert(0, str(harness.HERE))
import control  # noqa: E402

CELLS = [w["name"] for w in harness.read_json("..", "BENCHMARK.json")["workloads"]]
ALL_CELLS = [w["name"] for w in bench_with_spares()["workloads"]]


def beyond(readings: dict, limits: dict) -> bool:
    return any(readings[k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_the_control_fails_where_the_program_holds(cell):
    _, entry, wl, cfg = tiny_files(cell)
    out = control.readings(cell, 7, 0.5, "cpu", files=(entry, wl, cfg))
    assert not beyond(out["program"], wl["limits"]), out
    assert beyond(out["control"], wl["limits"]), out
    if "half_batch" in out:
        assert beyond(out["half_batch"], wl["limits"]), out


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_at_the_cell_s_size(cuda, cell):
    limits = harness.read_json("workloads", f"{cell}.json")["limits"]
    out = control.readings(cell, 7, 3.0)
    assert not beyond(out["program"], limits), out
    assert beyond(out["control"], limits), out
