"""Fixtures of the benchmark's CPU tests: a cell's files cut to a tiny size
(every width shrunk, the same code paths), and a run of it on the CPU that
skips the harness's look for a chip."""

import copy
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402


def bench_with_spares() -> dict:
    """BENCHMARK.json with the cells whose files the benchmark keeps but
    which it does not run yet: a workload file's ``entries`` are the
    workload, end-to-end and per-layer entries such a cell adds."""
    bench = harness.read_json("..", "BENCHMARK.json")
    named = {w["name"] for w in bench["workloads"]}
    for path in sorted((harness.HERE / "workloads").glob("*.json")):
        entries = json.loads(path.read_text()).get("entries")
        if entries and path.stem not in named:
            bench["workloads"].append(entries["workload"])
            bench["end_to_end"] += entries["end_to_end"]
            bench["per_layer"] += entries["per_layer"]
    return bench


def tiny_files(cell: str, n: int = 6):
    """(BENCHMARK.json, entry, workload, configuration) of ``cell`` at n
    vertices, three states a variable, embed 8, one layer."""
    bench = bench_with_spares()
    entry, wl, cfg = harness.cell_files(cell, bench)
    cfg, wl = copy.deepcopy(cfg), copy.deepcopy(wl)
    cfg.update(num_vertices=n, num_edges=n, label_cardinality=n, simulate_cases=300,
               simulate_max_card=3, q_cap=min(3 ** min(cfg["max_parents"], n - 1), 4096),
               seed_corpus_graphs=64)
    if "model" in cfg:  # a configuration that runs the model
        cfg["model"].update(embed_size=8, num_heads=2, num_layers=1, latent_size=16, fc_hidden=8,
                            edge_readout_rank=min(cfg["model"]["edge_readout_rank"], 4))
        cfg["corpus"]["graphs"] = 64
        cfg["train"].update(batch_size=8, steps_per_call=3)
    cfg["search"].update(islands=2, island_population=16, island_iters=2, island_subspace=4,
                         exploit_repeats=4, hill_climb_restarts=2, hill_climb_iters=20,
                         score_chunk=32)
    return bench, entry, wl, cfg


def run_tiny(cell: str, seed: int = 11, seconds: float = 0.5, trace: bool = False) -> dict:
    bench, entry, wl, cfg = tiny_files(cell)
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(), device_name="cpu",
                            look_for_chip=False, bench=bench, files=(entry, wl, cfg))


@pytest.fixture
def cuda():
    """Skips the test where no CUDA card is present (decided here, not at
    import, so that every worker collects the same tests)."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
