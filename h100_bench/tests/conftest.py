"""Fixtures of the benchmark's CPU tests: a cell's files cut to a tiny size
(every width shrunk, the same code paths), and a run of it on the CPU that
skips the harness's look for a chip."""

import ast
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


def cell_names(bench: dict) -> list:
    return [w["name"] for w in bench["workloads"]]


def declared_faults(tests_dir: Path = Path(__file__).parent) -> dict:
    """{generator: [fault tests]}: the union of the module-level ``COVERS``
    of every ``test_h100_bench_faults*.py``, each test named with its file
    (read from the source, so that no test module is imported twice)."""
    covers: dict = {}
    for path in sorted(tests_dir.glob("test_h100_bench_faults*.py")):
        tree = ast.parse(path.read_text())
        defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "COVERS" for t in node.targets):
                for generator, tests in ast.literal_eval(node.value).items():
                    missing = set(tests) - defined
                    if missing:
                        raise ValueError(f"{path.name}: COVERS names {sorted(missing)}, "
                                         "which the file does not define")
                    covers.setdefault(generator, []).extend(f"{path.name}::{t}" for t in tests)
    return covers


def uncovered_generators(bench: dict, covers: dict) -> list:
    """The generators that some cell of ``bench`` uses and no fault test
    covers."""
    used = {harness.read_json("workloads", f"{name}.json")["generator"]
            for name in cell_names(bench)}
    return sorted(g for g in used if not covers.get(g))


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
