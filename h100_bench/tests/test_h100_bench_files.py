"""The benchmark's files: every name in ``BENCHMARK.json`` resolves to its
files, the file keeps the contract's shape, no module of the benchmark
imports JAX or the JAX package, and the reference imports nothing of the
program."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

from h100_bench import harness

BENCH = harness.read_json("..", "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves_to_its_files():
    for w in BENCH["workloads"]:
        entry, wl, cfg = harness.cell_files(w["name"], BENCH)
        assert (harness.HERE / "traffic" / f"{wl['generator']}.py").is_file()
        assert cfg["name"] == w["config"]
        assert w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert set(wl["limits"]) and all(v >= 0 for v in wl["limits"].values())
        assert wl["rate_metric"] in {m["name"] for m in harness.metric_names(w["name"], BENCH,
                                                                           False)}
        assert "setup_s" in {m["name"] for m in harness.metric_names(w["name"], BENCH, False)}
        assert harness.metric_names(w["name"], BENCH, True), "every cell reads a layer"


def test_every_metric_has_its_reader():
    for m in BENCH["per_layer"]:
        module = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py")
        assert callable(module.read)
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_configurations_list_what_they_change():
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(key in cfg for key in c["reduced"])
        assert len(cfg["source"]) <= 200
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_names_and_bounds_keep_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for item in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(item["name"]), item["name"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(harness.ROOT / "BENCHMARK.json") <= 64 * 1024


def imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            found.add(node.module)
    return found


def test_no_module_of_the_benchmark_imports_jax():
    for path in harness.HERE.rglob("*.py"):
        tops = {name.split(".", 1)[0] for name in imports(path)}
        assert not tops & set(harness.BANNED), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        for name in imports(path):
            top = name.split(".", 1)[0]
            assert top != "dags_vae_search_tpu_torch", path
            assert top != "h100_bench" or name.startswith("h100_bench.reference"), path


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dags_vae_search_tpu_torch_fake", types.ModuleType("x"))
    assert harness.banned_loaded() == []
    monkeypatch.setitem(sys.modules, "dags_vae_search_tpu.sub", types.ModuleType("x"))
    assert harness.banned_loaded() == ["dags_vae_search_tpu"]


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", BENCH["workloads"][0]["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert not proc.stdout.strip().endswith("}")
