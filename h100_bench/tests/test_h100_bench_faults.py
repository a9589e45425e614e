"""Whole runs of every cell on the CPU at a tiny size, the harness's look for
a chip skipped: sound, each is correct; with the timed path broken
underneath in each way the cell can break, ``correct`` comes out false.

The faults: a token or an answer altered where it is produced; a step that
returns its state unchanged; half of the batch left out, the loss scaled
to the whole batch.  (No cell runs on more than one chip, so none has an
exchange between chips to leave out.)

Every cell, the spares included, gets the sound runs.  The faults are
declared by generator in ``COVERS``: a cell of a generator that a faults
file covers needs no edit here; a cell of a new generator brings its own
``test_h100_bench_faults_<generator>.py`` with its ``COVERS``.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import (ROOT, bench_with_spares, cell_names, declared_faults, run_tiny,
                      uncovered_generators)

CELLS = cell_names(bench_with_spares())

#: the fault tests of each generator, in this file
COVERS = {
    "island_cem": ["test_a_decoded_token_altered", "test_a_candidate_score_altered"],
    "train": ["test_a_training_step_that_leaves_its_state",
              "test_a_long_chunk_that_trains_on_its_first_batch", "test_half_the_batch_left_out"],
    "dense_climb": ["test_a_climb_that_leaves_its_start", "test_a_climb_answer_altered"],
    "delta_climb": ["test_a_climb_that_leaves_its_start", "test_a_climb_answer_altered",
                    "test_a_family_score_altered"],
}


def test_the_faults_cover_every_cell():
    assert uncovered_generators(bench_with_spares(), declared_faults()) == []


@pytest.mark.parametrize("generator,covered", [("island_cem", True), ("no_such_generator", False)])
def test_a_further_cell_needs_no_edit_here(tmp_path, generator, covered):
    """A copy of the benchmark with one more cell, added by its workload
    file and its entry in BENCHMARK.json alone: of a generator that a
    faults file covers, these tests take it unedited (its sound runs among
    them); of one that none covers, the coverage check fails."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    name = "alarm.island_cem.further"
    wl = json.loads((ROOT / "h100_bench" / "workloads" / "alarm.island_cem.json").read_text())
    wl.update(traffic="further", generator=generator)
    (tmp_path / "h100_bench" / "workloads" / f"{name}.json").write_text(json.dumps(wl))
    bench["workloads"].append({"name": name, "config": wl["config"], "traffic": "further",
                               "chips": 1, "why": "a further cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    def pytest_in_copy(*args):
        return subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
             "-p", "no:randomly", "h100_bench/tests/test_h100_bench_faults.py", *args],
            cwd=tmp_path, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": ""})

    collected = pytest_in_copy("--collect-only", "-k", "test_sound_runs_are_correct")
    for trace in (False, True):
        assert f"test_sound_runs_are_correct[{trace}-{name}]" in collected.stdout, collected.stdout
    check = pytest_in_copy("-k", "test_the_faults_cover_every_cell")
    assert (check.returncode == 0) == covered, check.stdout[-2000:]
    assert covered or f"['{generator}'] == []" in check.stdout, check.stdout[-2000:]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_runs_are_correct(cell, trace):
    result = run_tiny(cell, trace=trace)
    assert result["correct"], json.dumps(result["checks"])
    assert list(result["checks"]) == list(result)[-1:] or list(result)[-1] == "checks"
    if trace:
        assert result["metrics"], "a traced run reads some per-layer metric"


def test_a_decoded_token_altered(monkeypatch):
    from dags_vae_search_tpu_torch.models import decode

    original = decode._sample_decode

    def altered(*args, **kwargs):
        labels, adj, finished = original(*args, **kwargs)
        adj = adj.clone()
        adj[:, 1, -2] = 1.0 - adj[:, 1, -2]  # the input's edge into the last real slot
        return labels, adj, finished

    monkeypatch.setattr(decode, "_sample_decode", altered)
    result = run_tiny("alarm.island_cem")
    assert not result["correct"]
    assert result["checks"]["decode_gap"]["value"] > result["checks"]["decode_gap"]["limit"]


def test_a_candidate_score_altered(monkeypatch):
    from dags_vae_search_tpu_torch.scoring.bic import BicScorer

    original = BicScorer.score
    monkeypatch.setattr(BicScorer, "score", lambda self, adj: original(self, adj) * 1.001)
    result = run_tiny("alarm.island_cem")
    assert not result["correct"]


def test_a_training_step_that_leaves_its_state(monkeypatch):
    from dags_vae_search_tpu_torch.training.train import Trainer

    monkeypatch.setattr(Trainer, "apply_gradients",
                        lambda self, state: state._replace(step=state.step + 1))
    result = run_tiny("hepar2.train")
    assert not result["correct"]
    assert result["checks"]["update_norm_gap"]["value"] == pytest.approx(1.0)


def test_a_long_chunk_that_trains_on_its_first_batch(monkeypatch):
    """Only the window's chunks are longer than the set-up's calls (one
    step, then two): a long chunk that repeats its first batch shows in the
    window chunk's number alone."""
    from dags_vae_search_tpu_torch.training.train import Trainer

    original = Trainer.chunk_step

    def stale(self, state, labels, adj, block, generator=None):
        if block.shape[0] > 2:
            block = block[:1].expand_as(block)
        return original(self, state, labels, adj, block, generator)

    monkeypatch.setattr(Trainer, "chunk_step", stale)
    result = run_tiny("hepar2.train")
    assert not result["correct"]
    checks = result["checks"]
    assert checks["update_norm_gap"]["value"] <= checks["update_norm_gap"]["limit"]
    assert checks["chunk_loss_rel_err"]["value"] > checks["chunk_loss_rel_err"]["limit"]


def test_half_the_batch_left_out(monkeypatch):
    from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE

    original = PaceVAE.loss

    def half(self, labels, adj, *args, **kwargs):
        keep = labels.shape[0] // 2
        total, recon, kld = original(self, labels[:keep], adj[:keep], *args, **kwargs)
        return 2 * total, 2 * recon, 2 * kld

    monkeypatch.setattr(PaceVAE, "loss", half)
    result = run_tiny("hepar2.train")
    assert not result["correct"]


@pytest.mark.parametrize("cell,module,name", [
    ("alarm.dense_climb", "hillclimb", "hill_climb"),
    ("hepar2.delta_climb.binary", "delta_hillclimb", "delta_hill_climb"),
])
def test_a_climb_that_leaves_its_start(monkeypatch, cell, module, name):
    import importlib

    mod = importlib.import_module(f"dags_vae_search_tpu_torch.search.{module}")
    original = getattr(mod, name)

    def stuck(scorer, n, init_adj=None, **kwargs):
        res = original(scorer, n, init_adj=init_adj, max_iters=0)
        return res._replace(converged=True)

    monkeypatch.setattr(mod, name, stuck)
    result = run_tiny(cell)
    assert not result["correct"]
    assert result["checks"]["climb_gain_left"]["value"] > 1.0


@pytest.mark.parametrize("cell,module,name", [
    ("alarm.dense_climb", "hillclimb", "hill_climb"),
    ("hepar2.delta_climb.binary", "delta_hillclimb", "delta_hill_climb"),
])
def test_a_climb_answer_altered(monkeypatch, cell, module, name):
    import importlib

    mod = importlib.import_module(f"dags_vae_search_tpu_torch.search.{module}")
    original = getattr(mod, name)

    def altered(*args, **kwargs):
        res = original(*args, **kwargs)
        return res._replace(best_score=res.best_score + 1.0)

    monkeypatch.setattr(mod, name, altered)
    result = run_tiny(cell)
    assert not result["correct"]


def test_a_family_score_altered(monkeypatch):
    from dags_vae_search_tpu_torch.scoring import family_batch

    original = family_batch._score_families
    monkeypatch.setattr(family_batch, "_score_families",
                        lambda *args: original(*args) * torch.tensor(1.001))
    result = run_tiny("hepar2.delta_climb.binary")
    assert not result["correct"]
    assert np.isfinite(result["checks"]["score_rel_err"]["value"])
