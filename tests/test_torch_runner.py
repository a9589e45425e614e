"""The port's ``ExperimentRunner`` and CLI against the JAX package's, on asia
with a tiny model (embed 8, one layer, latent 16), corpus batch 1, one
epoch and small search settings, on the CPU.

- dataset provisioning (simulated ground truth, its constructive fallback)
  and the generated corpus and splits: bit-equal;
- the structure half of ``search`` (exact DP, hill climbing): 1e-9 relative;
- with the JAX runner's trained parameters carried over by ``convert.py``:
  ``eval``'s mode metrics equal (the mode decode draws nothing), the
  predictor set's vectors 1e-5 relative and targets 1e-9, ``roundtrip``'s
  true BIC 1e-9 and GP prediction 1e-3 relative (a 20-step GP fit in
  float32 in each framework);
- the whole CLI on ``--device cpu``: every report written, none skipped,
  mirrored into ``reports_torch/`` and never into ``reports/``.
"""

import copy
import json
import os

import numpy as np
import pytest

from dags_vae_search_tpu.experiments import registry as jregistry
from dags_vae_search_tpu.experiments import runner as jrunner
from dags_vae_search_tpu.graphs import codec as jcodec
from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.utils.config import ExperimentConfig as JExperimentConfig
from dags_vae_search_tpu_torch.convert import flax_to_state_dict
from dags_vae_search_tpu_torch.experiments import registry as tregistry
from dags_vae_search_tpu_torch.experiments import runner as trunner
from dags_vae_search_tpu_torch.graphs import codec as tcodec
from dags_vae_search_tpu_torch.graphs import sampler as tsampler
from dags_vae_search_tpu_torch.training import checkpoint as tckpt
from dags_vae_search_tpu_torch.utils.config import ExperimentConfig as TExperimentConfig

STAGES = ("generate", "split", "train", "eval", "predictor", "gp", "search", "roundtrip", "viz")
MODE_KEYS = ("valid_ratio_mode", "structure_accuracy_mode", "perfect_accuracy_mode")


def tiny(config):
    """The asia experiment cut to test size; the same edits on either
    package's config object."""
    config = copy.deepcopy(config)
    config.corpus.batch_size = 1
    config.corpus.max_in_degree = 3
    config.simulate_cases = 500
    m = config.model
    m.embed_size, m.num_heads, m.num_layers, m.latent_size, m.fc_hidden = 8, 2, 1, 16, 8
    t = config.train
    t.epochs, t.batch_size, t.steps_per_call, t.log_every = 1, 4, 1, 0
    s = config.search
    s.max_parents, s.islands, s.island_population, s.island_iters = 3, 2, 16, 2
    s.refine_iters, s.refine_population, s.hill_climb_iters, s.hill_climb_restarts = 1, 16, 50, 2
    s.island_subspace, s.budget_compare_evals, s.gp_iters = 4, 32, 20
    s.gp_ascent_seeds, s.gp_ascent_rounds, s.bo_rounds = 8, 1, 1
    return config


def _unit_configs(n=9):
    kw = dict(name="unit_sim", num_vertices=n, label_cardinality=n, simulate_cases=64)
    return JExperimentConfig(**kw), TExperimentConfig(**kw)


def _assert_same_dataset(jr, tr):
    jds, tds = jr.scoring_dataset(), tr.scoring_dataset()
    np.testing.assert_array_equal(tds.codes, jds.codes)
    np.testing.assert_array_equal(tds.cards, jds.cards)
    np.testing.assert_array_equal(tr._truth_adj, jr._truth_adj)
    assert tds.columns == jds.columns


def test_scoring_dataset_simulates_and_persists_as_jax(tmp_path):
    jcfg, tcfg = _unit_configs()
    jr = jrunner.ExperimentRunner(jcfg, data_dir=str(tmp_path / "jax"))
    tr = trunner.ExperimentRunner(tcfg, data_dir=str(tmp_path / "torch"), device="cpu")
    _assert_same_dataset(jr, tr)
    # persisted, and reloaded identically by a fresh runner
    again = trunner.ExperimentRunner(tcfg, data_dir=str(tmp_path / "torch"), device="cpu")
    _assert_same_dataset(jr, again)
    assert os.path.isfile(tmp_path / "torch" / "unit_sim" / "simulated_codes.npz")


def test_scoring_dataset_constructive_fallback_as_jax(tmp_path, monkeypatch):
    def exhausted(*args, **kwargs):
        raise RuntimeError("max_rounds exceeded with no connected DAG generated")

    monkeypatch.setattr(jsampler, "sample_er_batch", exhausted)
    monkeypatch.setattr(tsampler, "sample_er_batch", exhausted)
    jcfg, tcfg = _unit_configs()
    jr = jrunner.ExperimentRunner(jcfg, data_dir=str(tmp_path / "jax"))
    tr = trunner.ExperimentRunner(tcfg, data_dir=str(tmp_path / "torch"), device="cpu")
    _assert_same_dataset(jr, tr)
    truth = tr._truth_adj
    assert np.allclose(np.tril(truth), 0.0) and (truth[:, 1:].sum(axis=0) >= 1).all()


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """Both runners after generate and split; the JAX one trained one epoch,
    its parameters converted into the port runner's ``checkpoints/``."""
    root = tmp_path_factory.mktemp("runner")
    jr = jrunner.ExperimentRunner(tiny(jregistry.REGISTRY["asia"]), data_dir=str(root / "jax"))
    tr = trunner.ExperimentRunner(tiny(tregistry.REGISTRY["asia"]), data_dir=str(root / "torch"),
                                  device="cpu")
    for runner in (jr, tr):
        runner.stage_generate()
        runner.stage_split()
    jr.stage_train(epochs=1)
    _, state, epoch = jr.load_state()
    tckpt.save_checkpoint(tr.path("checkpoints"), epoch,
                          {"params": flax_to_state_dict(state.params, tr.model)})
    return jr, tr, root


def _report(runner, stage):
    with open(os.path.join(runner.root, f"report_{stage}.json")) as fh:
        return json.load(fh)


def test_generate_and_split_equal_jax(pipelines):
    jr, tr, _ = pipelines
    for split in ("corpus", "train", "test"):
        want = jcodec.read_dataset(jr.path(split))
        got = tcodec.read_dataset(tr.path(split))
        assert got[0].shape[0] == want[0].shape[0] > 0
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert all(p.endswith(".npz") for p in tcodec.dataset_parts(tr.path(split)))
    for stage, keys in (("generate", ("rows",)), ("split", ("train_rows", "test_rows"))):
        assert {k: _report(tr, stage)[k] for k in keys} == {k: _report(jr, stage)[k] for k in keys}
        assert _report(tr, stage)["device"] == "cpu"


def test_structure_search_equals_jax(pipelines):
    jr, tr, root = pipelines
    # a variant has no checkpoints: the latent half reports "skipped" in both
    js = jrunner.ExperimentRunner(jr.config, data_dir=str(root / "jax"), variant="structure")
    ts = trunner.ExperimentRunner(tr.config, data_dir=str(root / "torch"), variant="structure",
                                  device="cpu")
    js.stage_search()
    ts.stage_search()
    want, got = _report(js, "search"), _report(ts, "search")
    for key in ("exact_optimum", "hill_climb"):
        assert got[key]["best_bic"] == pytest.approx(want[key]["best_bic"], rel=1e-9)
    assert got["exact_optimum"]["families"] == want["exact_optimum"]["families"]
    assert got["ground_truth_bic"] == pytest.approx(want["ground_truth_bic"], rel=1e-9)
    assert got["hill_climb"]["impl"] == want["hill_climb"]["impl"] == "dense"
    assert got["island_cem"] == want["island_cem"] == "skipped (no checkpoint)"


def test_eval_predictor_roundtrip_with_jax_weights(pipelines):
    jr, tr, _ = pipelines
    for runner in (jr, tr):
        runner.stage_eval(use_isomorphism=False)
        runner.stage_predictor()
        runner.stage_roundtrip()
    want, got = _report(jr, "eval"), _report(tr, "eval")
    assert {k: got[k] for k in MODE_KEYS} == {k: want[k] for k in MODE_KEYS}
    assert got["nll_per_graph"] == pytest.approx(want["nll_per_graph"], rel=1e-5)
    assert got["epoch"] == want["epoch"] == 1

    from dags_vae_search_tpu_torch.surrogate.dataset import read_predictor_dataset

    want_v, want_t = read_predictor_dataset(jr.path("predictor_dataset"))
    got_v, got_t = read_predictor_dataset(tr.path("predictor_dataset"))
    assert os.listdir(tr.path("predictor_dataset")) == ["part-00000.npz"]
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-9)

    want, got = _report(jr, "roundtrip"), _report(tr, "roundtrip")
    assert got["true_bic"] == pytest.approx(want["true_bic"], rel=1e-9)
    assert got["gp_predicted_bic"] == pytest.approx(want["gp_predicted_bic"], rel=1e-3)


def test_cli_runs_every_stage_on_the_cpu_and_mirrors_into_reports_torch(tmp_path, monkeypatch):
    monkeypatch.setitem(tregistry.REGISTRY, "asia", tiny(tregistry.REGISTRY["asia"]))
    trunner.main(["asia", *STAGES, "--data-dir", str(tmp_path / "runs"), "--device", "cpu",
                  "--hc-iters", "30"])
    assert tregistry.REGISTRY["asia"].search.hill_climb_iters == 50  # the registry is unchanged
    for root in (tmp_path / "runs" / "asia", tmp_path / "reports_torch" / "asia"):
        for stage in STAGES:
            payload = json.loads((root / f"report_{stage}.json").read_text())
            assert payload["stage"] == stage and payload["device"] == "cpu"
            assert "skipped (" not in json.dumps(payload), payload
    assert not (tmp_path / "reports").exists()
    search = json.loads((tmp_path / "runs" / "asia" / "report_search.json").read_text())
    assert {"exact_optimum", "hill_climb", "island_cem", "island_cem_polished", "latent_refined",
            "gp_ascent", "bo", "budget_comparison"} <= set(search)
    assert (tmp_path / "runs" / "asia" / "demo.png").is_file()
    assert (tmp_path / "runs" / "asia" / "checkpoints" / "checkpoint_1.pt").is_file()
