"""The port's results page against the JAX package's.

The same report dicts render line for line as in JAX below the header; the
header names the devices the reports record.  ``collect`` merges the runs
dir with its ``reports_torch/`` mirror, the newer ``time`` stamp winning,
and ``main`` writes ``RESULTS_torch.md``, never ``RESULTS.md``.
"""

import json
import os

import pytest

from dags_vae_search_tpu.experiments import results as jresults
from dags_vae_search_tpu_torch.experiments import results as tresults

HEADER_LINES = 3  # title, blank, "Generated by ..."


def _reports(device="NVIDIA H100 80GB HBM3, 700.00 W"):
    return {
        "asia": {
            "train": {"device": device, "epochs": 100,
                      "final": {"graphs_per_second": 1234.5, "loss_per_graph": 3.21}},
            "eval": {"device": device, "valid_ratio": 1.0, "structure_accuracy": 0.91,
                     "structure_accuracy_mode": 0.95, "perfect_accuracy": 0.88},
            "gp": {"device": device, "mape": 0.041},
            "roundtrip": {"device": device, "true_bic": -11107.3, "gp_predicted_bic": -11200.0,
                          "relative_error": 0.0083, "decode_equal": True},
            "search": {
                "device": device,
                "ground_truth_bic": -11110.0,
                "exact_optimum": {"best_bic": -11107.29, "families": 1024, "seconds": 0.2},
                "hill_climb": {"best_bic": -11107.29, "evals": 6000, "seconds": 0.5,
                               "converged": True, "evals_per_sec": 12000.0},
                "island_cem": {"best_bic": -11150.0, "best_bic_exact": -11150.1, "evals": 64,
                               "seconds": 1.0},
                "bo": {"best_bic": -11120.0, "evals": 64, "seconds": 3.0},
                "budget_comparison": {"budget_evals": 32, "bo": {"best_bic_exact": -11300.0,
                                                                 "seconds": 1.0},
                                      "winner": "bo"},
            },
        },
        "link": {"search": {"device": "cpu", "ground_truth_bic": -2000.0,
                            "hill_climb": {"best_bic": -2094.0, "converged": False, "evals": 7,
                                           "seconds": 2.0}}},
        "alarm@big": {"train": {"epochs": 30, "final": {"loss_per_graph": 12.5,
                                                        "kld_per_graph": 300.0,
                                                        "graphs_per_second": 9000.0}}},
    }


def test_render_equals_jax_below_the_header():
    got = tresults.render(_reports()).splitlines()
    want = jresults.render(_reports()).splitlines()
    assert got[HEADER_LINES:] == want[HEADER_LINES:]
    assert got[0] == ("# RESULTS — measured pipeline numbers "
                      "(NVIDIA H100 80GB HBM3, 700.00 W; cpu)")
    assert "TPU" not in "\n".join(got)
    assert "dags_vae_search_tpu_torch.experiments.results" in got[2]
    no_device = json.loads(json.dumps(_reports()).replace('"device"', '"host"'))
    assert tresults.render(no_device).splitlines()[0].endswith("(device not recorded)")


def _write(root, experiment, stage, payload):
    os.makedirs(os.path.join(root, experiment), exist_ok=True)
    with open(os.path.join(root, experiment, f"report_{stage}.json"), "w") as fh:
        json.dump(payload, fh)


def test_collect_merges_the_mirror_and_the_newer_stamp_wins(tmp_path):
    runs, mirror = str(tmp_path / "runs"), str(tmp_path / "reports_torch")
    _write(runs, "asia", "gp", {"time": 2.0, "mape": 0.2})
    _write(mirror, "asia", "gp", {"time": 1.0, "mape": 0.1})
    _write(runs, "asia", "eval", {"time": 1.0, "valid_ratio": 0.5})
    _write(mirror, "asia", "eval", {"time": 3.0, "valid_ratio": 0.9})
    _write(mirror, "sachs", "train", {"time": 1.0, "epochs": 4})
    _write(str(tmp_path / "reports"), "asia", "gp", {"time": 9.0, "mape": 0.7})
    (tmp_path / "runs" / "asia" / "report_broken.json").write_text("{")
    got = tresults.collect(runs)
    assert got == {"asia": {"gp": {"time": 2.0, "mape": 0.2},
                            "eval": {"time": 3.0, "valid_ratio": 0.9}},
                   "sachs": {"train": {"time": 1.0, "epochs": 4}}}


def test_main_writes_results_torch_md_and_never_results_md(tmp_path, monkeypatch, capsys):
    _write(str(tmp_path / "runs"), "asia", "gp", {"time": 1.0, "mape": 0.25, "device": "cpu"})
    monkeypatch.chdir(tmp_path)
    tresults.main([])
    text = (tmp_path / "RESULTS_torch.md").read_text()
    assert text.startswith("# RESULTS — measured pipeline numbers (cpu)")
    assert "0.2500" in text and "0.2500" in capsys.readouterr().out
    with pytest.raises(ValueError, match="RESULTS.md"):
        tresults.main(["runs", str(tmp_path / "RESULTS.md")])
    assert not (tmp_path / "RESULTS.md").exists()
